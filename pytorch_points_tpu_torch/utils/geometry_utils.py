"""Mesh I/O and template generation (counterpart of the JAX
``utils/geometry_utils.py``, a numpy copy).

Self-contained OBJ / OFF / PLY triangle-mesh readers and writers plus the
grid/sphere template generators the Neural-Cages lineage uses.
``mesh_edges`` is the JAX ``geo/mesh_ops.py`` function (numpy there too);
the port's ``geo.mesh_ops`` exports this one.
"""

from __future__ import annotations

import numpy as np


def mesh_edges(faces) -> np.ndarray:
    """Unique undirected edges [E, 2] from faces [F, 3] (host-side, static)."""
    faces = np.asarray(faces)
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0).astype(np.int32)


def read_mesh(path):
    """Read a triangle mesh (.obj / .off / .ply) -> (verts [V,3] f32,
    faces [F,3] i32). Quads are triangulated fan-style."""
    path = str(path)
    if path.endswith(".obj"):
        return _read_obj(path)
    if path.endswith(".off"):
        return _read_off(path)
    if path.endswith(".ply"):
        return _read_ply_mesh(path)
    raise ValueError(f"unsupported mesh format: {path}")


def write_mesh(path, verts, faces):
    path = str(path)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    if path.endswith(".obj"):
        with open(path, "w") as f:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for t in faces:
                f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
    elif path.endswith(".off"):
        with open(path, "w") as f:
            f.write(f"OFF\n{len(verts)} {len(faces)} 0\n")
            for v in verts:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for t in faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
    elif path.endswith(".ply"):
        with open(path, "wb") as f:
            hdr = (
                "ply\nformat ascii 1.0\n"
                f"element vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n"
            )
            f.write(hdr.encode())
            for v in verts:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n".encode())
            for t in faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())
    else:
        raise ValueError(f"unsupported mesh format: {path}")


def _triangulate(poly):
    return [(poly[0], poly[i], poly[i + 1]) for i in range(1, len(poly) - 1)]


def _read_obj(path):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                idx = [int(x.split("/")[0]) - 1 for x in t[1:]]
                faces.extend(_triangulate(idx))
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _read_off(path):
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    if tokens[0] == "OFF":
        i = 1
    elif tokens[0].startswith("OFF"):  # "OFF123 ..." glued header
        tokens[0] = tokens[0][3:]
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3
    verts = np.asarray(tokens[i : i + 3 * nv], np.float32).reshape(nv, 3)
    i += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[i])
        poly = [int(x) for x in tokens[i + 1 : i + 1 + k]]
        faces.extend(_triangulate(poly))
        i += 1 + k
    return verts, np.asarray(faces, np.int32)


_PLY_NP = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _read_ply_mesh(path):
    # PLY with vertex + face elements: ascii, binary_little_endian and
    # binary_big_endian all supported (the reference read meshes through
    # openmesh, which handles every PLY flavor — SURVEY.md §3.2 P6).
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        nv = nf = 0
        vprops = []  # (name, np dtype char)
        flist = None  # (count dtype, index dtype)
        element = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            t = line.decode("ascii", "replace").strip().split()
            if not t:
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                element = t[1]
                if element == "vertex":
                    nv = int(t[2])
                elif element == "face":
                    nf = int(t[2])
            elif t[0] == "property":
                if element == "vertex":
                    if t[1] == "list":
                        raise ValueError("list property in vertex element")
                    vprops.append((t[2], _PLY_NP[t[1]]))
                elif element == "face" and t[1] == "list":
                    flist = (_PLY_NP[t[2]], _PLY_NP[t[3]])
            elif t[0] == "end_header":
                break
        body = f.read()

    if fmt == "ascii":
        lines = body.decode("ascii", "replace").splitlines()
        vdata = np.loadtxt(lines[:nv], dtype=np.float32).reshape(
            nv, len(vprops)
        )
        names = [n for n, _ in vprops]
        verts = vdata[:, [names.index("x"), names.index("y"), names.index("z")]]
        faces = []
        for line in lines[nv : nv + nf]:
            t = [int(x) for x in line.split()]
            faces.extend(_triangulate(t[1 : 1 + t[0]]))
        return verts.astype(np.float32), np.asarray(faces, np.int32)

    order = "<" if fmt == "binary_little_endian" else ">"
    vdt = np.dtype([(n, order + d) for n, d in vprops])
    vraw = np.frombuffer(body, dtype=vdt, count=nv)
    verts = np.stack(
        [vraw["x"], vraw["y"], vraw["z"]], -1
    ).astype(np.float32)
    if flist is None or nf == 0:
        return verts, np.zeros((0, 3), np.int32)
    cdt = np.dtype(order + flist[0])
    idt = np.dtype(order + flist[1])
    fbytes = body[vdt.itemsize * nv :]
    # Fast path: uniform arity (peek the first count; verify total size).
    n0 = int(np.frombuffer(fbytes, dtype=cdt, count=1)[0])
    stride = cdt.itemsize + n0 * idt.itemsize
    if len(fbytes) >= nf * stride:
        rec = np.frombuffer(fbytes, count=nf, dtype=np.dtype(
            [("n", cdt), ("v", idt, (n0,))]
        ))
        if (rec["n"] == n0).all():
            polys = rec["v"].astype(np.int64)
            if n0 == 3:
                return verts, polys.astype(np.int32)
            faces = []
            for poly in polys:
                faces.extend(_triangulate(poly.tolist()))
            return verts, np.asarray(faces, np.int32)
    # Mixed arity: walk face by face.
    faces = []
    off = 0
    for _ in range(nf):
        k = int(np.frombuffer(fbytes, dtype=cdt, count=1, offset=off)[0])
        off += cdt.itemsize
        poly = np.frombuffer(fbytes, dtype=idt, count=k, offset=off)
        off += k * idt.itemsize
        faces.extend(_triangulate(poly.tolist()))
    return verts, np.asarray(faces, np.int32)


# ---------------------------------------------------------------------------
# Template meshes (Neural-Cages style sources)
# ---------------------------------------------------------------------------


def generate_grid_mesh(nx: int = 10, ny: int = 10, extent: float = 1.0):
    """Planar triangulated grid in the xy-plane, centered at origin."""
    xs = np.linspace(-extent, extent, nx, dtype=np.float32)
    ys = np.linspace(-extent, extent, ny, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = a + 1
            c = a + ny
            d = c + 1
            faces += [(a, c, b), (b, c, d)]
    return verts, np.asarray(faces, np.int32)


def generate_icosphere(subdivisions: int = 2, radius: float = 1.0):
    """Icosphere by midpoint subdivision of an icosahedron."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
         (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
         (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
        np.float64,
    )
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = list(verts / np.linalg.norm(verts, axis=1, keepdims=True))
    for _ in range(subdivisions):
        cache: dict[tuple[int, int], int] = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                m = m / np.linalg.norm(m)
                verts.append(m)
                cache[key] = len(verts) - 1
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    return (
        (np.asarray(verts) * radius).astype(np.float32),
        np.asarray(faces, np.int32),
    )


def get_edge_points(verts, faces):
    """Per-edge endpoint coordinate pairs [E, 2, 3] for edge-based losses."""
    edges = mesh_edges(faces)
    verts = np.asarray(verts)
    return verts[edges]  # [E, 2, 3]
