"""Point-cloud I/O and host-side preprocessing (counterpart of the JAX
``utils/pc_utils.py``, a numpy copy).

PLY read/write is self-contained (ascii + binary little-endian, no
`plyfile` dependency), with a C++ fast path for binary files
(``pytorch_points_tpu_torch._native``). All functions here are host-side
numpy: they feed the device pipeline, they don't run on it.
"""

from __future__ import annotations

import numpy as np

from pytorch_points_tpu_torch import _native

_PLY_DTYPES = {
    "float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8),
    "float64": ("f8", 8), "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4), "short": ("i2", 2),
    "int16": ("i2", 2), "ushort": ("u2", 2), "uint16": ("u2", 2),
    "char": ("i1", 1), "int8": ("i1", 1), "uchar": ("u1", 1),
    "uint8": ("u1", 1),
}


def read_ply(path, load_normals: bool = False, load_colors: bool = False):
    """Read a PLY point cloud (vertex element only).

    Returns xyz [N,3] float32; optionally (xyz, normals) / (xyz, colors) /
    (xyz, normals, colors) depending on the flags.
    """
    if not load_normals and not load_colors and _native.available():
        out = _native.read_ply_xyz(str(path))
        if out is not None:
            return out
    return _read_ply_py(path, load_normals, load_colors)


def _read_ply_py(path, load_normals, load_colors):
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        props = []  # (name, numpy dtype str)
        n_verts = 0
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n_verts = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list property in vertex element")
                props.append((tok[2], _PLY_DTYPES[tok[1]][0]))
            elif tok[0] == "end_header":
                break

        if fmt == "ascii":
            data = np.loadtxt(
                [f.readline() for _ in range(n_verts)], dtype=np.float64
            ).reshape(n_verts, len(props))
            rec = {name: data[:, i] for i, (name, _) in enumerate(props)}
        else:
            order = "<" if fmt == "binary_little_endian" else ">"
            dt = np.dtype([(name, order + d) for name, d in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_verts), dtype=dt,
                                count=n_verts)
            rec = {name: raw[name] for name, _ in props}

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    out = [xyz]
    if load_normals:
        if "nx" in rec:
            out.append(
                np.stack([rec["nx"], rec["ny"], rec["nz"]], -1).astype(
                    np.float32
                )
            )
        else:
            out.append(None)
    if load_colors:
        if "red" in rec:
            out.append(
                np.stack([rec["red"], rec["green"], rec["blue"]], -1).astype(
                    np.uint8
                )
            )
        else:
            out.append(None)
    return out[0] if len(out) == 1 else tuple(out)


def save_ply(points, path, normals=None, colors=None, binary: bool = True):
    """Write a point cloud to PLY (binary little-endian by default)."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    cols = [points]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
        cols.append(np.asarray(normals, np.float32))
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            float_part = np.concatenate(cols, -1)
            if colors is not None:
                dt = [("f", "<f4", float_part.shape[1]), ("c", "u1", 3)]
                rec = np.empty(n, dtype=dt)
                rec["f"] = float_part
                rec["c"] = colors
                f.write(rec.tobytes())
            else:
                f.write(float_part.astype("<f4").tobytes())
        else:
            for i in range(n):
                row = [f"{v:.6f}" for c in cols for v in c[i]]
                if colors is not None:
                    row += [str(int(v)) for v in colors[i]]
                f.write((" ".join(row) + "\n").encode("ascii"))


def save_ply_property(points, prop, path, cmap_name: str = "viridis",
                      normals=None, binary: bool = True):
    """Save a cloud with a scalar property color-mapped to vertex colors
    (reference save_ply_property; matplotlib optional)."""
    prop = np.asarray(prop, np.float64)
    lo, hi = float(prop.min()), float(prop.max())
    t = (prop - lo) / max(hi - lo, 1e-12)
    try:
        import matplotlib

        colors = matplotlib.colormaps[cmap_name](t)[:, :3]
    except Exception:
        # fallback: blue -> red ramp
        colors = np.stack([t, np.zeros_like(t), 1.0 - t], -1)
    save_ply(points, path, normals=normals, colors=colors, binary=binary)


# ---------------------------------------------------------------------------
# NumPy preprocessing (host-side twins of the device ops)
# ---------------------------------------------------------------------------


def normalize_point_cloud(xyz):
    """Center + unit-sphere scale; returns (normalized, centroid, radius)."""
    xyz = np.asarray(xyz, np.float32)
    centroid = xyz.mean(-2, keepdims=True)
    centered = xyz - centroid
    radius = np.maximum(
        np.linalg.norm(centered, axis=-1).max(-1, keepdims=True), 1e-12
    )[..., None]
    return centered / radius, centroid, radius


def downsample_points(xyz, k, seed: int = 0):
    """Random downsample without replacement (host-side)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(xyz.shape[0], size=k, replace=xyz.shape[0] < k)
    return xyz[idx]


def furthest_point_sample_np(xyz, k):
    """Host-side FPS (same semantics as the device op; for data prep).

    Uses the C++ fast path when built.
    """
    if _native.available():
        out = _native.fps(np.ascontiguousarray(xyz, np.float32), int(k))
        if out is not None:
            return out
    n = xyz.shape[0]
    xyz = np.asarray(xyz, np.float32)
    mind = np.full(n, 1e10, np.float32)
    out = np.zeros(k, np.int32)
    last = 0
    for j in range(1, k):
        d = np.sum((xyz - xyz[last]) ** 2, -1, dtype=np.float32)
        mind = np.minimum(mind, d)
        last = int(np.argmax(mind))
        out[j] = last
    return out


def jitter_perturbation_point_cloud(xyz, sigma: float = 0.01,
                                    clip: float = 0.05, seed=None):
    """Gaussian jitter augmentation (reference pc_utils)."""
    rng = np.random.default_rng(seed)
    noise = np.clip(sigma * rng.standard_normal(xyz.shape), -clip, clip)
    return (xyz + noise).astype(np.float32)


def rotate_point_cloud(xyz, normals=None, seed=None, axis: str = "y"):
    """Random rotation about an axis (reference augmentation)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(a), np.sin(a)
    if axis == "y":
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    elif axis == "x":
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    else:
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    out = xyz @ rot.T
    if normals is not None:
        return out.astype(np.float32), (normals @ rot.T).astype(np.float32)
    return out.astype(np.float32)
