"""Differentiable mesh operators (counterpart of the JAX
``geo/mesh_ops.py``): face and vertex normals, areas, edge lengths, the
uniform and cotangent Laplacians, mean curvature, dihedral angles, and the
kNN-graph Laplacian of a point cloud.

Vertex rows are gathered by the row gather (K3) and accumulated per vertex
by the deterministic scatter-add (K4), both differentiable
(``ops.gather_points`` / ``ops.scatter_add``): the reference's gather +
``segment_sum``, summed in the same ascending update order on every
device, with no atomics.

Conventions: verts [B,V,3] (or [V,3]); faces [F,3] and edges [E,2] int
(numpy or a tensor), shared across the batch; edges undirected, as
:func:`mesh_edges` gives them.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from pytorch_points_tpu_torch.ops.grouping import group_points, knn
from pytorch_points_tpu_torch.ops.normals import cross
from pytorch_points_tpu_torch.ops.sampling import gather_points, scatter_add
from pytorch_points_tpu_torch.utils.geometry_utils import mesh_edges

__all__ = ["cot_laplacian", "dihedral_angles", "edge_lengths", "face_areas",
           "face_normals", "mean_curvature", "mesh_edges", "point_laplacian",
           "uniform_laplacian", "vertex_normals"]


def _batched(verts: torch.Tensor):
    if verts.dim() == 2:
        return verts[None], True
    return verts, False


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx) if not torch.is_tensor(idx)
                           else idx, device=device).to(torch.int32)


def _rows(v: torch.Tensor, idx: torch.Tensor, impl: str) -> torch.Tensor:
    """v [B,V,C], idx [...] int32 shared by the batch -> [B,...,C] (K3)."""
    b = v.shape[0]
    flat = idx.reshape(1, -1).expand(b, -1)
    return gather_points(v, flat, impl).reshape(b, *idx.shape, v.shape[-1])


def _segment_sum(u: torch.Tensor, idx: torch.Tensor, n: int,
                 impl: str) -> torch.Tensor:
    """u [B,M,C] summed into n rows at idx [M] -> [B,n,C] (K4)."""
    b = u.shape[0]
    zeros = u.new_zeros((b, n, u.shape[-1]))
    return scatter_add(zeros, idx.reshape(1, -1).expand(b, -1), u, impl)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def _face_cross(v: torch.Tensor, faces: torch.Tensor,
                impl: str) -> torch.Tensor:
    tri = _rows(v, faces, impl)  # [B,F,3,3]
    return cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])


def face_normals(verts, faces, *, normalize: bool = True,
                 impl: str = "auto") -> torch.Tensor:
    """[B,F,3] face normals (right-hand winding), unit unless
    ``normalize=False`` (then twice the area)."""
    v, squeeze = _batched(verts)
    n = _face_cross(v, _index(faces, v.device), impl)
    if normalize:
        n = n / torch.clamp_min(_norm(n, True), 1e-12)
    return n[0] if squeeze else n


def face_areas(verts, faces, *, impl: str = "auto") -> torch.Tensor:
    """[B,F] triangle areas."""
    v, squeeze = _batched(verts)
    a = 0.5 * _norm(_face_cross(v, _index(faces, v.device), impl))
    return a[0] if squeeze else a


def vertex_normals(verts, faces, *, impl: str = "auto") -> torch.Tensor:
    """[B,V,3] area-weighted vertex normals: each face's unnormalised
    normal (twice its area) summed into its three corners, normalised."""
    v, squeeze = _batched(verts)
    f = _index(faces, v.device)
    fn = _face_cross(v, f, impl)  # [B,F,3]
    acc = _segment_sum(fn.repeat_interleave(3, dim=1), f.reshape(-1),
                       v.shape[1], impl)
    out = acc / torch.clamp_min(_norm(acc, True), 1e-12)
    return out[0] if squeeze else out


def edge_lengths(verts, edges, *, impl: str = "auto") -> torch.Tensor:
    """[B,E] edge lengths."""
    v, squeeze = _batched(verts)
    ends = _rows(v, _index(edges, v.device), impl)  # [B,E,2,3]
    out = _norm(ends[:, :, 0] - ends[:, :, 1])
    return out[0] if squeeze else out


def uniform_laplacian(verts, edges, *, normalize: bool = True,
                      impl: str = "auto") -> torch.Tensor:
    """Uniform (graph) Laplacian coordinates [B,V,3]: mean_j(v_j) - v_i
    over each vertex's edge neighbours, or sum_j (v_j - v_i) with
    ``normalize=False``."""
    v, squeeze = _batched(verts)
    e = _index(edges, v.device)
    nv = v.shape[1]
    src = torch.cat([e[:, 0], e[:, 1]])
    dst = torch.cat([e[:, 1], e[:, 0]])
    s = _segment_sum(_rows(v, dst, impl), src, nv, impl)
    ones = v.new_ones((v.shape[0], src.shape[0], 1))
    deg = _segment_sum(ones, src, nv, impl)  # [B,V,1]
    if normalize:
        out = s / torch.clamp_min(deg, 1.0) - v
    else:
        out = s - deg * v
    return out[0] if squeeze else out


def cot_laplacian(verts, faces, *, eps: float = 1e-10,
                  normalize: str = "weight",
                  impl: str = "auto") -> torch.Tensor:
    """Cotangent-weighted Laplacian coordinates [B,V,3], with w_ij =
    cot(a) + cot(b) over the angles opposite edge (i, j):

    * "weight": sum_j w_ij (v_j - v_i) / sum_j w_ij;
    * "area": (1 / (2 A_i)) sum_j (w_ij / 2) (v_j - v_i), A_i the
      barycentric vertex area (the discrete Laplace-Beltrami);
    * "none": sum_j w_ij (v_j - v_i).
    """
    v, squeeze = _batched(verts)
    f = _index(faces, v.device)
    b, nv = v.shape[:2]
    tri = _rows(v, f, impl)  # [B,F,3,3]
    acc = v.new_zeros((b, nv, 3))
    wacc = v.new_zeros((b, nv, 1))
    for opp in range(3):
        i, j = (opp + 1) % 3, (opp + 2) % 3
        a = tri[:, :, i] - tri[:, :, opp]
        c = tri[:, :, j] - tri[:, :, opp]
        cot = ((a * c).sum(-1) / torch.clamp_min(_norm(cross(a, c)), eps)
               )[..., None]  # [B,F,1]
        # edge (i, j) takes the weight of the angle at opp, both ways
        vi, vj = f[:, i], f[:, j]
        acc = acc + _segment_sum(cot * tri[:, :, j], vi, nv, impl)
        acc = acc + _segment_sum(cot * tri[:, :, i], vj, nv, impl)
        wacc = wacc + _segment_sum(cot, vi, nv, impl)
        wacc = wacc + _segment_sum(cot, vj, nv, impl)
    if normalize == "weight":
        out = acc / torch.clamp_min(wacc, eps) - v
    else:
        raw = acc - wacc * v  # sum_j w_ij (v_j - v_i)
        if normalize == "none":
            out = raw
        else:  # barycentric vertex areas
            fa = 0.5 * _norm(cross(tri[:, :, 1] - tri[:, :, 0],
                                   tri[:, :, 2] - tri[:, :, 0]))  # [B,F]
            corner = (fa / 3.0).repeat_interleave(3, dim=1)[..., None]
            va = _segment_sum(corner, f.reshape(-1), nv, impl)
            out = raw / (2.0 * torch.clamp_min(va, eps))
    return out[0] if squeeze else out


def mean_curvature(verts, faces, *, impl: str = "auto") -> torch.Tensor:
    """[B,V] mean curvature |Laplace-Beltrami(v)| / 2 (a sphere of radius
    R gives 1/R)."""
    return 0.5 * _norm(cot_laplacian(verts, faces, normalize="area",
                                     impl=impl))


def dihedral_angles(verts, faces, *, impl: str = "auto"):
    """Cosines of the dihedral angles between the face pairs that share an
    edge: (cos [B,Ei], edge_pairs [Ei,2] numpy face-index pairs), interior
    edges only. The pairing is host-side numpy, as the reference's."""
    faces_np = np.asarray(faces.cpu() if torch.is_tensor(faces) else faces)
    edge2faces = defaultdict(list)
    for fi, (a, b, c) in enumerate(faces_np):
        for u, w in ((a, b), (b, c), (c, a)):
            edge2faces[(min(u, w), max(u, w))].append(fi)
    pairs = np.array([fs[:2] for fs in edge2faces.values() if len(fs) == 2],
                     dtype=np.int32).reshape(-1, 2)
    v, squeeze = _batched(verts)
    n = face_normals(v, faces_np, impl=impl)  # [B,F,3]
    ends = _rows(n, _index(pairs, v.device), impl)  # [B,Ei,2,3]
    cos = (ends[:, :, 0] * ends[:, :, 1]).sum(-1)
    return (cos[0] if squeeze else cos), pairs


def point_laplacian(xyz: torch.Tensor, k: int = 8,
                    mask: torch.Tensor | None = None,
                    idx: torch.Tensor | None = None, impl: str = "auto"):
    """Graph-Laplacian coordinates of a cloud over its kNN graph (K8, or
    the ring scan at large N; self excluded): (lap [B,N,3] = mean of the k
    neighbours - the point, idx [B,N,k]), so a second cloud can be taken
    under the same neighbourhoods (``idx``)."""
    if idx is None:
        _, idx = knn(xyz, xyz, k + 1, support_mask=mask, impl=impl)
        idx = idx[..., 1:]  # drop self
    lap = group_points(xyz, idx, impl).mean(dim=2) - xyz
    if mask is not None:
        lap = torch.where(mask[..., None], lap, 0.0)
    return lap, idx
