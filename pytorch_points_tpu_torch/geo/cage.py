"""Cage-based deformation by mean value coordinates (counterpart of the
JAX ``geo/cage.py``; Ju, Schaefer & Warren 2005, the Neural Cages
lineage).

The weights depend only on the source geometry: computed once, a
deformation is then one [P,Vc] x [Vc,3] product. They are computed over
every (point, face) pair at once, with masked branches instead of control
flow, and each face's corner weights are summed into the cage's vertices
by the deterministic scatter-add (K4), in ascending (face, corner) order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pytorch_points_tpu_torch.ops.normals import det3
from pytorch_points_tpu_torch.ops.sampling import scatter_add

_EPS = 1e-7


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def mean_value_coordinates(points, cage_verts, cage_faces,
                           impl: str = "auto") -> torch.Tensor:
    """MVC weights of points with respect to a closed triangular cage.

    points [..., P, 3] (inside or outside the cage; a point on the cage's
    surface takes its face's barycentric weights); cage_verts [Vc, 3];
    cage_faces [F, 3] int with a consistent outward winding. Returns
    [..., P, Vc] float32 weights, rows summing to 1, so ``weights @
    cage_verts`` reproduces the points.
    """
    points = torch.as_tensor(points, dtype=torch.float32)
    dev = points.device
    cage_verts = torch.as_tensor(cage_verts, dtype=torch.float32,
                                 device=dev)
    f = torch.as_tensor(np.asarray(cage_faces) if not torch.is_tensor(
        cage_faces) else cage_faces, device=dev).long()
    lead = points.shape[:-1]
    vc = cage_verts.shape[0]

    diff = cage_verts - points[..., None, :]  # [..., P, Vc, 3]
    d = torch.clamp_min(_norm(diff), _EPS)  # [..., P, Vc]
    u = diff / d[..., None]

    uf = u[..., f, :]  # [..., P, F, 3, 3]
    df = d[..., f]  # [..., P, F, 3]

    # the lengths between the unit vectors, opposite each corner
    lv = torch.stack([_norm(uf[..., 1, :] - uf[..., 2, :]),
                      _norm(uf[..., 2, :] - uf[..., 0, :]),
                      _norm(uf[..., 0, :] - uf[..., 1, :])], dim=-1)
    theta = 2.0 * torch.arcsin(torch.clamp(lv / 2.0, 0.0, 1.0))
    h = theta.sum(-1) / 2.0  # [..., P, F]

    on_face = (math.pi - h) < 1e-5  # the point lies on face t
    sin_t = torch.sin(theta)
    w_face = sin_t * torch.roll(df, 1, -1) * torch.roll(df, 2, -1)

    sin_h = torch.sin(h)[..., None]
    c = (2.0 * sin_h * torch.sin(h[..., None] - theta)) / torch.clamp_min(
        torch.roll(sin_t, 1, -1) * torch.roll(sin_t, 2, -1), _EPS) - 1.0
    s = torch.sign(det3(uf))[..., None] * torch.sqrt(
        torch.clamp_min(1.0 - c**2, 0.0))  # [..., P, F, 3]
    degenerate = (s.abs() <= _EPS).any(-1)  # coplanar, outside the face

    den = df * torch.roll(sin_t, 1, -1) * torch.roll(s, 2, -1)
    w = (theta - torch.roll(c, 1, -1) * torch.roll(theta, 2, -1)
         - torch.roll(c, 2, -1) * torch.roll(theta, 1, -1)) / torch.clamp_min(
        den.abs(), _EPS) * torch.sign(den)
    w = torch.where(degenerate[..., None], 0.0, w)  # [..., P, F, 3]

    # a point on some face: that face's barycentric weights alone
    any_on_face = on_face.any(-1, keepdim=True)[..., None]
    w = torch.where(any_on_face, torch.where(on_face[..., None], w_face, 0.0),
                    w)

    # each face's corner weights into the cage's vertices: the rows of K4
    # are the vertices, its columns every point of every cloud
    cols = w.reshape(-1, f.numel()).T[None]  # [1, F*3, prod(lead)]
    idx = f.reshape(1, -1).to(torch.int32)
    weights = scatter_add(cols.new_zeros((1, vc, cols.shape[-1])), idx,
                          cols.contiguous(), impl)[0].T.reshape(*lead, vc)
    total = weights.sum(-1, keepdim=True)
    return weights / torch.where(total.abs() < _EPS, 1.0, total)


def deform_with_cage(weights: torch.Tensor,
                     new_cage_verts: torch.Tensor) -> torch.Tensor:
    """[..., P, Vc] MVC weights x [..., Vc, 3] deformed cage (one cage, or
    one a cloud) -> [..., P, 3], in float32 (a product and a sum over Vc:
    no reduced-precision matmul, whatever the TF32 setting, as the
    reference's ``Precision.HIGHEST``)."""
    cage = torch.as_tensor(new_cage_verts, dtype=torch.float32,
                           device=weights.device)
    return (weights[..., :, :, None] * cage[..., None, :, :]).sum(-2)
