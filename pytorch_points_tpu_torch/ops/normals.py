"""PCA normal estimation (counterpart of the JAX ``ops/normals.py``).

kNN neighbourhoods (K8, or the ring scan K9/K10 at large N) -> grouped
neighbours (K3) -> per-point 3x3 covariance -> the eigenvector of its
smallest eigenvalue, in closed form (the trigonometric method), as the
reference computes it: no iterative eigensolver.
"""

from __future__ import annotations

import math

import torch

from pytorch_points_tpu_torch.ops.grouping import group_points, knn


def det3(a: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [...]: the determinant by the rule of Sarrus, in the
    reference's (``jnp.linalg.det``'s 3x3) order of terms."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3] x [..., 3] -> [..., 3], componentwise as ``jnp.cross``."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def smallest_eigenvector_sym3x3(cov: torch.Tensor,
                                eps: float = 1e-12) -> torch.Tensor:
    """[..., 3, 3] symmetric -> [..., 3] unit eigenvector of the smallest
    eigenvalue (sign unspecified).

    The eigenvalues by the trigonometric (Smith's) method, then the
    eigenvector as the largest cross product of two rows of (A - eig3 I);
    an isotropic matrix (p^2 < eps) gives z."""
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    q = cov.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    a_q = cov - q[..., None, None] * eye
    p2 = (a_q * a_q).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, eps))
    r = torch.clamp(det3(a_q / p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    eig3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    m = cov - eig3[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    best = torch.stack([cross(r0, r1), cross(r0, r2), cross(r1, r2)], -2)
    which = (best * best).sum(-1).argmax(dim=-1)  # the first of equals
    v = best.gather(-2, which[..., None, None].expand(*which.shape, 1, 3))
    v = v[..., 0, :]
    v = v / torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), eps))
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    return torch.where((p2 < eps)[..., None], z, v)


def batch_normals(xyz: torch.Tensor, k: int = 20,
                  mask: torch.Tensor | None = None, *,
                  orient_outward: bool = False,
                  impl: str = "auto") -> torch.Tensor:
    """[B,N,3] -> [B,N,3] unit normals by local PCA over each point's k
    nearest neighbours (itself included).

    ``mask`` [B,N]: invalid points are never neighbours, and their normals
    are 0. ``orient_outward`` flips each normal to point away from the
    cloud's (valid) centroid."""
    _, idx = knn(xyz, xyz, k, support_mask=mask, impl=impl)
    nbrs = group_points(xyz, idx, impl)  # [B,N,k,3]
    centered = nbrs - nbrs.mean(dim=2, keepdim=True)
    cov = torch.einsum("bnki,bnkj->bnij", centered, centered) / k
    normals = smallest_eigenvector_sym3x3(cov)
    if orient_outward:
        if mask is None:
            centroid = xyz.mean(dim=1, keepdim=True)
        else:
            centroid = (torch.where(mask[..., None], xyz, 0.0).sum(
                1, keepdim=True)
                / torch.clamp_min(mask.sum(1), 1)[:, None, None])
        sign = torch.sign((normals * (xyz - centroid)).sum(-1, keepdim=True))
        normals = normals * torch.where(sign == 0, 1.0, sign)
    if mask is not None:
        normals = torch.where(mask[..., None], normals, 0.0)
    return normals
