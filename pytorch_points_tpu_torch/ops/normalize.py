"""Cloud normalisation (counterpart of the JAX ``ops/normalize.py``)."""

from __future__ import annotations

import torch


def _masked_centroid(xyz: torch.Tensor, mask: torch.Tensor | None):
    if mask is None:
        return xyz.mean(dim=-2, keepdim=True)
    cnt = torch.clamp_min(mask.sum(-1), 1)[..., None, None]
    return torch.where(mask[..., None], xyz, 0.0).sum(-2, keepdim=True) / cnt


def normalize_point_batch(xyz: torch.Tensor,
                          mask: torch.Tensor | None = None):
    """Centre each cloud and scale it into the unit sphere.

    Returns (normalized [B,N,3], centroid [B,1,3], furthest_distance
    [B,1,1]) with ``normalized = (xyz - centroid) / furthest_distance``;
    with a [B,N] mask, the centroid and the distance are of the valid
    points, and invalid rows come out 0."""
    centroid = _masked_centroid(xyz, mask)
    centered = xyz - centroid
    r = torch.linalg.vector_norm(centered, dim=-1, keepdim=True)  # [B,N,1]
    if mask is not None:
        r = torch.where(mask[..., None], r, 0.0)
    furthest = torch.clamp_min(r.amax(dim=-2, keepdim=True), 1e-12)
    out = centered / furthest
    if mask is not None:
        out = torch.where(mask[..., None], out, 0.0)
    return out, centroid, furthest


def normalize_to_box(xyz: torch.Tensor, mask: torch.Tensor | None = None):
    """Centre on the bounding box's centre and scale its longest edge to 2
    (the cloud fits in [-1, 1]^3).

    Returns (normalized, center [B,1,3], scale [B,1,1]) with
    ``normalized = (xyz - center) / scale``; with a mask, the box of the
    valid points, and invalid rows come out 0."""
    if mask is not None:
        m = mask[..., None]
        mx = torch.where(m, xyz, -1e30).amax(dim=-2, keepdim=True)
        mn = torch.where(m, xyz, 1e30).amin(dim=-2, keepdim=True)
    else:
        mx = xyz.amax(dim=-2, keepdim=True)
        mn = xyz.amin(dim=-2, keepdim=True)
    center = (mx + mn) / 2.0
    scale = torch.clamp_min((mx - mn).amax(dim=-1, keepdim=True) / 2.0,
                            1e-12)
    out = (xyz - center) / scale
    if mask is not None:
        out = torch.where(mask[..., None], out, 0.0)
    return out, center, scale
