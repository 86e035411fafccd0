"""Neighbourhood search and feature grouping (counterpart of the JAX
``ops/grouping.py``).

Reference semantics:
  * kNN: indices of the k nearest support points per query (ascending
    distance, ties -> lowest index).
  * ball query: the first ``nsample`` support points (in index order)
    strictly within ``radius`` of each query; rows with fewer hits repeat
    the first hit; rows with zero hits are all zero.
  * group_points: gather features at a [B, P, S] index tensor; backward
    is a scatter-add (kernel K4).

Indices carry no gradient: the searches run on detached clouds. kNN
distances are differentiable in both clouds with the neighbour set held
constant, as the reference's ``custom_vjp`` has it.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.core.masking import poison_points
from pytorch_points_tpu_torch.kernels import ballquery, topk_scan
from pytorch_points_tpu_torch.kernels.gather import gather_rows
from pytorch_points_tpu_torch.ops.sampling import (
    furthest_point_sample_and_gather,
    gather_points,
)
from pytorch_points_tpu_torch.ops.scatter_impl import scatter_add_auto


class _Knn(torch.autograd.Function):
    """Forward: exact kNN (K8) on the detached clouds. Backward, with the
    neighbour set constant: the direct term into the queries and a
    scatter-add (K4) into the support."""

    @staticmethod
    def forward(ctx, query, support, k, impl):
        query, support = query.detach(), support.detach()
        dist, idx = topk_scan.knn(query, support, k, impl=impl)
        ctx.save_for_backward(query, support, idx)
        ctx.impl = impl
        ctx.mark_non_differentiable(idx)
        return dist, idx

    @staticmethod
    def backward(ctx, gd, _):
        query, support, idx = ctx.saved_tensors
        b, nq, k = idx.shape
        flat = idx.reshape(b, nq * k)
        sel = gather_rows(support, flat, ctx.impl)
        diff = query[:, :, None, :] - sel.reshape(b, nq, k, -1)
        gq = gs = None
        if ctx.needs_input_grad[0]:
            gq = (2.0 * gd[..., None] * diff).sum(dim=2)
        if ctx.needs_input_grad[1]:
            gs = scatter_add_auto(
                flat, (-2.0 * gd[..., None] * diff).reshape(b, nq * k, -1),
                support.shape[1], ctx.impl,
            )
        return gq, gs, None, None


def knn(query: torch.Tensor, support: torch.Tensor, k: int,
        support_mask: torch.Tensor | None = None, impl: str = "auto"):
    """k nearest neighbours of each query point among the support points.

    [B,Nq,3], [B,Ns,3] -> (dist [B,Nq,k] squared ascending, idx [B,Nq,k]
    int32). Invalid support points (``support_mask`` False) are poisoned
    far away and never returned while the cloud has >= k valid points.
    Differentiable in ``dist`` wrt both clouds, the neighbour set held
    constant.
    """
    support = poison_points(support, support_mask, sign=-1.0)
    return _Knn.apply(query, support, k, impl)


def ball_query(xyz: torch.Tensor, centroids: torch.Tensor, radius: float,
               nsample: int, mask: torch.Tensor | None = None,
               impl: str = "auto"):
    """Fixed-radius neighbourhood query (PointNet++ semantics, strict
    ``d^2 < radius^2``).

    [B,N,3] support, [B,P,3] centres -> (idx [B,P,nsample] int32, cnt [B,P]
    int32 hit counts capped at nsample). ``mask``: [B,N] support validity.
    Runs on the detached clouds: the indices carry no gradient.
    """
    return ballquery.ball_query(xyz.detach(), centroids.detach(), radius,
                                nsample, mask, impl=impl)


def group_points(features: torch.Tensor, idx: torch.Tensor,
                 impl: str = "auto"):
    """[B,N,C] features, [B,P,S] indices -> [B,P,S,C]; backward is a
    deterministic scatter-add into the N axis."""
    b, p, s = idx.shape
    g = gather_points(features, idx.reshape(b, p * s), impl)
    return g.reshape(b, p, s, features.shape[-1])


def sample_and_group(xyz: torch.Tensor, features: torch.Tensor | None,
                     npoint: int, nsample: int, radius: float | None = None,
                     *, use_xyz: bool = True, normalize_radius: bool = False,
                     mask: torch.Tensor | None = None, impl: str = "auto"):
    """FPS -> (ball query | kNN) -> group -> centre (+ optional normalise).

    Returns (new_xyz [B,npoint,3], new_features [B,npoint,nsample,C'],
    idx [B,npoint,nsample], grouped_xyz [B,npoint,nsample,3]).
    """
    new_xyz, _ = furthest_point_sample_and_gather(xyz, npoint, mask=mask,
                                                  impl=impl)
    if radius is not None:
        idx, _ = ball_query(xyz, new_xyz, radius, nsample, mask=mask,
                            impl=impl)
    else:
        _, idx = knn(new_xyz, xyz, nsample, support_mask=mask, impl=impl)
    grouped_xyz = group_points(xyz, idx, impl)
    centered = grouped_xyz - new_xyz[:, :, None, :]
    if normalize_radius and radius is not None:
        centered = centered / radius
    if features is None:
        new_features = centered
    else:
        new_features = group_points(features, idx, impl)
        if use_xyz:
            new_features = torch.cat([centered, new_features], dim=-1)
    return new_xyz, new_features, idx, grouped_xyz


def group_all(xyz: torch.Tensor, features: torch.Tensor | None, *,
              use_xyz: bool = True):
    """Degenerate SA grouping treating the whole cloud as one group."""
    grouped_xyz = xyz[:, None, :, :]  # [B, 1, N, 3]
    if features is None:
        new_features = grouped_xyz
    else:
        g = features[:, None, :, :]
        new_features = torch.cat([grouped_xyz, g], -1) if use_xyz else g
    new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
    return new_xyz, new_features, None, grouped_xyz
