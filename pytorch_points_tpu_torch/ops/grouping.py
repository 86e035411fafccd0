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
  * _bq_group_centered: the fused SA front half, a ball query that emits
    the centred grouped coordinates in its scan; backward as the
    reference's ``custom_vjp``.
  * group_around: the SA front half's group step around given centroids
    (ball query or kNN, group, centre, concatenate), shared by
    sample_and_group, sample_and_group_sorted and the multi-scale SA layer.
  * sample_and_group_sorted: the Morton-consistent SA front half (FPS on
    the sorted cloud, centroids in Morton order, the ball query on the
    original order).

Indices carry no gradient: the searches run on detached clouds. kNN
distances are differentiable in both clouds with the neighbour set held
constant, as the reference's ``custom_vjp`` has it. A kNN over an xyz
support of ``topk_scan.RING_MIN_NS`` points or more takes the Morton-ring
scan (K9, or K10 for a masked support), a smaller one, or any cloud of
C != 3 channels, the streaming scan (K8): ``knn_path`` names the route.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_points_tpu_torch.core.masking import poison_points
from pytorch_points_tpu_torch.kernels import (
    ballquery,
    dispatch,
    nn_sorted,
    topk_scan,
)
from pytorch_points_tpu_torch.kernels.gather import gather_rows
from pytorch_points_tpu_torch.ops.sampling import (
    furthest_point_sample_and_gather,
    gather_points,
)
from pytorch_points_tpu_torch.ops.scatter_impl import scatter_add_auto
from pytorch_points_tpu_torch.utils.profiling import op_scope


class _Knn(torch.autograd.Function):
    """Forward: exact kNN (K8, K9 or K10) on the detached clouds. Backward,
    with the neighbour set constant: the direct term into the queries and a
    scatter-add (K4) into the support."""

    @staticmethod
    def forward(ctx, query, support, k, masked, impl):
        query, support = query.detach(), support.detach()
        dist, idx = topk_scan.knn(query, support, k, impl=impl,
                                  masked=masked)
        ctx.save_for_backward(query, support, idx)
        ctx.impl = impl
        ctx.mark_non_differentiable(idx)
        return dist, idx

    @staticmethod
    def backward(ctx, gd, _):
        query, support, idx = ctx.saved_tensors
        b, nq, k = idx.shape
        flat = idx.reshape(b, nq * k)
        gq = gs = None
        with op_scope("knn.backward"):
            sel = gather_rows(support, flat, impl=ctx.impl)
            diff = query[:, :, None, :] - sel.reshape(b, nq, k, -1)
            if ctx.needs_input_grad[0]:
                gq = (2.0 * gd[..., None] * diff).sum(dim=2)
            if ctx.needs_input_grad[1]:
                gs = scatter_add_auto(
                    flat,
                    (-2.0 * gd[..., None] * diff).reshape(b, nq * k, -1),
                    support.shape[1], ctx.impl,
                )
        return gq, gs, None, None, None


def knn(query: torch.Tensor, support: torch.Tensor, k: int,
        support_mask: torch.Tensor | None = None, impl: str = "auto"):
    """k nearest neighbours of each query point among the support points.

    [B,Nq,C], [B,Ns,C] -> (dist [B,Nq,k] squared ascending, idx [B,Nq,k]
    int32), any C and any 1 <= k <= Ns, the distance summed over all C
    channels. Invalid support points (``support_mask`` False) are poisoned
    far away and never returned while the cloud has >= k valid points.
    Differentiable in ``dist`` wrt both clouds, the neighbour set held
    constant.
    """
    with op_scope("knn"):
        support = poison_points(support, support_mask, sign=-1.0)
        return _Knn.apply(query, support, k, support_mask is not None, impl)


def knn_path(query: torch.Tensor, support: torch.Tensor, k: int,
             support_mask: torch.Tensor | None = None,
             impl: str = "auto") -> str:
    """Telemetry: which scan serves a ``knn`` call with these arguments,
    named as the reference names its Pallas routes: "ring" (Morton-sorted,
    AABB chunk skip: K9, the reference's ``_knn_ring_kernel``),
    "ring_masked" (valid-AABB sort, poison last, a table of ring centres:
    K10, its ``_knn_ring_kernel_pf``) or "stream" (the in-order scan, K8,
    its ``_knn_kernel``; also every C != 3 cloud, which the reference's
    Pallas scan would read on three channels). ``impl`` takes the port's
    values and the reference's "pallas" and "xla". The port takes these
    routes for every ``impl``, kernels and plain versions alike, so every
    one answers the route the port takes, and it never answers the
    reference's "xla"."""
    impls = dispatch.IMPLS + dispatch.REFERENCE_IMPLS
    if impl not in impls:
        raise ValueError(f"impl must be one of {impls}, got {impl!r}")
    if topk_scan.takes_ring(support):
        return "ring" if support_mask is None else "ring_masked"
    return "stream"


def duplicate_shadow_mask(points: torch.Tensor,
                          valid_mask: torch.Tensor | None = None):
    """[B,N,C] -> [B,N] bool: True for a point that exactly duplicates a
    lower-index point; the lowest-index copy of each group is not flagged.
    Invalid rows are first moved to 1e8 + i (float32, as the reference
    does). A stable lexicographic sort on the coordinates (x first), then
    each point is compared with the first of its run of equal points."""
    b, n, c = points.shape
    pts = points
    if valid_mask is not None:
        poison = 1e8 + torch.arange(n, dtype=torch.float32,
                                    device=points.device)[None, :, None]
        pts = torch.where(valid_mask[..., None], pts, poison)
    order = torch.arange(n, device=points.device).expand(b, n)
    for d in reversed(range(c)):  # least significant key first
        key = pts[..., d].gather(1, order)
        order = order.gather(1, torch.sort(key, dim=1, stable=True).indices)
    ps = pts.gather(1, order[..., None].expand(b, n, c))
    new_run = torch.ones((b, n), dtype=torch.bool, device=points.device)
    new_run[:, 1:] = (ps[:, 1:] != ps[:, :-1]).any(dim=-1)
    pos = torch.arange(n, device=points.device).expand(b, n)
    run_start = torch.cummax(torch.where(new_run, pos, 0), dim=1).values
    shadow = order != order.gather(1, run_start)
    return torch.zeros((b, n), dtype=torch.bool,
                       device=points.device).scatter(1, order, shadow)


def group_knn(k: int, query: torch.Tensor, support: torch.Tensor,
              support_features: torch.Tensor | None = None,
              support_mask: torch.Tensor | None = None, unique: bool = True,
              impl: str = "auto"):
    """kNN, then group the support's coordinates (or ``support_features``)
    at the neighbours: (grouped [B,Nq,k,C], idx [B,Nq,k], dist [B,Nq,k]).

    ``unique=True`` (the reference's default) masks exact duplicate support
    points down to their lowest-index copy first, so the k neighbours are
    distinct coordinates; it needs k distinct valid points per cloud.
    """
    if unique:
        shadow = duplicate_shadow_mask(support, support_mask)
        support_mask = (~shadow if support_mask is None
                        else support_mask & ~shadow)
    dist, idx = knn(query, support, k, support_mask=support_mask, impl=impl)
    grouped = group_points(
        support if support_features is None else support_features, idx,
        impl)
    return grouped, idx, dist


def ball_query(xyz: torch.Tensor, centroids: torch.Tensor, radius: float,
               nsample: int, mask: torch.Tensor | None = None,
               impl: str = "auto"):
    """Fixed-radius neighbourhood query (PointNet++ semantics, strict
    ``d^2 < radius^2``).

    [B,N,3] support, [B,P,3] centres -> (idx [B,P,nsample] int32, cnt [B,P]
    int32 hit counts capped at nsample). ``mask``: [B,N] support validity.
    Runs on the detached clouds: the indices carry no gradient.
    """
    with op_scope("ball_query"):
        return ballquery.ball_query(xyz.detach(), centroids.detach(), radius,
                                    nsample, mask, impl=impl)


def group_points(features: torch.Tensor, idx: torch.Tensor,
                 impl: str = "auto"):
    """[B,N,C] features, [B,P,S] indices -> [B,P,S,C]; backward is a
    deterministic scatter-add into the N axis."""
    b, p, s = idx.shape
    with op_scope("group"):
        g = gather_points(features, idx.reshape(b, p * s), impl)
        return g.reshape(b, p, s, features.shape[-1])


class _BqGroupCentered(torch.autograd.Function):
    """Forward: the ball query that emits centred coordinates
    (``ballquery.ball_query_and_group_coords``) on the detached clouds.
    Backward, the reference's ``_bqg_bwd``: the grouped coordinates'
    cotangent scattered (K4) into xyz at every slot's index, fill slots
    included, and minus its sum over the slots into the centroids."""

    @staticmethod
    def forward(ctx, xyz, centroids, radius, nsample, impl):
        idx, cnt, g = ballquery.ball_query_and_group_coords(
            xyz, centroids, radius, nsample, impl=impl)
        ctx.save_for_backward(idx)
        ctx.n, ctx.impl = xyz.shape[1], impl
        ctx.mark_non_differentiable(idx, cnt)
        return idx, cnt, g

    @staticmethod
    def backward(ctx, _, __, gg):
        (idx,) = ctx.saved_tensors
        b = idx.shape[0]
        grad_xyz = grad_cen = None
        with op_scope("ball_query.backward"):
            if ctx.needs_input_grad[0]:
                grad_xyz = scatter_add_auto(idx.reshape(b, -1),
                                            gg.reshape(b, -1, 3), ctx.n,
                                            ctx.impl)
            if ctx.needs_input_grad[1]:
                grad_cen = -gg.sum(dim=2)
        return grad_xyz, grad_cen, None, None, None


def _bq_group_centered(xyz: torch.Tensor, centroids: torch.Tensor,
                       radius: float, nsample: int, impl: str = "auto"):
    """Fused SA front half with gradients: (idx [B,P,ns] int32, cnt [B,P]
    int32, g [B,P,ns,3] = xyz[idx] - centroid), differentiable in g with
    respect to both clouds (the neighbourhoods held constant)."""
    with op_scope("ball_query"):
        return _BqGroupCentered.apply(xyz, centroids, radius, nsample, impl)


def _per_radius(centered: torch.Tensor, radius: float) -> torch.Tensor:
    """``centered / radius`` as the jitted reference computes it: XLA folds
    the division by the constant radius into a product with its float32
    reciprocal."""
    return centered * float(np.float32(1.0) / np.float32(radius))


def group_around(xyz: torch.Tensor, features: torch.Tensor | None,
                 new_xyz: torch.Tensor, nsample: int,
                 radius: float | None = None, *, use_xyz: bool = True,
                 normalize_radius: bool = False,
                 mask: torch.Tensor | None = None, impl: str = "auto"):
    """The SA front half's group step around given centroids: (ball query
    | kNN) -> group -> centre (+ optional normalise) -> concatenate the
    grouped features after the centred coordinates. The one grouping that
    single-scale (:func:`sample_and_group`) and multi-scale SA layers
    share: a multi-scale layer calls it once a radius around one FPS.

    Returns (new_features [B,P,nsample,C'], idx [B,P,nsample],
    grouped_xyz [B,P,nsample,3]).
    """
    if radius is not None:
        idx, _ = ball_query(xyz, new_xyz, radius, nsample, mask=mask,
                            impl=impl)
    else:
        _, idx = knn(new_xyz, xyz, nsample, support_mask=mask, impl=impl)
    grouped_xyz = group_points(xyz, idx, impl)
    centered = grouped_xyz - new_xyz[:, :, None, :]
    if normalize_radius and radius is not None:
        centered = _per_radius(centered, radius)
    if features is None:
        new_features = centered
    else:
        new_features = group_points(features, idx, impl)
        if use_xyz:
            new_features = torch.cat([centered, new_features], dim=-1)
    return new_features, idx, grouped_xyz


def sample_and_group(xyz: torch.Tensor, features: torch.Tensor | None,
                     npoint: int, nsample: int, radius: float | None = None,
                     *, use_xyz: bool = True, normalize_radius: bool = False,
                     mask: torch.Tensor | None = None, impl: str = "auto"):
    """FPS, then :func:`group_around` the sampled centroids.

    Returns (new_xyz [B,npoint,3], new_features [B,npoint,nsample,C'],
    idx [B,npoint,nsample], grouped_xyz [B,npoint,nsample,3]).
    """
    new_xyz, _ = furthest_point_sample_and_gather(xyz, npoint, mask=mask,
                                                  impl=impl)
    new_features, idx, grouped_xyz = group_around(
        xyz, features, new_xyz, nsample, radius, use_xyz=use_xyz,
        normalize_radius=normalize_radius, mask=mask, impl=impl)
    return new_xyz, new_features, idx, grouped_xyz


def sample_and_group_sorted(xyz: torch.Tensor,
                            features: torch.Tensor | None, npoint: int,
                            nsample: int, radius: float, *,
                            use_xyz: bool = True,
                            normalize_radius: bool = False,
                            impl: str = "auto"):
    """Morton-consistent SA front half for order-free consumers (an SA
    layer's MLP and max-pool).

    The cloud is Morton-sorted once for FPS (K1, seeded with the sorted
    position of point 0, so the selected set is ``sample_and_group``'s,
    exact ties aside), and the centroids come out in Morton order. The
    ball query (K2) scans the cloud in its ORIGINAL order: a scan of the
    sorted cloud fills each query only when it reaches its region, so no
    query's scan ends early. Coordinates and features are grouped (K3)
    from the original-order arrays, so no feature permute runs.

    The neighbourhood sets are ``sample_and_group``'s, with three
    differences: the centroids arrive in Morton order; the hits within a
    group follow the original-index scan; and a ball holding more than
    ``nsample`` points keeps the first ``nsample`` in original order for
    this centroid order (an equivalent ball sampling). Masked clouds take
    ``sample_and_group``.

    Returns (new_xyz [B,P,3] in Morton order, new_features
    [B,P,nsample,C'], idx [B,P,nsample] int32 into the SORTED cloud,
    grouped_xyz [B,P,nsample,3], perm [B,N] int32 with sorted =
    xyz[perm]), each bitwise the reference's.
    """
    xyz = xyz.to(torch.float32)
    xs, perm = nn_sorted.sort_by_morton(xyz)
    # inv[perm[r]] = r: the sorted position of each original point; the
    # sorted position of point 0 seeds FPS
    inv = torch.argsort(perm, dim=1)
    cen, _ = furthest_point_sample_and_gather(
        xs, npoint, impl=impl, seed_idx=inv[:, 0].to(torch.int32))
    cs, _ = nn_sorted.sort_by_morton(cen)
    new_features, idx_orig, grouped_xyz = group_around(
        xyz, features, cs, nsample, radius, use_xyz=use_xyz,
        normalize_radius=normalize_radius, impl=impl)
    b = xyz.shape[0]
    idx = inv.gather(1, idx_orig.reshape(b, -1).long()).reshape(
        idx_orig.shape).to(torch.int32)
    return cs, new_features, idx, grouped_xyz, perm


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
