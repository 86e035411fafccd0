"""nndistance / Chamfer distance (counterpart of the JAX ``ops/chamfer.py``).

Reference semantics: for clouds ``p [B,N,3]`` and ``q [B,M,3]``, per-point
*squared* nearest-neighbour distances in both directions plus the argmin
indices (ties to the lowest index); the backward scatters gradients through
the saved argmin pairs only, the argmin held constant (kernel K4 for the
scatters).

Dispatch, as in the reference: at ``N, M >= _SORTED_MIN_POINTS`` unmasked
clouds take the Morton-pruned scan (kernel K6, ``kernels/nn_sorted.py``):
the loss-only form for a mean/sum ``chamfer_distance`` and the indexed form
otherwise. Smaller clouds take the dense scan (kernel K5). Masked clouds
take K5 on the poisoned clouds at every size until the masked band kernel
(K7) is ported; on valid rows its outputs are those of the reference's
masked sorted path.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.core.masking import BIG_DISTANCE, poison_points
from pytorch_points_tpu_torch.kernels import distance_tiles, nn_sorted
from pytorch_points_tpu_torch.kernels.gather import gather_rows
from pytorch_points_tpu_torch.ops.scatter_impl import scatter_add_auto

_SORTED_MIN_POINTS = 8192  # per-cloud size from which the sorted path runs


class _NNDistance(torch.autograd.Function):
    """Forward: bidirectional NN on the detached clouds, dense (K5) or
    Morton-pruned (K6). Backward: the reference's rule, two row gathers and
    two scatter-adds."""

    @staticmethod
    def forward(ctx, p, q, use_sorted, impl):
        p, q = p.detach(), q.detach()
        nn = nn_sorted.nndistance_indexed if use_sorted else (
            distance_tiles.nn_both_directions)
        d1, i1, d2, i2 = nn(p, q, impl=impl)
        ctx.save_for_backward(p, q, i1, i2)
        ctx.impl = impl
        ctx.mark_non_differentiable(i1, i2)
        return d1, i1, d2, i2

    @staticmethod
    def backward(ctx, g1, _, g2, __):
        p, q, i1, i2 = ctx.saved_tensors
        impl = ctx.impl
        # Direction 1: dist1[i] = |p[i] - q[idx1[i]]|^2
        diff1 = p - gather_rows(q, i1, impl)
        gp = 2.0 * g1[..., None] * diff1
        gq = scatter_add_auto(i1, -gp, q.shape[1], impl)
        # Direction 2: dist2[j] = |q[j] - p[idx2[j]]|^2
        diff2 = q - gather_rows(p, i2, impl)
        gq = gq + 2.0 * g2[..., None] * diff2
        gp_scatter = scatter_add_auto(i2, -2.0 * g2[..., None] * diff2,
                                      p.shape[1], impl)
        return gp + gp_scatter, gq, None, None


class _ChamferSumsSorted(torch.autograd.Function):
    """Per-cloud summed bidirectional NN distances (s1 [B], s2 [B]) from the
    loss-only sorted scan. Backward: each direction's direct and cross term
    in ONE scatter-add per cloud, at the sort targets and the kernel's
    original-space indices."""

    @staticmethod
    def forward(ctx, p, q, impl):
        s1, s2, *res = nn_sorted.nndistance_sums(p.detach(), q.detach(),
                                                 impl=impl)
        ctx.save_for_backward(p.detach(), q.detach(), *res)
        ctx.impl = impl
        return s1, s2

    @staticmethod
    def backward(ctx, g1, g2):
        p, q, i1o, i2o, rows_p, rows_q, tgt_p, tgt_q = ctx.saved_tensors
        impl = ctx.impl
        diff1 = rows_p - gather_rows(q, i1o, impl)  # [B,N,3]
        diff2 = rows_q - gather_rows(p, i2o, impl)  # [B,M,3]
        u1 = 2.0 * g1[:, None, None] * diff1
        u2 = 2.0 * g2[:, None, None] * diff2
        n, m = p.shape[1], q.shape[1]
        gp = scatter_add_auto(torch.cat([tgt_p, i2o], 1),
                              torch.cat([u1, -u2], 1), n, impl)
        gq = scatter_add_auto(torch.cat([tgt_q, i1o], 1),
                              torch.cat([u2, -u1], 1), m, impl)
        return gp, gq, None


def _sorted_size_ok(p: torch.Tensor, q: torch.Tensor) -> bool:
    return (p.shape[1] >= _SORTED_MIN_POINTS
            and q.shape[1] >= _SORTED_MIN_POINTS)


def nndistance(p: torch.Tensor, q: torch.Tensor,
               p_mask: torch.Tensor | None = None,
               q_mask: torch.Tensor | None = None, impl: str = "auto"):
    """Bidirectional nearest-neighbour squared distances.

    ``p`` [B,N,3], ``q`` [B,M,3]; ``p_mask``/``q_mask`` optional [B,N]/[B,M]
    bool validity (True = real point). Invalid points never win an argmin;
    their output distances and indices are 0.

    Returns (dist1 [B,N], idx1 [B,N] int32, dist2 [B,M], idx2 [B,M] int32),
    differentiable in the distances wrt both clouds.
    """
    if p.ndim != 3 or q.ndim != 3:
        raise ValueError(f"expected [B,N,C] clouds, got {tuple(p.shape)} and "
                         f"{tuple(q.shape)}")
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    if p_mask is None and q_mask is None:
        return _NNDistance.apply(p, q, _sorted_size_ok(p, q), impl)
    pp = poison_points(p, p_mask, sign=1.0)
    qp = poison_points(q, q_mask, sign=-1.0)  # opposite side: mutually far
    dist1, idx1, dist2, idx2 = _NNDistance.apply(pp, qp, False, impl)
    if p_mask is not None:
        dist1 = torch.where(p_mask, dist1, 0.0)
        idx1 = torch.where(p_mask, idx1, 0)
    if q_mask is not None:
        dist2 = torch.where(q_mask, dist2, 0.0)
        idx2 = torch.where(q_mask, idx2, 0)
    # Keep the output finite even where a valid point saw only poison.
    return (torch.clamp_max(dist1, BIG_DISTANCE), idx1,
            torch.clamp_max(dist2, BIG_DISTANCE), idx2)


def chamfer_path(p: torch.Tensor, q: torch.Tensor,
                 p_mask: torch.Tensor | None = None,
                 q_mask: torch.Tensor | None = None,
                 reduction: str = "none") -> str:
    """Telemetry: which scan serves a chamfer/nndistance call with these
    arguments: "sorted_loss" (Morton-pruned, loss-only: the mean/sum
    ``chamfer_distance`` path), "sorted" (Morton-pruned, indexed) or
    "dense" (K5; every masked call until K7 is ported)."""
    if p_mask is not None or q_mask is not None or not _sorted_size_ok(p, q):
        return "dense"
    return "sorted_loss" if reduction in ("mean", "sum") else "sorted"


def chamfer_distance(p: torch.Tensor, q: torch.Tensor,
                     p_mask: torch.Tensor | None = None,
                     q_mask: torch.Tensor | None = None, *,
                     reduction: str = "mean", one_sided: bool = False,
                     impl: str = "auto"):
    """Chamfer distance between two clouds (squared-distance form).

    ``mean`` averages each direction over the number of *valid* points, then
    sums the two directions and averages over the batch, matching the
    reference ChamferLoss; ``sum`` sums each direction; ``none`` returns the
    per-point distances (dist1, dist2), or dist1 alone when ``one_sided``.
    """
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if chamfer_path(p, q, p_mask, q_mask, reduction) == "sorted_loss":
        s1, s2 = _ChamferSumsSorted.apply(p.to(torch.float32),
                                          q.to(torch.float32), impl)
        if reduction == "mean":
            l1, l2 = s1 / p.shape[1], s2 / q.shape[1]
        else:
            l1, l2 = s1, s2
        return l1.mean() if one_sided else (l1 + l2).mean()
    dist1, _, dist2, _ = nndistance(p, q, p_mask, q_mask, impl=impl)

    def _reduce(d, mask):
        if reduction == "none":
            return d
        if mask is None:
            return d.mean(dim=-1) if reduction == "mean" else d.sum(dim=-1)
        s = torch.where(mask, d, 0.0).sum(dim=-1)
        if reduction == "sum":
            return s
        return s / mask.sum(dim=-1).clamp_min(1)

    loss1 = _reduce(dist1, p_mask)
    if one_sided:
        return loss1.mean() if reduction != "none" else loss1
    loss2 = _reduce(dist2, q_mask)
    if reduction == "none":
        return loss1, loss2
    return (loss1 + loss2).mean()
