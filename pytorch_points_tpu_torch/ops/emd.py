"""Auction-based Earth Mover's Distance (counterpart of the JAX
``ops/emd.py``).

Reference semantics: an approximately optimal 1-to-1 assignment between
two equal-size clouds, by the auction of ``kernels/auction.py`` (K11) and
its JV endgame (K12); the loss is the squared distance along the matched
pairs, and the backward flows along the matched pairs only (the assignment
held constant), its q side through the deterministic scatter (K4), exact
for a permutation.

The JAX package's XLA fallback (``_auction_xla``, a flat-eps Jacobi loop
with greedy completion) is not ported: the port holds the Pallas
semantics on every device.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.core.masking import BIG_COORD
from pytorch_points_tpu_torch.kernels import auction
from pytorch_points_tpu_torch.ops.scatter_impl import scatter_add_auto
from pytorch_points_tpu_torch.utils.profiling import op_scope


def _matched(p, q, assign):
    """(squared distance along the matched pairs [B,N], p - q[assign])."""
    qsel = q.gather(1, assign.long()[..., None].expand(-1, -1, 3))
    diff = p - qsel
    dx, dy, dz = diff.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz, diff


class _EMD(torch.autograd.Function):
    """Forward: the auction assignment on the detached clouds, then the
    matched squared distances. Backward: gp = 2 g (p - q[assign]),
    gq = scatter_add(assign, -gp)."""

    @staticmethod
    def forward(ctx, p, q, eps, max_iters, phases, pop_cap, impl,
                counts_equal):
        p, q = p.detach(), q.detach()
        assign = auction.auction_assignment(p, q, eps, max_iters,
                                            phases=phases, pop_cap=pop_cap,
                                            counts_equal=counts_equal,
                                            impl=impl)
        dist, diff = _matched(p, q, assign)
        ctx.save_for_backward(assign, diff)
        ctx.impl = impl
        ctx.mark_non_differentiable(assign)
        return dist, assign

    @staticmethod
    def backward(ctx, g, _):
        assign, diff = ctx.saved_tensors
        gq = None
        with op_scope("emd.backward"):
            gp = 2.0 * g[..., None] * diff
            if ctx.needs_input_grad[1]:  # a train step's target needs none
                gq = scatter_add_auto(assign, -gp, diff.shape[1], ctx.impl)
        return gp, gq, None, None, None, None, None, None


def _poison_rank_matched(x, mask, first=None):
    """Replace invalid points with twin pads shared BY RANK between the two
    clouds: the r-th invalid slot of p and the r-th invalid slot of q get
    identical far-away coordinates (x = BIG_COORD*16 + 32r), so the auction
    matches pad r to pad r at distance 0 and the valid assignment is
    undisturbed. Disjoint from the auction's own alignment pads. ``first``
    ([B] int, for a shard of a cloud): the invalid slots before it."""
    if mask is None:
        return x
    r = torch.cumsum((~mask).to(torch.int32), 1) - 1
    if first is not None:
        r = r + first[:, None].to(torch.int32)
    poison = torch.zeros_like(x)
    poison[..., 0] = BIG_COORD * 16.0 + 32.0 * r.to(x.dtype)
    return torch.where(mask[..., None], x, poison)


def earth_mover_distance(p: torch.Tensor, q: torch.Tensor,
                         eps: float = 0.005, max_iters: int = 15,
                         phases: int = 3, impl: str = "auto",
                         endgame_pop_cap: int = 768,
                         p_mask: torch.Tensor | None = None,
                         q_mask: torch.Tensor | None = None):
    """Auction-approximated EMD between paired equal-size clouds.

    Args:
      p: [B, N, 3] predicted cloud; q: [B, N, 3] target cloud (same N).
      eps: the final bid increment; the result is within N*eps of the
        optimal cost whenever the endgame's pop cap does not bind.
      max_iters: per-phase auction sweep budget; persons left unassigned
        are finished by the JV endgame (K12), never greedily.
      phases: eps-scaling phases (phase k bids with eps*6^(phases-1-k)).
      endgame_pop_cap: Dijkstra pops per straggler in the endgame; lower is
        faster and less optimal.
      p_mask, q_mask: [B, N] bool (True = real point). The two clouds must
        have EQUAL VALID COUNTS per cloud (EMD is a 1-to-1 matching);
        invalid slots are rank-matched to each other at distance 0, so they
        add nothing to cost or gradient; masked outputs are (0, 0).
        Unequal counts get the reference's answer (the greedy backstop
        gives each person left on a pad a free real object), at the cost
        of one host sync; two distinct masks always pay that sync.

    Returns:
      (dist [B, N] squared distances along the matched pairs,
       assignment [B, N] int32 permutation: p[i] <-> q[assignment[i]]).
    """
    if p.shape != q.shape or p.ndim != 3:
        raise ValueError(f"EMD needs equal-shape [B,N,3] clouds, got "
                         f"{tuple(p.shape)} vs {tuple(q.shape)}")
    with op_scope("emd"):
        p = p.to(torch.float32)
        q = q.to(torch.float32)
        args = (float(eps), int(max_iters), int(phases),
                int(endgame_pop_cap), impl)
        if p_mask is None and q_mask is None:
            return _EMD.apply(p, q, *args, True)
        # Only one mask for both clouds promises equal valid counts without
        # a look at the data; otherwise the auction runs its greedy backstop.
        dist, assign = _EMD.apply(_poison_rank_matched(p, p_mask),
                                  _poison_rank_matched(q, q_mask), *args,
                                  p_mask is q_mask)
        if p_mask is not None:
            dist = torch.where(p_mask, dist, 0.0)
            assign = torch.where(p_mask, assign, 0)
        return dist, assign
