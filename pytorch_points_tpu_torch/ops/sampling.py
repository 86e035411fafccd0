"""Furthest point sampling + gather (counterpart of the JAX ``ops/sampling.py``).

Reference semantics: iteratively select ``k`` points maximising the minimum
distance to the already-selected set, seeded with the first valid index,
ties to the lowest index; float32 throughout so selections are
index-identical to the reference. The selection carries no gradient; the
gathered rows do, through a scatter-add (kernel K4) into the source, as the
reference's ``custom_vjp`` rules have it.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.kernels import fps as fps_kernel
from pytorch_points_tpu_torch.kernels.gather import gather_rows
from pytorch_points_tpu_torch.ops.scatter_impl import scatter_add_auto


class _Gather(torch.autograd.Function):
    """Forward: row gather (K3). Backward: scatter-add into the rows (K4)."""

    @staticmethod
    def forward(ctx, features, idx, impl):
        ctx.save_for_backward(idx)
        ctx.n, ctx.impl = features.shape[1], impl
        return gather_rows(features.detach(), idx, impl)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_add_auto(idx, g, ctx.n, ctx.impl), None, None


class _SampleAndGather(torch.autograd.Function):
    """FPS with the kernel-emitted coordinates (K1). The selection runs on
    the detached cloud; the coordinates' backward is the gather's
    scatter-add into ``xyz`` (K4)."""

    @staticmethod
    def forward(ctx, xyz, k, mask, seed_idx, impl):
        idx, coords = fps_kernel.furthest_point_sample(xyz.detach(), k, mask,
                                                       seed_idx, impl)
        ctx.save_for_backward(idx)
        ctx.n, ctx.impl = xyz.shape[1], impl
        ctx.mark_non_differentiable(idx)
        return coords, idx

    @staticmethod
    def backward(ctx, g, _):
        (idx,) = ctx.saved_tensors
        return (scatter_add_auto(idx, g, ctx.n, ctx.impl), None, None, None,
                None)


class _ScatterAdd(torch.autograd.Function):
    """target + scatter(idx, updates); backward: g to the target, the rows
    of g at idx to the updates."""

    @staticmethod
    def forward(ctx, target, idx, updates, impl):
        ctx.save_for_backward(idx)
        ctx.impl = impl
        return target + scatter_add_auto(idx, updates.detach(),
                                         target.shape[1], impl)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g, None, gather_rows(g.contiguous(), idx, ctx.impl), None


def furthest_point_sample(xyz: torch.Tensor, k: int,
                          mask: torch.Tensor | None = None,
                          impl: str = "auto",
                          seed_idx: torch.Tensor | None = None):
    """[B,N,3] -> [B,k] int32 FPS indices.

    ``mask`` ([B,N] bool): invalid points are never selected; with fewer than
    ``k`` valid points the sampler re-selects duplicates. ``seed_idx`` ([B]
    int32) forces the first selection per cloud.
    """
    return fps_kernel.furthest_point_sample(xyz.detach(), k, mask, seed_idx,
                                            impl)[0]


def furthest_point_sample_and_gather(xyz: torch.Tensor, k: int,
                                     mask: torch.Tensor | None = None,
                                     impl: str = "auto",
                                     seed_idx: torch.Tensor | None = None):
    """FPS and the sampled coordinates: (new_xyz [B,k,3], idx [B,k]).

    The kernel emits the coordinates as it selects them, so no separate
    gather runs; ``new_xyz`` is differentiable in ``xyz``."""
    return _SampleAndGather.apply(xyz, k, mask, seed_idx, impl)


def gather_points(features: torch.Tensor, idx: torch.Tensor,
                  impl: str = "auto"):
    """[B,N,C] features, [B,K] int32 indices -> [B,K,C]; differentiable in
    ``features`` (deterministic scatter-add backward)."""
    return _Gather.apply(features, idx.to(torch.int32), impl)


def scatter_add(target: torch.Tensor, idx: torch.Tensor,
                updates: torch.Tensor, impl: str = "auto"):
    """Deterministic scatter-add along the point axis: target [B,N,C] +=
    updates [B,K,C] at rows idx [B,K]; a new tensor, differentiable in
    ``target`` and ``updates``."""
    return _ScatterAdd.apply(target, idx.to(torch.int32), updates, impl)
