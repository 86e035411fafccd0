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
from pytorch_points_tpu_torch.utils.profiling import op_scope


class _Gather(torch.autograd.Function):
    """Forward: row gather (K3). Backward: scatter-add into the rows (K4)."""

    @staticmethod
    def forward(ctx, features, idx, impl):
        ctx.save_for_backward(idx)
        ctx.n, ctx.impl = features.shape[1], impl
        return gather_rows(features.detach(), idx, impl=impl)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        with op_scope("gather.backward"):
            return scatter_add_auto(idx, g, ctx.n, ctx.impl), None, None


class _SampleAndGather(torch.autograd.Function):
    """FPS with the kernel-emitted coordinates (K1). The selection runs on
    the detached cloud; the coordinates' backward is the gather's
    scatter-add into ``xyz`` (K4)."""

    @staticmethod
    def forward(ctx, xyz, k, mask, seed_idx, impl):
        idx, coords = fps_kernel.furthest_point_sample(
            xyz.detach(), k, mask, seed_idx, emit_coords=True, impl=impl)
        ctx.save_for_backward(idx)
        ctx.n, ctx.impl = xyz.shape[1], impl
        ctx.mark_non_differentiable(idx)
        return coords, idx

    @staticmethod
    def backward(ctx, g, _):
        (idx,) = ctx.saved_tensors
        with op_scope("fps.backward"):
            return (scatter_add_auto(idx, g, ctx.n, ctx.impl), None, None,
                    None, None)


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
        with op_scope("scatter_add.backward"):
            return (g, None, gather_rows(g.contiguous(), idx, impl=ctx.impl),
                    None)


def furthest_point_sample(xyz: torch.Tensor, k: int,
                          mask: torch.Tensor | None = None,
                          impl: str = "auto",
                          seed_idx: torch.Tensor | None = None):
    """[B,N,3] -> [B,k] int32 FPS indices.

    ``mask`` ([B,N] bool): invalid points are never selected; with fewer than
    ``k`` valid points the sampler re-selects duplicates. ``seed_idx`` ([B]
    int32) forces the first selection per cloud.
    """
    with op_scope("fps"):
        return fps_kernel.furthest_point_sample(xyz.detach(), k, mask,
                                                seed_idx, impl=impl)


def furthest_point_sample_and_gather(xyz: torch.Tensor, k: int,
                                     mask: torch.Tensor | None = None,
                                     impl: str = "auto",
                                     seed_idx: torch.Tensor | None = None):
    """FPS and the sampled coordinates: (new_xyz [B,k,3], idx [B,k]).

    The kernel emits the coordinates as it selects them, so no separate
    gather runs; ``new_xyz`` is differentiable in ``xyz``."""
    with op_scope("fps"):
        return _SampleAndGather.apply(xyz, k, mask, seed_idx, impl)


def gather_points(features: torch.Tensor, idx: torch.Tensor,
                  impl: str = "auto"):
    """[B,N,C] features, [B,K] int32 indices -> [B,K,C]; differentiable in
    ``features`` (deterministic scatter-add backward)."""
    with op_scope("gather"):
        return _Gather.apply(features, idx.to(torch.int32), impl)


def scatter_add(target: torch.Tensor, idx: torch.Tensor,
                updates: torch.Tensor, impl: str = "auto"):
    """Deterministic scatter-add along the point axis: target [B,N,C] +=
    updates [B,K,C] at rows idx [B,K]; a new tensor, differentiable in
    ``target`` and ``updates``."""
    with op_scope("scatter_add"):
        return _ScatterAdd.apply(target, idx.to(torch.int32), updates, impl)


def random_sample(xyz: torch.Tensor, k: int, generator: torch.Generator,
                  mask: torch.Tensor | None = None, impl: str = "auto"):
    """Uniform random downsample without replacement: (sampled [B,k,C],
    idx [B,k] int32). ``generator`` lives on ``xyz``'s device.

    Without a mask each cloud's k indices are the first k of a uniform
    random permutation; with one, a Gumbel top-k over logits that are
    -inf on invalid points, as the reference draws (a cloud needs >= k
    valid points for its indices to be valid and distinct).
    """
    b, n, _ = xyz.shape
    u = torch.rand((b, n), generator=generator, device=xyz.device)
    if mask is None:
        idx = u.argsort(dim=1)[:, :k]
    else:
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        _, idx = torch.where(mask, gumbel, float("-inf")).topk(k, dim=1)
    idx = idx.to(torch.int32)
    return gather_points(xyz, idx, impl=impl), idx
