"""Training step, one device or data-parallel over a mesh axis
(counterpart of the JAX ``parallel/data_parallel.py``).

The JAX package's step is an SPMD program over a device mesh with
``pmean``-ed gradients. Here, with a mesh, each rank is one process that
runs the step on its shard of the batch; the gradients, the loss and the
float buffers (BatchNorm's running statistics) are averaged over the
mesh's data axis by ``torch.distributed``, so every rank holds the same
parameters after every step. Without a mesh it is the one-device step.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.distributed as dist
from torch import nn

from pytorch_points_tpu_torch.layers.blocks import remat_call
from pytorch_points_tpu_torch.ops import chamfer_distance, earth_mover_distance
from pytorch_points_tpu_torch.parallel.collectives import axis_group
from pytorch_points_tpu_torch.utils.profiling import annotate


def _mean_over(tensors, group, w: int) -> None:
    """Average ``tensors`` over the group in place: one flat all-reduce of
    their sum (gloo has no average), then a division by ``w``."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= w
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable[[nn.Module, dict], torch.Tensor], *,
                    mesh=None, data_axis: str = "data", remat: bool = False):
    """``step(batch) -> loss``: forward ``loss_fn(model, batch)``, backward,
    one optimizer update; returns the loss (detached, on its device).

    For the reference's ``optax.adam(lr)`` pass ``torch.optim.Adam(
    model.parameters(), lr)``: its defaults are optax's (betas 0.9 and
    0.999, eps 1e-8 added outside the square root, bias-corrected moments).

    ``mesh`` (a ``DeviceMesh`` with a ``data_axis``, ``parallel.make_mesh``)
    makes the step data-parallel: ``batch``'s tensors are the rank's shard
    of the global batch; the parameters and buffers are broadcast from the
    axis's first rank when the step is built; every step averages the
    gradients over the axis before the update, and returns the loss
    averaged over it, and averages the float buffers after the forward, as
    the reference's step ``pmean``s its non-Param state. With ``mesh=None``
    it is the one-device step.

    ``remat`` checkpoints the whole ``loss_fn`` (``torch.utils.checkpoint``,
    non-reentrant; the reference's ``nnx.remat`` of its local loss): the
    forward's activations are recomputed in the backward instead of kept.
    The recompute leaves BatchNorm's running statistics alone, so a step
    updates them once. Non-parameter state (BatchNorm's running statistics)
    lives in the model's buffers and is updated in place.
    """
    group = w = None
    if mesh is not None:
        group = axis_group(mesh, data_axis)
        w = dist.get_world_size(group)
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                dist.broadcast(t, src, group=group)

    def step(batch):
        with annotate("train.step"):
            optimizer.zero_grad(set_to_none=True)
            with annotate("train.forward"):
                loss = remat_call(loss_fn, remat, model, batch, frozen=model)
            with annotate("train.backward"):
                loss.backward()
            if group is not None:
                with torch.no_grad():
                    _mean_over([p.grad for p in model.parameters()
                                if p.grad is not None], group, w)
                    _mean_over([b for b in model.buffers()
                                if b.is_floating_point()], group, w)
                    loss = loss.detach().clone()
                    _mean_over([loss], group, w)
            with annotate("train.optimizer"):
                optimizer.step()
            return loss.detach()

    return step


def reconstruction_loss(chamfer_weight: float = 1.0, emd_weight: float = 0.1,
                        emd_kwargs: dict | None = None, impl: str = "auto"):
    """Config-5 loss on the reconstructed cloud: ``loss_fn(model, batch)``
    with ``batch["points"]`` [B,N,3], chamfer_weight * Chamfer +
    emd_weight * mean EMD, as the reference defines it. ``emd_kwargs`` go
    to ``earth_mover_distance`` (the raw op's pop cap 768 unless they say
    otherwise; ``EMDLoss``'s training point is ``{"endgame_pop_cap":
    384}``); ``emd_weight=0`` trains on Chamfer alone."""
    kw = {"impl": impl, **(emd_kwargs or {})}

    def loss_fn(model, batch):
        xyz = batch["points"]
        pred = model(xyz, impl=impl)
        loss = chamfer_weight * chamfer_distance(pred, xyz, impl=impl)
        if emd_weight:
            dist_, _ = earth_mover_distance(pred, xyz, **kw)
            loss = loss + emd_weight * dist_.mean()
        return loss

    return loss_fn
