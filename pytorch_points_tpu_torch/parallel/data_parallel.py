"""Training step, one device (counterpart of the JAX
``parallel/data_parallel.py``).

The JAX package's step is an SPMD program over a device mesh with
``pmean``-ed gradients; here it is the single-device step. The
``torch.distributed`` form comes with the rest of ``parallel/``.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
from torch import nn

from pytorch_points_tpu_torch.layers.blocks import remat_call
from pytorch_points_tpu_torch.ops import chamfer_distance, earth_mover_distance


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable[[nn.Module, dict], torch.Tensor], *,
                    remat: bool = False):
    """``step(batch) -> loss``: forward ``loss_fn(model, batch)``, backward,
    one optimizer update; returns the loss (detached, on its device).

    For the reference's ``optax.adam(lr)`` pass ``torch.optim.Adam(
    model.parameters(), lr)``: its defaults are optax's (betas 0.9 and
    0.999, eps 1e-8 added outside the square root, bias-corrected moments).

    ``remat`` checkpoints the whole ``loss_fn`` (``torch.utils.checkpoint``,
    non-reentrant; the reference's ``nnx.remat`` of its local loss): the
    forward's activations are recomputed in the backward instead of kept.
    The recompute leaves BatchNorm's running statistics alone, so a step
    updates them once. Non-parameter state (BatchNorm's running statistics)
    lives in the model's buffers and is updated in place.
    """

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = remat_call(loss_fn, remat, model, batch, frozen=model)
        loss.backward()
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
            dist, _ = earth_mover_distance(pred, xyz, **kw)
            loss = loss + emd_weight * dist.mean()
        return loss

    return loss_fn
