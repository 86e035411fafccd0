"""Training loop (counterpart of the JAX ``utils/trainer.py``): the step
(``parallel.make_train_step``, one device or data-parallel over a mesh),
tolerant checkpointing (save/load_network), a NaN guard (check_values) and
the coloured logger.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable

import torch.distributed as dist

from pytorch_points_tpu_torch.misc.logger import get_logger
from pytorch_points_tpu_torch.parallel import make_train_step
from pytorch_points_tpu_torch.utils.train_utils import (
    check_values,
    load_network,
    save_network,
)

log = get_logger(__name__)


class Trainer:
    """Minimal loop: step, periodic logging, checkpointing, NaN guard.

    Args:
      model: nn.Module.
      optimizer: a torch optimizer over ``model``'s parameters (the
        reference's ``optax.adam(lr)`` is ``torch.optim.Adam(params, lr)``).
      loss_fn: (model, batch) -> scalar tensor.
      ckpt_dir: checkpoint directory (None = no checkpoints).
      log_every / ckpt_every: step intervals.
      nan_guard: at every log point, raise on a non-finite loss (after
        naming the non-finite parameters).
      remat: recompute the forward in the backward instead of keeping its
        activations (``make_train_step(remat=True)``: the whole loss
        checkpointed), as the reference's rematerialised step does.
      mesh: a ``DeviceMesh`` with a 'data' axis (``parallel.make_mesh``):
        every rank runs this loop on its shard of each batch, and the step
        averages over the axis. Only rank 0 logs and writes checkpoints;
        the other ranks wait for each checkpoint at a barrier. None (the
        default) drives one device; the reference's default, every device,
        needs a process group the caller starts.
    """

    def __init__(self, model, optimizer, loss_fn, *, mesh=None,
                 ckpt_dir=None, log_every: int = 50, ckpt_every: int = 1000,
                 nan_guard: bool = True, remat: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.step_fn = make_train_step(model, optimizer, loss_fn, mesh=mesh,
                                       remat=remat)
        self.ckpt_dir = ckpt_dir
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.nan_guard = nan_guard
        self.step = 0

    def _lead(self) -> bool:
        """Whether this process logs and writes checkpoints."""
        return self.mesh is None or dist.get_rank() == 0

    def _save(self):
        if self._lead():
            save_network(self.model, self.ckpt_dir, step=self.step)
        if self.mesh is not None:
            dist.barrier()

    def restore(self, step: int | None = None):
        """Tolerant-restore the model's parameters from ``ckpt_dir``."""
        state, _ = load_network(self.model, self.ckpt_dir, step=step)
        self.model.load_state_dict(state)
        if self._lead():
            log.info("restored checkpoint (step arg: %s)", step)

    def fit(self, batches: Iterable, steps: int | None = None,
            on_log: Callable | None = None, prefetch: int | None = 2):
        """Run the loop over ``batches`` (dicts of tensors on the model's
        device: the iterable makes them, so with a prefetch their copy to
        the device runs in its thread).

        Any iterable that is not already a ``data.Prefetcher`` is wrapped
        in one (depth ``prefetch``); ``prefetch=None`` iterates directly.
        The loss stays on the device between log points, so the host
        queues steps ahead of the device. Returns the last loss (float);
        with a mesh, the loss averaged over the ranks, on every rank."""
        from pytorch_points_tpu_torch.data import Prefetcher

        if prefetch is not None and not isinstance(batches, Prefetcher):
            batches = Prefetcher(batches, depth=prefetch)
        loss = None
        for batch in batches:
            loss = self.step_fn(batch)
            self.step += 1
            if self.step % self.log_every == 0:
                lval = loss.item()
                if self._lead():
                    log.info("step %d  loss %.6f", self.step, lval)
                if self.nan_guard and not math.isfinite(lval):
                    check_values(self.model, "params")
                    raise FloatingPointError(
                        f"non-finite loss at step {self.step}")
                if on_log is not None:
                    on_log(self.step, lval)
            if self.ckpt_dir and self.step % self.ckpt_every == 0:
                self._save()
            if steps is not None and self.step >= steps:
                break
        if self.ckpt_dir:
            self._save()
        return loss.item() if loss is not None else None
