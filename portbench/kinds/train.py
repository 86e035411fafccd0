"""Training traffic: the port's ``Trainer`` over a pool of seeded batches.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``points``,
``pool`` (distinct batches, cycled), ``lr`` (Adam), ``warmup`` (steps
after the three that are checked), ``target`` ("reconstruct": the input
is the target, loss ``chamfer`` * Chamfer + ``emd`` * mean EMD with
``emd_pop_cap``; "upsample": the input is ``points`` rows drawn from a
cloud of ``target_points``, loss Chamfer against that cloud), ``steps_traced``.

Set-up builds one model, one Adam and one ``Trainer`` and drives them
through their first three steps with ``Trainer.fit`` on the first three
batches; the loss of each, the first gradient (from Adam's first moment)
and the parameters' change after the third step are kept for the check.
The same trainer then warms up and runs the window.
"""

from __future__ import annotations

import itertools
import time

import torch

from portbench import gen, spec
from portbench.gen import Phases

BETA1 = 0.9


def draw_batch(tr: dict, device, seed: int, i: int) -> dict:
    """Batch ``i`` of the pool: {"points": [B,N,3]} (+ "target")."""
    b, n = tr["batch"], tr["points"]
    if tr["target"] == "upsample":
        full = gen.surface_clouds(b, tr["target_points"], device, seed, i)
        return {"points": gen.subset(full, n, device, seed, i),
                "target": full}
    return {"points": gen.surface_clouds(b, n, device, seed, i)}


def port_loss(tr: dict, fault: str | None):
    """The loss the window trains on, from the port's ops."""
    from pytorch_points_tpu_torch.ops import (
        chamfer_distance,
        earth_mover_distance,
    )

    def loss_fn(model, batch):
        x = batch["points"]
        tgt = batch.get("target", x)
        if fault == "half_batch":
            half = x.shape[0] // 2
            x, tgt = x[:half], tgt[:half]
        pred = model(x)
        loss = tr.get("chamfer", 1.0) * chamfer_distance(pred, tgt)
        if tr.get("emd", 0.0):
            d, _ = earth_mover_distance(pred, tgt,
                                        endgame_pop_cap=tr["emd_pop_cap"])
            loss = loss + tr["emd"] * d.mean()
        return loss

    return loss_fn


def reference_loss(ref, cfg: dict, tr: dict):
    from portbench.reference import emd, ops

    def loss_fn(params, batch, tf32):
        x = batch["points"]
        tgt = batch.get("target", x)
        pred = ref.forward(params, x, cfg, tf32)
        loss = tr.get("chamfer", 1.0) * ops.chamfer(pred, tgt)
        if tr.get("emd", 0.0):
            loss = loss + tr["emd"] * emd.emd(
                pred, tgt, pop_cap=tr["emd_pop_cap"]).mean()
        return loss

    return loss_fn


class Driver:
    """One training cell in one process."""

    def __init__(self, cell, seed: int, device, fault: str | None = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.fault = fault
        self.tr, self.cfg = cell.traffic, cell.config
        self.ref = spec.reference(self.cfg["reference"])

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from pytorch_points_tpu_torch import models
        from pytorch_points_tpu_torch.utils.trainer import Trainer

        tr, dev = self.tr, self.device
        clock = Phases(dev)
        self.w0 = gen.weights(self.ref.param_spec(self.cfg), dev, self.seed)
        clock("weights")
        model = getattr(models, self.cfg["model"])(**self.cfg["kwargs"],
                                                   device=dev)
        model.load_state_dict(self.w0, strict=True)
        self.model = model
        self.opt = torch.optim.Adam(model.parameters(), lr=tr["lr"])
        if self.fault == "state_unchanged":
            self.opt.step = lambda *a, **k: None
        self.trainer = Trainer(model, self.opt, port_loss(tr, self.fault))
        clock("model")
        self.pool = [draw_batch(tr, dev, self.seed, i)
                     for i in range(tr["pool"])]
        self.feed = itertools.cycle(self.pool)
        clock("pool")
        # the three checked steps, through the window's own call and feed
        losses = [self.trainer.fit(self.feed, steps=1, prefetch=None)]
        names = dict((p, n) for n, p in model.named_parameters())
        self.grad1 = {names[p]: float((s["exp_avg"] / (1 - BETA1)).norm())
                      for p, s in self.opt.state.items()}
        for k in (2, 3):
            losses.append(self.trainer.fit(self.feed, steps=k,
                                           prefetch=None))
        with torch.no_grad():
            self.change3 = {n: float((p - self.w0[n]).norm())
                            for n, p in model.named_parameters()}
        self.losses = losses
        clock("checked steps")
        self.trainer.fit(self.feed, steps=3 + tr["warmup"], prefetch=None)
        clock("warm-up")
        self.setup_phases = clock.seconds

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- the window -----------------------------------------------------
    def window(self, seconds: float) -> dict:
        def timed():
            deadline = time.perf_counter() + seconds
            for batch in self.feed:
                if time.perf_counter() >= deadline:
                    return
                yield batch

        self.sync()
        n0 = self.trainer.step
        t0 = time.perf_counter()
        self.trainer.fit(timed(), prefetch=None)  # ends on the loss's .item()
        t1 = time.perf_counter()
        steps = self.trainer.step - n0
        self.steps, self.window_s = steps, t1 - t0
        return {"train_clouds_per_s": steps * self.tr["batch"] / (t1 - t0)}

    def step_once(self):
        """One step through the trainer's step function, no sync."""
        self.trainer.step_fn(next(self.feed))
        self.trainer.step += 1

    def attempted(self) -> tuple[int, int]:
        return self.steps, 0

    def free(self):
        del self.model, self.opt, self.trainer, self.pool, self.feed

    # -- the check ------------------------------------------------------
    def follow(self, tf32: bool, steps: int = 3) -> dict:
        """The reference's readings over the first ``steps`` batches, from
        the weights drawn again: each step's loss, each leaf's first
        gradient norm, and each leaf's change after the last step."""
        from portbench.reference import train

        w0 = gen.weights(self.ref.param_spec(self.cfg), self.device,
                         self.seed)
        batches = [draw_batch(self.tr, self.device, self.seed, i)
                   for i in range(steps)]
        return train.follow(reference_loss(self.ref, self.cfg, self.tr), w0,
                            batches, lr=self.tr["lr"], tf32=tf32)

    def program(self) -> dict:
        return {"losses": self.losses, "grad1": self.grad1,
                "change": self.change3}

    def compare(self, prog: dict, ref: dict) -> dict:
        from portbench import check
        return check.train_numbers(prog, ref)
