"""Segmentation training traffic: the port's ``Trainer`` over a pool of
seeded batches of clouds with normals, a shape category and per-point part
labels, trained on the per-point cross-entropy.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``points``,
``pool`` (distinct batches, cycled), ``categories``, ``classes``, ``lr``
(Adam), ``dropout`` (the configuration's model's, checked),
``warmup`` (steps after the three that are checked),
``steps_traced``. The configuration gives ``part_counts``, the parts of
each category, which number ``classes`` in all.

A batch: the clouds of ``gen.surface_clouds``; each point's normal the unit
vector from its cloud's centroid; a category a cloud, uniform; each point's
label uniform over its category's parts. The model's dropout draws its mask
from a generator of its own stream, seeded alike in the program and the
reference, so that the three checked steps share their masks. The window,
the traced step and the check are ``train.Driver``'s.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from portbench import gen
from portbench.gen import Phases
from portbench.kinds import train

STREAM_LABELS, STREAM_DROPOUT = 5, 6


def draw_batch(tr: dict, cfg: dict, device, seed: int, i: int) -> dict:
    """Batch ``i`` of the pool: {"points", "normals" [B,N,3], "category"
    [B] long, "labels" [B,N] long}."""
    b, n = tr["batch"], tr["points"]
    counts = torch.tensor(cfg["part_counts"], device=device)
    if len(counts) != tr["categories"] or int(counts.sum()) != tr["classes"]:
        raise ValueError("part_counts disagree with the traffic's categories "
                         "and classes")
    pts = gen.surface_clouds(b, n, device, seed, i)
    normals = pts / pts.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    g = gen.generator(device, seed, STREAM_LABELS, i)
    category = torch.randint(0, tr["categories"], (b,), generator=g,
                             device=device)
    u = torch.rand((b, n), generator=g, device=device)
    first = torch.cumsum(counts, 0) - counts
    cnt = counts[category][:, None]
    part = torch.minimum((u * cnt).long(), cnt - 1)
    return {"points": pts, "normals": normals, "category": category,
            "labels": first[category][:, None] + part}


def _half(batch: dict) -> dict:
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def port_loss(fault: str | None, dropout_generator):
    """The loss the window trains on: the mean cross-entropy of every
    point's logits."""

    def loss_fn(model, batch):
        if fault == "half_batch":
            batch = _half(batch)
        logits = model(batch["points"], batch["normals"], batch["category"],
                       dropout_generator=dropout_generator)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               batch["labels"].reshape(-1))

    return loss_fn


def reference_loss(ref, cfg: dict, dropout_generator):
    def loss_fn(params, batch, tf32):
        logits = ref.forward(params, batch, cfg, tf32, dropout_generator)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               batch["labels"].reshape(-1))

    return loss_fn


class Driver(train.Driver):
    """One segmentation training cell in one process."""

    def setup(self):
        from pytorch_points_tpu_torch import models
        from pytorch_points_tpu_torch.utils.trainer import Trainer

        tr, cfg, dev = self.tr, self.cfg, self.device
        if tr["dropout"] != cfg["kwargs"]["dropout"]:
            raise ValueError("the traffic's dropout is not the model's")
        clock = Phases(dev)
        self.w0 = gen.weights(self.ref.param_spec(cfg), dev, self.seed)
        clock("weights")
        model = getattr(models, cfg["model"])(**cfg["kwargs"], device=dev)
        model.load_state_dict(self.w0, strict=True)
        self.model = model
        self.opt = torch.optim.Adam(model.parameters(), lr=tr["lr"])
        if self.fault == "state_unchanged":
            self.opt.step = lambda *a, **k: None
        drop = gen.generator(dev, self.seed, STREAM_DROPOUT)
        self.trainer = Trainer(model, self.opt, port_loss(self.fault, drop))
        clock("model")
        self.pool = [draw_batch(tr, cfg, dev, self.seed, i)
                     for i in range(tr["pool"])]
        self.feed = itertools.cycle(self.pool)
        clock("pool")
        # the three checked steps, through the window's own call and feed
        losses = [self.trainer.fit(self.feed, steps=1, prefetch=None)]
        names = dict((p, n) for n, p in model.named_parameters())
        self.grad1 = {names[p]: float((s["exp_avg"] / (1 - train.BETA1))
                                      .norm())
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

    def follow(self, tf32: bool, steps: int = 3) -> dict:
        """The reference's readings over the first ``steps`` batches, from
        the weights drawn again and the dropout's generator seeded again."""
        from portbench.reference import train as ref_train

        w0 = gen.weights(self.ref.param_spec(self.cfg), self.device,
                         self.seed)
        batches = [draw_batch(self.tr, self.cfg, self.device, self.seed, i)
                   for i in range(steps)]
        drop = gen.generator(self.device, self.seed, STREAM_DROPOUT)
        return ref_train.follow(reference_loss(self.ref, self.cfg, drop), w0,
                                batches, lr=self.tr["lr"], tf32=tf32)
