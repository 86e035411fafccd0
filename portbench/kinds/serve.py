"""Serving traffic: one caller's requests to the port's model, each a
forward under ``inference_mode`` of a batch of clouds, its output then
copied to the host.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``points``,
``pool`` (distinct input batches, cycled), ``rate_per_s`` (requests a
second, fixed: an open loop, request i due at ``i / rate`` plus a jitter
of up to ``jitter`` of a period, the jitters an even spread that the seed
puts in its order), ``warmup`` (requests before the window),
``sample`` (requests whose outputs are checked), ``steps_traced``.

A request is served when its turn comes and it is due; its latency runs
from when it was due until its output is on the host, so a stall counts
against the requests queued behind it.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import gen, spec
from portbench.gen import Phases


def draw_input(tr: dict, device, seed: int, i: int) -> torch.Tensor:
    return gen.surface_clouds(tr["batch"], tr["points"], device, seed, i)


def due_times(tr: dict, seconds: float, seed: int) -> list[float]:
    """Seconds after the window opens at which each request is due."""
    rate = float(tr["rate_per_s"])
    n = max(1, math.floor(rate * seconds))
    g = gen.generator("cpu", seed, gen.STREAM_ARRIVALS)
    order = torch.randperm(n, generator=g).tolist()
    jit = float(tr.get("jitter", 0.0))
    return [(i + jit * ((order[i] + 0.5) / n - 0.5)) / rate
            for i in range(n)]


def sampled(n: int, m: int, seed: int) -> list[int]:
    """``m`` distinct request indices of ``n``, drawn from the seed, the
    last request always among them."""
    g = gen.generator("cpu", seed, gen.STREAM_SAMPLE)
    pick = torch.randperm(max(n - 1, 0), generator=g)[: max(m - 1, 0)]
    return sorted({*pick.tolist(), n - 1})


def percentile(values, q: float) -> float:
    """Nearest-rank percentile of ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


class Driver:
    """One serving cell in one process."""

    def __init__(self, cell, seed: int, device, fault: str | None = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.fault = fault
        self.tr, self.cfg = cell.traffic, cell.config
        self.ref = spec.reference(self.cfg["reference"])

    def setup(self):
        from pytorch_points_tpu_torch import models

        tr, dev = self.tr, self.device
        clock = Phases(dev)
        w0 = gen.weights(self.ref.param_spec(self.cfg), dev, self.seed)
        clock("weights")
        model = getattr(models, self.cfg["model"])(**self.cfg["kwargs"],
                                                   device=dev)
        model.load_state_dict(w0, strict=True)
        self.model = model.eval()
        clock("model")
        self.pool = [draw_input(tr, dev, self.seed, i)
                     for i in range(tr["pool"])]
        clock("pool")
        self.count = 0
        for _ in range(tr["warmup"]):
            self.request()
        clock("warm-up")
        self.setup_phases = clock.seconds

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def request(self) -> torch.Tensor:
        """Serve the next input of the pool: its output on the host."""
        x = self.pool[self.count % len(self.pool)]
        self.count += 1
        with torch.inference_mode():
            if self.fault == "half_batch":
                half = x.shape[0] // 2
                y = self.model(x[:half])
                y = torch.cat([y, torch.zeros_like(y)])
            else:
                y = self.model(x)
            if self.fault == "altered_answer":
                y = y.clone()
                y[0, 0, 0] += 0.01
            return y.cpu()

    def window(self, seconds: float) -> dict:
        due = due_times(self.tr, seconds, self.seed)
        keep = set(sampled(len(due), self.tr["sample"], self.seed))
        self.count = 0  # request i takes pool input i mod pool
        self.kept, lat, service = {}, [], []
        self.sync()
        t0 = time.perf_counter()
        for i, d in enumerate(due):
            at = t0 + d
            while time.perf_counter() < at:
                pass
            start = time.perf_counter()
            out = self.request()
            done = time.perf_counter()
            lat.append(done - at)
            service.append(done - start)
            if i in keep:
                self.kept[i] = out
        self.requests = len(due)
        self.service_s = sum(service) / len(service)
        return {"serve_ms_p95": percentile(lat, 95) * 1e3}

    def step_once(self):
        self.request()

    def attempted(self) -> tuple[int, int]:
        return self.requests, 0

    def free(self):
        del self.model, self.pool

    def follow(self, tf32: bool) -> dict:
        """The reference's output for each kept request."""
        from portbench.reference import ops

        w0 = gen.weights(self.ref.param_spec(self.cfg), self.device,
                         self.seed)
        out = {}
        with torch.no_grad(), ops.matmul_precision(tf32):
            for i in self.kept:
                x = draw_input(self.tr, self.device, self.seed,
                               i % self.tr["pool"])
                out[i] = (self.ref.forward(w0, x, self.cfg, tf32).cpu(),
                          x.cpu())
        return out

    def program(self) -> dict:
        return self.kept

    def compare(self, prog: dict, ref: dict) -> dict:
        worst = 0.0
        for i, (r, x) in ref.items():
            ratio = r.shape[1] // x.shape[1]
            scale = (r - x.repeat_interleave(ratio, dim=1)).abs().amax()
            worst = max(worst, float((prog[i] - r).abs().amax() / scale))
        return {"out_gap": worst}
