"""Two more stretches of a traced run, read through the port's own span
recorder (``pytorch_points_tpu_torch.utils.profiling``), for the readers
of the train step's phases, the ops, the layers and the host's issue.

After the traced stretch (``trace.traced``) and before the check, each of
``steps_traced`` steps:

* stretch a: the recorder on, no profiler, a synchronise before each
  step, so each step's ``train.step`` span starts on an empty launch
  queue: the host's own cost of issuing the step;
* stretch b: the recorder on under the CUDA-only profiler with the
  opening call and spin kernel of ``trace.traced``, steps back to back;
  ``profiling.attribute`` reads it against the spans.

``of(ctx)`` makes both once per run and caches them on ``ctx``; it prints
the span table of stretch b, the host times of stretch a, the port's
kernel launches a step per wrapper (the ``launches`` counters over stretch
b), the ten longest idle gaps with their span labels and every
synchronising call to standard error. A port without the recorder yields
None, and so does every reader; without a card the stretches run (the
steps under the recorder, no profiler) and the readers return None.
"""

from __future__ import annotations

import importlib
import pkgutil
import statistics
import sys
from dataclasses import dataclass

import torch

from portbench import trace as tracing

PHASES = ("train.forward", "train.backward", "train.optimizer")
POINT_OPS = ("fps", "ball_query", "group", "knn", "three_nn",
             "three_interpolate", "gather", "scatter_add")
LOSS_OPS = ("chamfer", "nndistance", "emd")
LAYERS = ("layers.sa", "layers.fp", "layers.edgeconv")


def op_spans(ops) -> tuple:
    """The forward and backward span names of ``ops``."""
    return tuple(f"ppt.{o}{s}" for o in ops for s in ("", ".backward"))


@dataclass
class Spans:
    steps: int
    card: bool
    issue_s: list  # stretch a: each train.step span's seconds
    att: object  # stretch b: profiling.Attribution
    launches: dict  # wrapper -> launches over stretch b

    def has(self, *names: str) -> bool:
        return self.att.calls(*names) > 0

    def device_ms(self, *names: str):
        """Device ms a step under the spans of ``names`` (each item once)."""
        if not (self.card and self.has(*names)):
            return None
        return 1e3 * self.att.device_s(*names) / self.steps

    def self_ms(self, *names: str):
        if not (self.card and self.has(*names)):
            return None
        return 1e3 * self.att.self_device_s(*names) / self.steps


def _counters() -> dict:
    """Every kernel wrapper's ``launches`` counter, by module.name."""
    import pytorch_points_tpu_torch.kernels as kernels

    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for name, obj in vars(mod).items():
            if callable(obj) and isinstance(getattr(obj, "launches", None),
                                            int):
                out[f"{info.name}.{name}"] = obj.launches
    return out


def _issue(profiling, fn, steps: int, sync) -> list:
    with profiling.recording() as rec:
        for _ in range(steps):
            sync()
            fn()
        sync()
    return [(s.end_ns - s.start_ns) / 1e9 for s in rec.spans
            if s.name == "train.step" and s.end_ns is not None]


def _recorded(profiling, fn, steps: int):
    """``steps`` calls of ``fn`` with the recorder on: (spans, launches
    of each kernel wrapper that launched)."""
    before = _counters()
    with profiling.recording() as rec:
        for _ in range(steps):
            fn()
    after = _counters()
    return rec.spans, {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}


def _attributed(profiling, fn, steps: int, card: bool, tries: int = 3):
    """Stretch b: the profiler and opening spin of ``trace.traced`` (a
    trace that lost the spin is taken again), the recorder on for the
    steps alone. Returns (attribution, launches, marker)."""
    if not card:
        spans, launches = _recorded(profiling, fn, steps)
        return (profiling.attribute([], spans), launches,
                "no card: no profiler")
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            spans, launches = _recorded(profiling, fn, steps)
            torch.cuda.synchronize()
        evs = profiling.events(prof)
        marks = [e.end_ns for e in evs if e.device
                 and "spin_kernel" in e.name]
        if marks:
            return profiling.attribute(evs, spans, max(marks)), launches, ""
    return (profiling.attribute(evs, spans), launches,
            "whole trace: opening spin lost")


def measure(driver, steps: int):
    """Both stretches of ``steps`` steps of ``driver.step_once``; None for
    a port without the recorder."""
    from pytorch_points_tpu_torch.utils import profiling

    if not hasattr(profiling, "recording"):
        return None
    card = driver.device.type == "cuda"
    issue = _issue(profiling, driver.step_once, steps, driver.sync)
    att, launches, marker = _attributed(profiling, driver.step_once, steps,
                                        card)
    out = Spans(steps=steps, card=card, issue_s=issue, att=att,
                launches=launches)
    report(out, marker)
    return out


def of(ctx):
    """The stretches of this run, made at the first call."""
    if not hasattr(ctx, "_spans"):
        ctx._spans = measure(ctx.driver, ctx.cell.traffic["steps_traced"])
    return ctx._spans


def report(s: Spans, marker: str = "") -> None:
    n, att = s.steps, s.att
    err = sys.stderr
    print(f"spans: stretch b, {n} steps back to back under the profiler"
          f"{'; ' + marker if marker else ''}; a step: device ms, self "
          f"device ms, host ms, calls", file=err)
    for name in att.names():
        print(f"  {name:32s} {1e3 * att.device_s(name) / n:9.4f} "
              f"{1e3 * att.self_device_s(name) / n:9.4f} "
              f"{1e3 * att.host_s(name) / n:9.4f} "
              f"{att.calls(name) / n:6.2f}", file=err)
    phases = sum(att.device_s(p) for p in PHASES)
    print(f"  device busy {1e3 * att.busy_s / n:.4f} ms a step of "
          f"{1e3 * att.window_s / n:.4f}; forward + backward + optimizer "
          f"{1e3 * phases / n:.4f}; unattributed "
          f"{1e3 * att.unattributed_s / n:.4f}", file=err)
    if s.issue_s:
        q = (statistics.quantiles(s.issue_s, n=4) if len(s.issue_s) > 1
             else s.issue_s * 3)
        print(f"spans: stretch a, train.step host ms after a synchronise: "
              f"median {1e3 * statistics.median(s.issue_s):.4f}, quartiles "
              f"{1e3 * q[0]:.4f} {1e3 * q[2]:.4f}", file=err)
    print("spans: launches a step: " + ", ".join(
        f"{k} {v / n:g}" for k, v in sorted(s.launches.items())), file=err)
    print("spans: longest idle gaps (ms): " + ", ".join(
        f"{label} {1e3 * sec:.4f} (before {tracing.short_name(item)})"
        for label, sec, item in att.gaps[:10]),
        file=err)
    print(f"spans: synchronising calls ({len(att.syncs)}): " + ", ".join(
        f"{name} {1e3 * sec:.4f} ms in {label or '(no span)'}"
        for name, sec, label in att.syncs), file=err)
