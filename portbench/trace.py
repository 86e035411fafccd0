"""A torch.profiler window over a steady stretch of a run, read into device
time by item name, busy and idle time, and the longest idle gaps.

The opening marker (a short spin kernel after a synchronised first call)
is the routine of the port's ``chip_smoke.py::traced``, copied here: a
trace can lose its first device items, so only the items that start
after the spin count. The idle share is taken inside the one traced
window: one minus the union of the device items' intervals over the
window's span.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

@dataclass
class Trace:
    """What a traced stretch of ``steps`` steps read."""

    steps: int
    window_s: float
    busy_s: float
    items: dict = field(default_factory=dict)  # name -> [seconds, count]
    gaps: list = field(default_factory=list)  # [(label, seconds)] longest
    marker: str = ""

    @property
    def device_items(self) -> int:
        return sum(n for _, n in self.items.values())

    def seconds_matching(self, pattern) -> float:
        """Device seconds of the items whose names ``pattern`` matches."""
        return sum(s for name, (s, _) in self.items.items()
                   if pattern.search(name))

    def top_items(self, n: int = 10):
        ranked = sorted(self.items.items(), key=lambda kv: -kv[1][0])
        return [[name, s] for name, (s, _) in ranked[:n]]


def _union(intervals):
    """Merged, sorted [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A device item's function name without its namespace, template and
    parameters: "vectorized_layer_norm_kernel"."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("(", 1)[0].split("<", 1)[0].strip()
    return head.rsplit("::", 1)[-1].removeprefix("void ").strip() or name


def traced(fn, steps: int, tries: int = 3):
    """Trace ``steps`` calls of ``fn`` (each one step of the cell) after an
    opening call and a spin kernel, the device alone: recording the host's
    ops too slowed a host-bound step by a fifth to a third and with it the
    idle share it reads. The window runs from the spin's end to the last
    item's end (the stretch ends with a synchronise); an idle gap is
    labelled by the item that ends it, the one the host was issuing. A
    trace that lost the spin is taken again; after ``tries`` such traces
    the last is read whole and ``marker`` says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
        marks = [e.time_range.end for e in device
                 if "spin_kernel" in e.name]
        if marks:
            break
    counted = [e for e in device if "spin_kernel" not in e.name
               and (not marks or e.time_range.start >= max(marks))]
    w0 = max(marks) if marks else min(e.time_range.start for e in counted)
    w1 = max(e.time_range.end for e in counted)
    items = {}
    for e in counted:
        rec = items.setdefault(e.name, [0.0, 0])
        rec[0] += e.self_device_time_total / 1e6
        rec[1] += 1
    starts = sorted((e.time_range.start, e.name) for e in counted)
    merged = _union([(e.time_range.start, e.time_range.end) for e in counted])
    gaps, prev = [], w0
    for (s, e), (_, name) in zip(merged, _firsts(merged, starts)):
        if s > prev:
            gaps.append(("before " + short_name(name), (s - prev) / 1e6))
        prev = max(prev, e)
    gaps.sort(key=lambda g: -g[1])
    return Trace(steps=steps, window_s=(w1 - w0) / 1e6,
                 busy_s=sum(e - s for s, e in merged) / 1e6, items=items,
                 gaps=[list(g) for g in gaps[:10]],
                 marker="" if marks else "whole trace: opening spin lost")


def _firsts(merged, starts):
    """For each merged interval, the (start, name) of the item that opens
    it (``starts`` sorted by start)."""
    out, k = [], 0
    for s, _ in merged:
        while starts[k][0] < s:
            k += 1
        out.append(starts[k])
    return out
