"""One run of one cell: set-up, the measured window, an optional traced
stretch, the check against the reference, and the result line.

``run_cell`` takes the device it is given and never looks for a card
itself: ``run.py`` refuses to start without one, and the CPU tests drive
the rest of a run through this function at tiny sizes.
"""

from __future__ import annotations

import gc
import importlib
import sys
import time

import torch

from portbench import check, guard, spec
from portbench import trace as tracing


class Context:
    """What a per-layer metric's reader may read: the cell, its window's
    numbers, the traced stretch and the card's peaks (None for a card that
    ``peaks.json`` does not list: no share of a peak is then reported)."""

    def __init__(self, cell, driver, tr, peaks, device_kind):
        self.cell, self.driver, self.trace = cell, driver, tr
        self.peaks = peaks.get(device_kind)

    def pattern(self, layer: str):
        return spec.patterns(layer)

    def work(self, name: str):
        return spec.work(name)(self)

    def roofline(self, flops: float, nbytes: float) -> float:
        """Seconds the chip needs at least for this work."""
        return max(flops / self.peaks["f32_flops_per_s"],
                   nbytes / self.peaks["hbm_bytes_per_s"])


def driver_for(cell, seed: int, device, fault=None):
    kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
    return kind.Driver(cell, seed, device, fault)


def device_info(device) -> dict:
    device = torch.device(device)
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None,
             fault: str | None = None) -> dict:
    """Run ``cell`` (a :class:`spec.Cell`) once; returns the result dict
    (the keys of the line ``run.py`` prints)."""
    t_start = time.perf_counter() if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False  # float32, as configured
    torch.backends.cudnn.allow_tf32 = False
    drv = driver_for(cell, seed, device, fault)
    before = time.perf_counter() - t_start
    drv.setup()
    setup_s = time.perf_counter() - t_start
    print("setup: " + ", ".join(f"{k} {v:.2f} s" for k, v in {
        "start and imports": before, **drv.setup_phases}.items()),
        file=sys.stderr)
    e2e = drv.window(seconds)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    tr = None
    if trace:
        tr = tracing.traced(drv.step_once, cell.traffic["steps_traced"])
        if tr.marker:
            print(f"trace: {tr.marker}", file=sys.stderr)
        ctx = Context(cell, drv, tr, spec.peaks(),
                      device_info(device)["kind"])
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": units[m["name"]]}
    dev = device_info(device)
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    attempted, failed = drv.attempted()
    guard.require_clean("after the window")
    prog = drv.program()
    drv.free()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = drv.follow(tf32=False)
    numbers = drv.compare(prog, ref)
    print(f"reference: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    correct, checks = check.judge(numbers, cell.limits)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr.top_items(10),
                            "idle_gaps": tr.gaps[:10]}
    out["checks"] = checks
    return out


def print_result(out: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    import json

    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
