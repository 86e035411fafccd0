"""The numbers that decide ``correct``, each against its limit.

Training: the relative gap of the first step's loss (``loss_step1_gap``);
by the worst leaf, the gap between the program's and the reference's norm
of the first gradient (``grad_gap``); and over the leaves, the median gap
of the norm of the parameters' change after the third step
(``change_median_gap``). A leaf's gap is taken over the reference's norm
of that leaf or of the median leaf, whichever is larger. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change.

The later steps' losses and the worst leaf's change are not compared:
Adam's first update is about lr times the sign of each gradient element,
so elements whose gradient is at rounding level take their sign from the
rounding, program and reference part by 2 lr there, and the step 2 and 3
losses and the worst leaf's change swing from seed to seed by three
decades (PERF.md). ``train_diagnostics`` still reads them.

Serving: over the sampled requests, the largest gap of an output
coordinate, over the largest offset of the reference's output from its
input point (``out_gap``).
"""

from __future__ import annotations

import statistics


def _moved(ref: dict) -> set:
    g_med = statistics.median(ref["grad1"].values())
    return {k for k, g in ref["grad1"].items() if g >= 1e-3 * g_med}


def _leaf_gaps(prog: dict, ref: dict, keep) -> list[float]:
    med = statistics.median(ref.values())
    return [abs(prog.get(k, 0.0) - r) / max(r, med)
            for k, r in ref.items() if k in keep]


def train_numbers(prog: dict, ref: dict) -> dict:
    a, b = prog["losses"][0], ref["losses"][0]
    return {"loss_step1_gap": abs(a - b) / abs(b),
            "grad_gap": max(_leaf_gaps(prog["grad1"], ref["grad1"],
                                       ref["grad1"])),
            "change_median_gap": statistics.median(_leaf_gaps(
                prog["change"], ref["change"], _moved(ref)))}


def train_diagnostics(prog: dict, ref: dict) -> dict:
    """Readings that are not compared: each step's loss gap and the worst
    leaf's change gap."""
    out = {f"loss_step{i + 1}_gap": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))}
    out["change_worst_gap"] = max(_leaf_gaps(prog["change"], ref["change"],
                                             _moved(ref)))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at or under its limit; a number that is not finite fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        out[name] = {"value": value, "limit": limit}
        if not (value <= limit):  # NaN fails too
            ok = False
    return ok, out
