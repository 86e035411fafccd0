"""Readings that the limits of ``correct`` are set from (not part of a
benchmark run).

For each seed, in one process: the program's numbers against the
reference (the sound run), the control's (the reference computed with
TF32 matmuls, put in the program's place) and, with ``--faults``, the
numbers of each fault the cell can have, planted in the program. Each
reading is one JSON line on standard output.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--faults] [--seconds 2]

A training cell's readings need no window; a serving cell's take a short
window at the cell's own load (``--seconds``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))

FAULTS = {"train": ("half_batch", "state_unchanged"),
          "serve": ("half_batch", "altered_answer")}


def extra(cell, prog, ref) -> dict:
    from portbench import check

    if cell.traffic["kind"] != "train":
        return {}
    return check.train_diagnostics(prog, ref)


def readings(cell, seed: int, device, seconds: float, fault=None,
             control: bool = False) -> list[dict]:
    """The cell's numbers for one seed: the program (with ``fault``
    planted) against the reference, and with ``control`` also the
    reference in TF32 against the same reference."""
    import torch

    from portbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    drv = harness.driver_for(cell, seed, device, fault)
    t0 = time.perf_counter()
    if cell.traffic["kind"] == "train":
        cell.traffic.update(pool=3, warmup=0)
        drv.setup()
    else:
        drv.setup()
        drv.window(seconds)
    t1 = time.perf_counter()
    prog = drv.program()
    drv.free()
    ref = drv.follow(tf32=False)
    t2 = time.perf_counter()
    head = {"cell": cell.name, "seed": seed}
    out = [{**head, "side": fault or "program", **drv.compare(prog, ref),
            **extra(cell, prog, ref), "program_s": t1 - t0,
            "reference_s": t2 - t1}]
    if control:
        ctl = drv.follow(tf32=True)
        if cell.traffic["kind"] == "serve":
            ctl = {i: y for i, (y, _) in ctl.items()}
        out.append({**head, "side": "control", **drv.compare(ctl, ref),
                    **extra(cell, ctl, ref),
                    "control_s": time.perf_counter() - t2})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from portbench import spec

    for seed in args.seeds:
        sides = [(None, not args.no_control)]
        if args.faults:
            kind = spec.Cell(args.workload).traffic["kind"]
            sides += [(f, False) for f in FAULTS[kind]]
        for fault, control in sides:
            for line in readings(spec.Cell(args.workload), seed, args.device,
                                 args.seconds, fault, control):
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
