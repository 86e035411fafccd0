"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``pytorch_points_tpu_torch``). It needs as many CUDA cards
as the cell asks for and exits with an error, printing no result, without
them. The last line of standard output is the result as one JSON object;
the numbers that decided ``correct`` are the last lines of standard
error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)  # this folder's modules only as portbench.*
else:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from portbench import guard, spec

    guard.require_clean("at start")
    import torch

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import pytorch_points_tpu_torch as port

    if ROOT not in Path(port.__file__).resolve().parents:
        print(f"portbench: the port must come from this checkout, not "
              f"{port.__file__}", file=sys.stderr)
        return 2
    from portbench import harness

    print(f"card: {card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
