"""Times the scatter kernel (K4) alone at chip_smoke.py's phase-2 shapes, so
that two checkouts can be compared on one card in one run.

Run it from the root of each checkout in turn, alternating (A, B, B, A):

    python3 scatter_ab.py --label A

It builds the checkout's kernels, then for each shape launches the raw
entry point ``ppt_scatter_add`` (outputs and scratch allocated once, so
the Python wrapper's issue cost is left out) ``--calls`` times between two
CUDA events, and prints one JSON line per shape with the ms per call, the
median of ``--repeats`` such loops. Each output is first held bitwise
against the plain version on CPU copies.

The indices are drawn from a seed, not taken from the paths: uniform rows
at the shapes of the paths' scatters, a permutation where the path writes
one, distinct rows for the FPS coordinates, and, for the masked headline's
chamfer backward, a quarter of the updates aimed at one row (its poisoned
points all take one neighbour). Both checkouts see the same indices.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# (label, B, K, n, C, index kind): phase 2's K4 cases
SHAPES = (
    ("group backward", 16, 16384, 2048, 3, "uniform"),
    ("sa2 features", 16, 4096, 512, 128, "uniform"),
    ("chamfer backward", 32, 32768, 16384, 3, "uniform"),
    ("permutation write", 32, 16384, 16384, 2, "permutation"),
    ("headline group backward", 32, 65536, 16384, 3, "uniform"),
    ("headline FPS coords backward", 32, 2048, 16384, 3, "distinct"),
    ("masked headline chamfer backward", 32, 16384, 16384, 3, "one_row"),
)


def indices(rng, b, k, n, kind):
    if kind == "permutation":
        return np.stack([rng.permutation(n) for _ in range(b)])
    if kind == "distinct":
        return np.stack([rng.permutation(n)[:k] for _ in range(b)])
    idx = rng.integers(0, n, (b, k))
    if kind == "one_row":
        for row in idx:
            row[rng.permutation(k)[: k // 4]] = rng.integers(0, n)
    return idx


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=str(ROOT))
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("scatter_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pytorch_points_tpu_torch.kernels import _build, scatter

    lib = _build.library()
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    for label, b, k, n, c, kind in SHAPES:
        idx = torch.from_numpy(indices(rng, b, k, n, kind)).to(
            dev, torch.int32)
        upd = torch.from_numpy(
            rng.standard_normal((b, k, c)).astype(np.float32)).to(dev)
        out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
        scratch = torch.empty(4 * b * k + b * (n + 1), dtype=torch.int32,
                              device=dev)
        argv = (idx.data_ptr(), upd.data_ptr(), b, k, n, c,
                scratch.data_ptr(), out.data_ptr(), _build.stream(idx))
        _build.check(lib.ppt_scatter_add(*argv), "ppt_scatter_add")
        if not torch.equal(out.cpu(), scatter.scatter_add_torch(
                idx.cpu(), upd.cpu(), n)):
            print(f"scatter_ab: {label}: differs from the plain version",
                  file=sys.stderr)
            return 1
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        times = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.calls):
                lib.ppt_scatter_add(*argv)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / args.calls)
        print(json.dumps({"label": args.label, "case": label, "B": b, "K": k,
                          "n": n, "C": c, "ms": statistics.median(times)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
