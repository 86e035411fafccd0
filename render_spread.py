"""Measures how far ``render_points`` on the card lies from the same call on
the CPU, over several scenes and repeated card runs, beside the bar that
``chip_smoke.py``'s phase 20 holds it to.

Run it from the root of a checkout on a machine with a CUDA card:

    python3 render_spread.py --seeds 4 --runs 2

Each seed draws one scene as phase 20 draws its own (seed 34 is phase 20's
scene): B=4 N=2048 points near a sphere, their normals from
``batch_normals(x, 20)``, colours and a weighting of the 128 x 128 image.
For each splat kind (EWA from the normals, isotropic) the CPU renders once
and the card ``--runs`` times, forward and backward; the script prints one
JSON line per card run with each output's max |card - CPU| / max |CPU|,
the bar (``chip_smoke.render_bar``), the gap of the render at a depth
temperature 2^-10 off, which the gate must see, and the gap that moving
every coordinate by one unit in the last place (a random sign each) makes
on the CPU, the rounding's own scale. The last lines give the
largest gap over all runs against the bar, and the card's name and power
limit. It exits with 1 when no card is present.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import chip_smoke


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--first-seed", type=int, default=chip_smoke.SEED + 34)
    parser.add_argument("--runs", type=int, default=2)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(chip_smoke.ROOT))
    from pytorch_points_tpu_torch.ops import batch_normals

    dev = torch.device("cuda")
    b, n, k, size = (chip_smoke.DSS[key] for key in ("b", "n", "k", "image"))
    worst = {}
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(chip_smoke.dss_cloud(rng, b, n)).to(dev)
        with torch.inference_mode():
            nrm = batch_normals(x, k)
        scene = chip_smoke.dss_scene(torch, rng, x, nrm.clone(), size)
        bar = chip_smoke.render_bar(scene)
        xc = x.cpu().numpy()
        shifted = torch.from_numpy(xc + np.spacing(np.abs(xc)) * rng.choice(
            [-1.0, 1.0], xc.shape).astype(np.float32))
        for ewa in (True, False):
            kind = "ewa" if ewa else "isotropic"
            ref = chip_smoke.render_scene(torch, scene, "cpu", ewa)
            probe = chip_smoke.render_gaps(chip_smoke.render_scene(
                torch, scene, dev, ewa, 1 + chip_smoke.RENDER_PROBE), ref)
            moved = chip_smoke.render_gaps(chip_smoke.render_scene(
                torch, dict(scene, xyz=shifted), "cpu", ewa), ref)
            for run in range(args.runs):
                gaps = chip_smoke.render_gaps(
                    chip_smoke.render_scene(torch, scene, dev, ewa), ref)
                for name, gap in gaps.items():
                    worst[kind, name] = max(worst.get((kind, name), 0.0),
                                            gap)
                print(json.dumps({"seed": seed, "splats": kind, "run": run,
                                  "gaps": gaps, "bar": bar,
                                  "probe_gaps": probe,
                                  "one_ulp_gaps": moved}))
    print(json.dumps({"largest_gaps": {f"{kind} {name}": gap for (kind, name),
                                       gap in worst.items()}}))
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
