"""Example: fit a cage deformation that turns a sphere into an ellipsoid,
on the PyTorch/CUDA port.

Optimizes cage vertex offsets directly (no network) through the MVC
deformation — demonstrates that gradients flow through the cage pipeline.
The counterpart of ``examples/deform_with_cage.py``. It runs on the card
unless ``--device cpu`` is given.

    python examples_torch/deform_with_cage.py
"""

import argparse

import numpy as np
import torch

from pytorch_points_tpu_torch.geo import (
    deform_with_cage,
    mean_value_coordinates,
)
from pytorch_points_tpu_torch.losses import ChamferLoss
from pytorch_points_tpu_torch.utils import geometry_utils


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to fit on")
    args = ap.parse_args()
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)
    # source: points on a unit sphere; target: squashed ellipsoid
    pts = rng.standard_normal((512, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    target = pts * np.array([1.0, 0.5, 1.0], np.float32)

    cage_v, cage_f = geometry_utils.generate_icosphere(1, radius=1.5)
    weights = mean_value_coordinates(torch.from_numpy(pts).to(dev), cage_v,
                                     cage_f)
    cage = torch.as_tensor(cage_v, dtype=torch.float32, device=dev)
    target = torch.from_numpy(target).to(dev)

    cl = ChamferLoss()
    offsets = torch.zeros_like(cage, requires_grad=True)
    opt = torch.optim.Adam([offsets], lr=1e-2)

    def step():
        opt.zero_grad(set_to_none=True)
        deformed = deform_with_cage(weights, cage + offsets)
        loss = cl(deformed[None], target[None])
        loss.backward()
        opt.step()
        return loss.detach()

    for i in range(200):
        loss = step()
        if i % 50 == 0 or i == 199:
            print(f"step {i:3d}  chamfer {float(loss):.6f}")
    assert float(loss) < 1e-3, "cage fit did not converge"
    print("cage deformation fit ok")


if __name__ == "__main__":
    main()
