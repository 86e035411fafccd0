"""Example: 4x upsample a .ply cloud with the 3PU-style PointUpsampler
(untrained weights — demonstrates the inference pipeline end-to-end), on
the PyTorch/CUDA port.

The counterpart of ``examples/upsample_cloud.py``. It runs on the card
unless ``--device cpu`` is given.

    python examples_torch/upsample_cloud.py input.ply output.ply
"""

import argparse

import torch

from pytorch_points_tpu_torch.models import PointUpsampler
from pytorch_points_tpu_torch.utils import pc_utils


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run the model on")
    args = ap.parse_args()
    dev = torch.device(args.device)
    inp, out = args.input, args.output
    xyz = pc_utils.read_ply(inp)
    xyz, centroid, radius = pc_utils.normalize_point_cloud(xyz)
    model = PointUpsampler(ratio=4, device=dev,
                           generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        up = model(torch.from_numpy(xyz).to(dev)[None])[0]
    up = up.cpu().numpy() * radius[0] + centroid[0]
    pc_utils.save_ply(up, out)
    print(f"{xyz.shape[0]} -> {up.shape[0]} points written to {out}")


if __name__ == "__main__":
    main()
