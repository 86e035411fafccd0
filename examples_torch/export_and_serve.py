"""Example: train briefly, export the model with ``torch.export`` (the
weights saved in the artifact), then serve predictions from the artifact
alone, on the PyTorch/CUDA port.

The counterpart of ``examples/export_and_serve.py``. The serving side never
builds the model: it loads the program, whose kernels are the port's
``ppt::*`` custom ops, so it imports ``pytorch_points_tpu_torch`` (through
``utils.load_exported``) and nothing of the model's code. It runs on the
card unless ``--device cpu`` is given.

    python examples_torch/export_and_serve.py --steps 10 --n 512
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from pytorch_points_tpu_torch import chamfer_distance
from pytorch_points_tpu_torch.models import PointCloudAutoencoder
from pytorch_points_tpu_torch.utils import export_forward, load_exported


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--bf16", action="store_true",
                    help="train/export with the bf16 compute policy")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to train and serve on")
    args = ap.parse_args()
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)
    dtype = torch.bfloat16 if args.bf16 else None
    model = PointCloudAutoencoder(64, 16, dtype=dtype, device=dev,
                                  generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), 1e-3)
    x = torch.from_numpy(rng.uniform(-1, 1, (args.batch, args.n, 3)).astype(
        np.float32)).to(dev)

    def step(xyz):
        opt.zero_grad(set_to_none=True)
        loss = chamfer_distance(model(xyz), xyz)
        loss.backward()
        opt.step()
        return loss.detach()

    for i in range(args.steps):
        loss = step(x)
    print(f"trained {args.steps} steps, final chamfer {float(loss):.5f}")

    # --- export: weights saved in the artifact, static shapes ----------
    trained = model.eval()
    path = os.path.join(tempfile.mkdtemp(), "autoencoder.pt2")
    with torch.no_grad():
        export_forward(trained, x, path=path)
    print(f"exported {os.path.getsize(path)} bytes -> {path}")

    # --- serve: only the artifact + the port's ops -----------------------
    serve = load_exported(path)
    query = torch.from_numpy(rng.uniform(-1, 1, (args.batch, args.n, 3))
                             .astype(np.float32)).to(dev)
    with torch.no_grad():
        pred = serve(query)
        # the program runs the same kernels in the same order as the
        # eager forward, so the two agree to rounding
        live = trained(query)
    err = float((pred - live).abs().max())
    print(f"served prediction {tuple(pred.shape)}, max |exported - live| = "
          f"{err:.2e}")
    assert err < 1e-5
    print("SERVE OK")


if __name__ == "__main__":
    main()
