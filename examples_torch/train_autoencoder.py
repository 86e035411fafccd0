"""Example: train the flagship autoencoder with Chamfer+EMD on synthetic
clouds through the port's data-parallel step (``parallel.make_train_step``
over a mesh's 'data' axis), on the PyTorch/CUDA port.

The counterpart of ``examples/train_autoencoder.py``. The step runs over
every rank of the world the caller started with ``torch.distributed``
(each rank on its shard of the batch); with no process group, this
process alone is a world of one. It runs on the card unless
``--device cpu`` is given.

    python examples_torch/train_autoencoder.py --steps 50 --batch 8 --n 1024
"""

from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from pytorch_points_tpu_torch import parallel
from pytorch_points_tpu_torch.models import PointCloudAutoencoder
from pytorch_points_tpu_torch.utils import save_network
from pytorch_points_tpu_torch.utils.benchmark import device_sync


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--emd-weight", type=float, default=0.1)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute policy (f32 params)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each SA/FP stage (larger N per device)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to train on")
    args = ap.parse_args()
    dev = torch.device(args.device)

    own_group = not dist.is_initialized()
    if own_group:  # a world of one: this process
        store = os.path.join(tempfile.mkdtemp(prefix="ppt_pg_"), "store")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(store, 1), rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=300))
    try:
        ndev = dist.get_world_size()
        assert args.batch % ndev == 0, "batch must divide device count"
        mesh = parallel.make_mesh({"data": ndev}, device_type=dev.type)
        model = PointCloudAutoencoder(
            args.n // 4, args.n // 16,
            dtype=torch.bfloat16 if args.bf16 else None, remat=args.remat,
            device=dev, generator=torch.Generator().manual_seed(0))
        loss_fn = parallel.reconstruction_loss(emd_weight=args.emd_weight)
        step = parallel.make_train_step(
            model, torch.optim.Adam(model.parameters(), args.lr), loss_fn,
            mesh=mesh)

        rng = np.random.default_rng(0)
        rank, shard = dist.get_rank(), args.batch // ndev
        t0 = time.time()
        for i in range(args.steps):
            points = rng.uniform(-1, 1, (args.batch, args.n, 3)).astype(
                np.float32)[rank * shard:(rank + 1) * shard]
            batch = {"points": torch.from_numpy(points).to(dev)}
            loss = step(batch)
            if i % 10 == 0 or i == args.steps - 1:
                device_sync(loss)
                print(f"step {i:4d}  loss {float(loss):.5f}  "
                      f"({(time.time()-t0)/(i+1)*1e3:.0f} ms/step avg)")
        if args.ckpt and rank == 0:
            save_network(model, args.ckpt, step=args.steps)
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
