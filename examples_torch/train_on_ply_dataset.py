"""End-to-end on real (on-disk) data, on the PyTorch/CUDA port: generate a
small PLY dataset of deformed template meshes with VARIABLE point counts,
train the flagship autoencoder through the full stack — PlyFolderDataset ->
BucketedBatcher (static-shape buckets + masks) -> Trainer (step,
checkpointing, NaN guard, prefetch) — and report reconstruction metrics
(chamfer-L1, f-score) on the training clouds and on held-out ones.

The counterpart of ``examples/train_on_ply_dataset.py``: the same
arguments, data, loss and artifact. It runs on the card unless
``--device cpu`` is given.

    python examples_torch/train_on_ply_dataset.py --steps 60
    python examples_torch/train_on_ply_dataset.py --steps 400 --bf16 \\
        --remat --emd-weight 0.05 --val-frac 0.25 --json-out out.json
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

import pytorch_points_tpu_torch as ppt
from pytorch_points_tpu_torch.data import BucketedBatcher, PlyFolderDataset
from pytorch_points_tpu_torch.losses.metrics import chamfer_l1, fscore
from pytorch_points_tpu_torch.models import PointCloudAutoencoder
from pytorch_points_tpu_torch.utils import geometry_utils, pc_utils
from pytorch_points_tpu_torch.utils.trainer import Trainer


def make_dataset(root: str, count: int = 24, seed: int = 0):
    """Write `count` PLY clouds: icosphere / grid templates under random
    smooth deformations, each sampled at a random size (ragged N)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    sphere, _ = geometry_utils.generate_icosphere(3)  # 642 verts
    grid, _ = geometry_utils.generate_grid_mesh(26, 26)  # 676 verts
    for i in range(count):
        base = sphere if i % 2 == 0 else grid
        # smooth low-frequency deformation
        freq = rng.uniform(1.0, 3.0, (3,))
        amp = rng.uniform(0.1, 0.35)
        phase = rng.uniform(0, 2 * np.pi, (3,))
        pts = base + amp * np.sin(base * freq + phase)
        # ragged sizes: random subset of the vertices
        n = int(rng.integers(380, len(pts)))
        idx = rng.choice(len(pts), n, replace=False)
        pc_utils.save_ply(pts[idx].astype(np.float32),
                          os.path.join(root, f"cloud_{i:03d}.ply"))


def split_dataset(ds, val_frac: float, seed: int = 17):
    """Random held-out split of a PlyFolderDataset by FILE (clouds never
    shared between splits).  Returns (train_ds, val_ds)."""
    import copy

    rng = np.random.default_rng(seed)
    files = list(ds.files)
    rng.shuffle(files)
    n_val = max(1, int(round(len(files) * val_frac)))
    train, val = copy.copy(ds), copy.copy(ds)
    train.files = sorted(files[n_val:])
    val.files = sorted(files[:n_val])
    return train, val


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them (the
    device's name where nvidia-smi is missing); "cpu" on the CPU."""
    if dev.type != "cuda":
        return str(dev)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--data", type=str, default=None,
                    help="PLY folder (default: generate a synthetic one)")
    ap.add_argument("--count", type=int, default=32)
    ap.add_argument("--val-frac", type=float, default=0.25,
                    help="held-out fraction of the clouds; val chamfer-L1 "
                    "and f-score are tracked alongside the train loss "
                    "(0 disables the split)")
    ap.add_argument("--json-out", type=str, default=None,
                    help="write a convergence artifact (loss curve + "
                    "metrics) to this path")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 mixed-precision policy (f32 params, bf16 "
                    "MLP compute)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each SA/FP stage")
    ap.add_argument("--emd-weight", type=float, default=0.0,
                    help="add weighted auction-EMD to the chamfer loss")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to train on")
    args = ap.parse_args()
    dev = torch.device(args.device)
    # the Trainer drives one device: no rounding of the batch to a count

    root = args.data
    tmp = None
    if root is None:
        tmp = tempfile.mkdtemp(prefix="ppt_ply_")
        make_dataset(tmp, count=args.count)
        root = tmp
    ds = PlyFolderDataset(root)
    if args.val_frac > 0 and len(ds) >= 4:
        ds_train, ds_val = split_dataset(ds, args.val_frac)
    else:
        ds_train, ds_val = ds, None
    batcher = BucketedBatcher(ds_train, batch_size=args.batch, multiple=128,
                              max_buckets=2, shuffle=True, seed=0,
                              drop_remainder=True)
    val_batcher = None
    if ds_val is not None:
        val_batcher = BucketedBatcher(ds_val, batch_size=args.batch,
                                      multiple=128, max_buckets=2,
                                      shuffle=False, seed=0,
                                      drop_remainder=False)
    print(f"dataset: {len(ds_train)} train / "
          f"{len(ds_val) if ds_val else 0} held-out clouds from {root}")

    model = PointCloudAutoencoder(
        96, 24, dtype=torch.bfloat16 if args.bf16 else None,
        remat=args.remat, device=dev,
        generator=torch.Generator().manual_seed(0))

    def loss_fn(m, batch):
        pts, mask = batch["points"], batch["mask"]
        pred = m(pts, mask=mask)
        loss = ppt.chamfer_distance(pred, pts, p_mask=mask, q_mask=mask)
        if args.emd_weight:
            # pred reconstructs pts row-for-row under the same mask, so
            # the masked-EMD equal-valid-count contract holds per pair.
            emd_d, _ = ppt.earth_mover_distance(
                pred, pts, p_mask=mask, q_mask=mask)
            loss = loss + args.emd_weight * emd_d.mean()
        return loss

    ckpt = tempfile.mkdtemp(prefix="ppt_ckpt_")
    trainer = Trainer(model, torch.optim.Adam(model.parameters(), 2e-3),
                      loss_fn, ckpt_dir=ckpt, log_every=20,
                      ckpt_every=10**9)

    def on_device(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    @torch.inference_mode()
    def eval_batch(pts, mask):
        pred = model(pts, mask=mask)
        cl1 = chamfer_l1(pred, pts, p_mask=mask, q_mask=mask)
        f, _, _ = fscore(pred, pts, threshold=0.05, pred_mask=mask,
                         gt_mask=mask)
        return cl1.mean(), f.mean()

    def eval_over(b):
        """Reconstruction metrics with the CURRENT trained params."""
        if b is None:
            return None, None
        cl1s, fss = [], []
        for batch in b:
            batch = on_device(batch)
            cl1, f = eval_batch(batch["points"], batch["mask"])
            cl1s.append(cl1.item())
            fss.append(f.item())
        return float(np.mean(cl1s)), float(np.mean(fss))

    def epochs():
        while True:
            # Trainer.fit wraps this in a data.Prefetcher by default, so
            # file reads, padding and the copy to the device happen on a
            # background thread while the device runs the previous step.
            for batch in batcher:
                yield on_device(batch)

    gen = epochs()
    first_loss = trainer.fit([next(gen)], steps=1)
    curve = [{"step": 1, "loss": round(first_loss, 6)}]
    trainer.log_every = max(args.steps // 12, 1)

    eval_secs = [0.0]

    def on_log(s, lv):
        # held-out metrics ride the training log points: the artifact
        # carries a VAL curve next to the train loss. Their cost is
        # tracked and excluded from the ms/step number.
        te = time.time()
        entry = {"step": s, "loss": round(lv, 6)}
        if val_batcher is not None:
            vc, vf = eval_over(val_batcher)
            entry["val_chamfer_l1"] = round(vc, 6)
            entry["val_fscore_at_0.05"] = round(vf, 4)
        curve.append(entry)
        eval_secs[0] += time.time() - te

    t0 = time.time()
    final_loss = trainer.fit(gen, steps=args.steps, on_log=on_log)
    dt = time.time() - t0 - eval_secs[0]
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({dt/max(args.steps - 1, 1)*1e3:.0f} ms/step); "
          f"loss {first_loss:.4f} -> {final_loss:.4f}")

    # reconstruction metrics with the trained params: train AND held-out
    tr_cl1, tr_fs = eval_over(batcher)
    cl1s, fss = [tr_cl1], [tr_fs]
    val_cl1, val_fs = eval_over(val_batcher)
    print(f"train metrics: chamfer-L1 {tr_cl1:.4f}  f-score@0.05 {tr_fs:.3f}")
    if val_cl1 is not None:
        print(f"val   metrics: chamfer-L1 {val_cl1:.4f}  "
              f"f-score@0.05 {val_fs:.3f}")
    if args.json_out:
        # Convergence artifact: the full stack — bucketed masked data,
        # prefetch, the training step, the masked chamfer (and EMD) —
        # converging on on-disk clouds, with a held-out curve.
        import json

        payload = {
            "backend": dev.type,
            "device": device_line(dev),
            "steps": args.steps,
            "batch": args.batch,
            "train_clouds": len(ds_train),
            "val_clouds": len(ds_val) if ds_val is not None else 0,
            "bf16": args.bf16,
            "remat": args.remat,
            "emd_weight": args.emd_weight,
            "loss_curve": curve,
            "first_loss": round(first_loss, 6),
            "final_loss": round(final_loss, 6),
            "ms_per_step": round(dt / max(args.steps - 1, 1) * 1e3, 1),
            "train_chamfer_l1": round(tr_cl1, 6),
            "train_fscore_at_0.05": round(tr_fs, 4),
        }
        if val_cl1 is not None:
            payload["val_chamfer_l1"] = round(val_cl1, 6)
            payload["val_fscore_at_0.05"] = round(val_fs, 4)
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json_out}")
    assert final_loss < first_loss, "training did not reduce the loss"
    return first_loss, final_loss, float(np.mean(cl1s)), float(np.mean(fss))


if __name__ == "__main__":
    main()
