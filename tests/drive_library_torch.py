"""Drive the PyTorch/CUDA port through its public surface on the CPU: a
user's mini workflow (the counterpart of ``tests/drive_library.py``).

FPS-downsample a cloud, group neighbourhoods, compute the chamfer + EMD
loss and take 20 gradient steps on a predicted cloud, then normals and
normalisation, a model step on bucketed ragged clouds and a checkpoint
round trip. The port's ops take their plain PyTorch versions on CPU
tensors; models are built with ``device="cpu"``.

    python tests/drive_library_torch.py
"""
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import pytorch_points_tpu_torch as ppt  # noqa: E402

print("torch", torch.__version__, "device: cpu")
rng = np.random.default_rng(42)
N, STEPS = 256, 20
gt = torch.from_numpy(rng.standard_normal((4, N, 3)).astype(np.float32))
pred = gt + 0.1 * torch.from_numpy(
    rng.standard_normal((4, N, 3)).astype(np.float32))

# 1. sample + group (SA front half)
new_xyz, new_feats, idx, grouped = ppt.sample_and_group(
    gt, None, N // 4, 32, 0.2)
print("sample_and_group:", tuple(new_xyz.shape), tuple(new_feats.shape),
      tuple(idx.shape))


# 2. chamfer + EMD loss and SGD steps on pred
def loss_fn(p):
    cd = ppt.chamfer_distance(p, gt)
    emd_d, _ = ppt.earth_mover_distance(p, gt, eps=0.02, max_iters=50)
    return cd + 0.1 * emd_d.mean()


p = pred.clone().requires_grad_(True)
with torch.no_grad():
    l0 = loss_fn(p).item()
for _ in range(STEPS):
    (g,) = torch.autograd.grad(loss_fn(p), p)
    with torch.no_grad():
        p -= 2.0 * g
with torch.no_grad():
    l1 = loss_fn(p).item()
print(f"loss before={l0:.5f} after {STEPS} SGD steps={l1:.5f}")
assert l1 < 0.98 * l0, "SGD did not reduce the loss"

# 3. normals + normalization utilities
normals = ppt.batch_normals(gt[:1], 16)
unit = torch.allclose(normals.norm(dim=-1), torch.ones(()), atol=1e-3)
print("normals:", tuple(normals.shape), "unit-norm:", bool(unit))
assert unit
norm_pc, centroid, rad = ppt.normalize_point_batch(gt)
print("normalize:", tuple(norm_pc.shape),
      float((norm_pc.norm(dim=-1).amax(-1) - 1).abs().max()))

# 4. model + data pipeline + checkpoint round trip
from pytorch_points_tpu_torch.data import (  # noqa: E402
    BucketedBatcher,
    random_clouds,
)
from pytorch_points_tpu_torch.models import (  # noqa: E402
    PointCloudAutoencoder,
)
from pytorch_points_tpu_torch.utils import (  # noqa: E402
    load_network,
    save_network,
)

ds = random_clouds(8, lo=200, hi=500, seed=0)
batcher = BucketedBatcher(ds, batch_size=4, multiple=128, max_buckets=2)
model = PointCloudAutoencoder(32, 8, device="cpu",
                              generator=torch.Generator().manual_seed(0))
opt = torch.optim.Adam(model.parameters(), 1e-3)
seen = 0
for batch in batcher:
    pts = torch.from_numpy(batch["points"])
    mask = torch.from_numpy(batch["mask"])
    opt.zero_grad()
    loss = ppt.chamfer_distance(model(pts, mask), pts, p_mask=mask,
                                q_mask=mask)
    loss.backward()
    opt.step()
    seen += 1
print(f"trained on {seen} bucketed batches, final loss {loss.item():.5f}")
assert seen > 0 and torch.isfinite(loss)
with tempfile.TemporaryDirectory() as ckdir:
    save_network(model, ckdir, step=1)
    restored, _ = load_network(model, ckdir, step=1)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in restored.items())
print("checkpoint roundtrip ok")
print("OK")
