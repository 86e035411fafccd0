"""Rank bodies of the port's parallel tests (``test_torch_parallel.py``).

``inputs()`` makes every case's seeded numpy inputs; both the test (the
JAX side) and the ranks call it. ``Ranks`` starts ``world`` processes
of this file on a gloo group over a ``FileStore``; each runs every case on
the CPU and pickles its results (its shards of the outputs) for the test
to assemble. This module imports torch and the port only, never JAX.

    python tests/torch_parallel_ranks.py RANK WORLD STORE OUT_DIR WEIGHTS MODE

MODE "cpu" runs the CPU cases of ``test_torch_parallel.py``; "cuda" the
card test of ``test_torch_cuda.py`` (gloo on CUDA tensors of one card).
"""

import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np

WORLD = 4
NPOINT1, NPOINT2 = 16, 8  # the reference's data-parallel autoencoder
LR = 1e-2  # SGD: the update is linear in the gradient (see the tests)
STEPS = 2


def _grid(rng, *shape):
    """Dyadic-grid coordinates k/64 in [-1, 1]: every squared distance and
    sum in the NN scans and the auction is exact in float32."""
    return (rng.integers(-64, 65, shape) / 64).astype(np.float32)


def inputs():
    """{case: {name: array}}, at the reference's test sizes
    (tests/test_models_parallel.py), divisible by WORLD."""
    rng = np.random.default_rng(11)
    normal = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    base = _grid(rng, 1, 32, 3)
    nv = 48
    emd_mask = np.broadcast_to(np.arange(64) < nv, (2, 64)).copy()
    bq_mask = np.ones((2, 96), bool)
    bq_mask[:, 50:70] = False
    fps_mask = np.ones((2, 128), bool)
    fps_mask[:, 40:88] = False
    knn_mask = np.ones((2, 96), bool)
    knn_mask[:, 60:] = False
    return {
        "nn": dict(p=_grid(rng, 2, 40, 3), q=_grid(rng, 2, 64, 3)),
        "chamfer": dict(p=_grid(rng, 2, 96, 3), q=_grid(rng, 2, 128, 3)),
        "ring": dict(p=_grid(rng, 2, 64, 3), q=_grid(rng, 2, 96, 3)),
        "ring_ties": dict(p=_grid(rng, 1, 32, 3),
                          q=np.concatenate([base, base], 1)),
        "fps": dict(xyz=normal(2, 128, 3), mask=fps_mask),
        "bq": dict(xyz=normal(2, 96, 3), cen=normal(2, 32, 3), mask=bq_mask),
        "group": dict(feats=normal(2, 64, 5),
                      idx=rng.integers(0, 64, (2, 16, 4)).astype(np.int32),
                      w=normal(2, 16, 4, 5)),
        "interp": dict(unknown=_grid(rng, 2, 32, 3),
                       known=_grid(rng, 2, 12, 3),
                       feats=normal(2, 12, 6), w=normal(2, 32, 6)),
        "emd": dict(p=_grid(rng, 2, 64, 3), q=_grid(rng, 2, 64, 3),
                    w=normal(2, 64), mask=emd_mask),
        "knn": dict(q=_grid(rng, 2, 64, 3), s=_grid(rng, 2, 96, 3),
                    mask=knn_mask),
        "sag": dict(xyz=normal(2, 128, 3), feats=normal(2, 128, 4),
                    mask=fps_mask, w=normal(2, 16, 8, 7)),
        "train": dict(points=[normal(16, 64, 3) for _ in range(STEPS)]),
        "bn": dict(points=normal(8, 32, 3)),
    }


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------


def _run_cases(rank, world, weights):
    import torch

    from pytorch_points_tpu_torch import parallel
    from pytorch_points_tpu_torch.compat import load_jax_params
    from pytorch_points_tpu_torch.layers import SharedMLP
    from pytorch_points_tpu_torch.models import PointCloudAutoencoder
    from pytorch_points_tpu_torch.ops import chamfer_distance
    from pytorch_points_tpu_torch.parallel.collectives import psum
    from pytorch_points_tpu_torch.utils import Trainer

    mesh = parallel.make_mesh({"points": world}, device_type="cpu")
    group = mesh.get_group("points")
    data = inputs()
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def shard(a, dim=1):
        n = a.shape[dim] // world
        return t(a).narrow(dim, rank * n, n).contiguous()

    def np_(*xs):
        return [x.detach().numpy() for x in xs]

    c = data["nn"]
    out["nn"] = np_(*parallel.nndistance_sharded(t(c["p"]), shard(c["q"]),
                                                 mesh))
    c = data["chamfer"]
    p, q = t(c["p"]).requires_grad_(), shard(c["q"]).requires_grad_()
    loss = parallel.chamfer_sharded(p, q, mesh)
    loss.backward()
    out["chamfer"] = np_(loss, p.grad, q.grad)
    for name in ("ring", "ring_ties"):
        c = data[name]
        out[name] = np_(*parallel.nndistance_ring(shard(c["p"]),
                                                  shard(c["q"]), mesh))
    c = data["fps"]
    out["fps"] = np_(
        parallel.furthest_point_sample_sharded(shard(c["xyz"]), 16, mesh),
        parallel.furthest_point_sample_sharded(shard(c["xyz"]), 16, mesh,
                                               mask=shard(c["mask"])))
    c = data["bq"]
    out["bq"] = np_(
        *parallel.ball_query_sharded(t(c["xyz"]), shard(c["cen"]), 0.8, 8,
                                     mesh),
        *parallel.ball_query_sharded(t(c["xyz"]), shard(c["cen"]), 0.8, 8,
                                     mesh, mask=t(c["mask"])))
    c = data["group"]
    f = t(c["feats"]).requires_grad_()
    g = parallel.group_points_sharded(f, shard(c["idx"]), mesh)
    psum((g * shard(c["w"])).sum(), group).backward()
    out["group"] = np_(g, f.grad)
    c = data["interp"]
    d, i = parallel.three_nn_sharded(shard(c["unknown"]), t(c["known"]), mesh)
    wgt = (1.0 / (d + 1e-8))
    wgt = wgt / wgt.sum(-1, keepdim=True)
    f = t(c["feats"]).requires_grad_()
    o = parallel.three_interpolate_sharded(f, i, wgt, mesh)
    psum((o * shard(c["w"])).sum(), group).backward()
    out["interp"] = np_(d, i, o, f.grad)
    c = data["emd"]
    res = []
    for masked in (False, True):
        p, q = t(c["p"]).requires_grad_(), shard(c["q"]).requires_grad_()
        kw = dict(p_mask=t(c["mask"]), q_mask=shard(c["mask"])) if masked \
            else {}
        dist_, assign = parallel.earth_mover_distance_sharded(
            p, q, mesh, eps=0.01, max_iters=45, **kw)
        (dist_ * t(c["w"])).sum().backward()
        res += np_(dist_, assign, p.grad, q.grad)
    out["emd"] = res
    c = data["knn"]
    out["knn"] = np_(
        *parallel.knn_sharded(shard(c["q"]), t(c["s"]), 8, mesh),
        *parallel.knn_sharded(shard(c["q"]), t(c["s"]), 8, mesh,
                              support_mask=t(c["mask"])))
    c = data["sag"]
    res = []
    for kw in (dict(), dict(normalize_radius=True, mask=shard(c["mask"]))):
        x, f = shard(c["xyz"]).requires_grad_(), shard(c["feats"])
        f.requires_grad_()
        new_xyz, feats, idx, gxyz = parallel.sample_and_group_sharded(
            x, f, 16, 8, 0.8, mesh, **kw)
        loss = (psum((feats * shard(c["w"])).sum(), group)
                + (new_xyz ** 2).sum())
        loss.backward()
        res += np_(new_xyz, feats, idx, gxyz, x.grad, f.grad)
    out["sag"] = res
    # unequal shards (M = 10 over 4 ranks: 3, 3, 2, 2) raise on every rank
    q_bad = torch.zeros(1, 3 if rank < 2 else 2, 3)
    try:
        parallel.nndistance_sharded(torch.zeros(1, 4, 3), q_bad, mesh)
        out["unequal"] = "no error"
    except ValueError as e:
        out["unequal"] = str(e)

    # the data-parallel step, remat, BatchNorm and the Trainer
    dmesh = parallel.make_mesh({"data": world}, device_type="cpu")

    def autoencoder():
        model = PointCloudAutoencoder(NPOINT1, NPOINT2, device="cpu")
        load_jax_params(model, weights["autoencoder"])
        return model

    def loss_fn(m, batch):
        return chamfer_distance(m(batch["points"]), batch["points"])

    batches = [{"points": shard(b, 0)} for b in data["train"]["points"]]
    res = {}
    for remat in (False, True):
        model = autoencoder()
        step = parallel.make_train_step(
            model, torch.optim.SGD(model.parameters(), LR), loss_fn,
            mesh=dmesh, remat=remat)
        losses = [float(step(b)) for b in batches[: 1 if remat else STEPS]]
        res[f"remat={remat}"] = (losses, {k: v.numpy().copy() for k, v in
                                          model.state_dict().items()})
    model = autoencoder()
    ckpt = os.path.join(weights["tmp"], "ckpt")
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), LR),
                      loss_fn, mesh=dmesh, ckpt_dir=ckpt, log_every=1)
    logged = []
    last = trainer.fit(iter(batches), prefetch=None,
                       on_log=lambda s, v: logged.append(v))
    trainer.restore(step=STEPS)
    res["trainer"] = (logged, last, sorted(os.listdir(ckpt)),
                      {k: v.numpy().copy()
                       for k, v in model.state_dict().items()})

    torch.manual_seed(0)
    mlp = SharedMLP([3, 16, 3], norm="batch", act_last=False, device="cpu")
    load_jax_params(mlp, weights["bn"][0], weights["bn"][1])
    step = parallel.make_train_step(
        mlp, torch.optim.SGD(mlp.parameters(), LR),
        lambda m, b: ((m(b["points"]) - b["points"]) ** 2).mean(),
        mesh=dmesh)
    loss = float(step({"points": shard(data["bn"]["points"], 0)}))
    res["bn"] = (loss, {k: v.numpy().copy()
                        for k, v in mlp.state_dict().items()})
    out["train"] = res
    return out


def _device_cases(rank, world, device_type="cuda"):
    """The collectives ``parallel/collectives.py`` relies on, over gloo on
    CUDA tensors of one card, and the sharded NN and ring against the
    one-device K5 on the card."""
    import torch

    from pytorch_points_tpu_torch import parallel
    from pytorch_points_tpu_torch.kernels import distance_tiles
    from pytorch_points_tpu_torch.parallel import collectives as col

    if device_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(device_type, 0)
    mesh = parallel.make_mesh({"points": world}, device_type=device_type)
    group = mesh.get_group("points")
    x = torch.full((3, 2), float(rank + 1), device=dev)
    out = {"gather": col.gather_raw(x, group).cpu().numpy(),
           "gather_u8": col.gather_raw(x.to(torch.uint8),
                                       group).cpu().numpy(),
           "psum": col.psum_raw(x, group).cpu().numpy(),
           "ring": [t.cpu().numpy() for t in col.ring_shift(
               [x, x.int() * 10], group)]}
    y = x.clone().requires_grad_()
    whole = col.all_gather(y, group, dim=0)  # [W*3, 2]
    loss = col.psum((col.pvary(whole, group) * (rank + 1)).sum(), group)
    loss.backward()
    out["autograd"] = (whole.detach().cpu().numpy(), float(loss),
                       y.grad.cpu().numpy())
    rng = np.random.default_rng(5)
    p = torch.from_numpy(_grid(rng, 2, 512, 3)).to(dev)
    q = torch.from_numpy(_grid(rng, 2, 1024, 3)).to(dev)
    m = q.shape[1] // world
    q_loc = q[:, rank * m:(rank + 1) * m]
    ref = distance_tiles.nn_both_directions(p, q)  # K5, one device
    k13 = distance_tiles.nn_one_direction_cuda.launches
    got = parallel.nndistance_sharded(p, q_loc, mesh)
    out["nn_k13_launches"] = distance_tiles.nn_one_direction_cuda.launches \
        - k13
    out["nn_equal"] = [bool(torch.equal(got[0], ref[0])),
                       bool(torch.equal(got[1], ref[1])),
                       bool(torch.equal(got[2], ref[2][:, rank * m:
                                                      (rank + 1) * m])),
                       bool(torch.equal(got[3], ref[3][:, rank * m:
                                                      (rank + 1) * m]))]
    n = p.shape[1] // world
    got = parallel.nndistance_ring(p[:, rank * n:(rank + 1) * n], q_loc,
                                   mesh)
    out["ring_equal"] = [
        bool(torch.equal(got[0], ref[0][:, rank * n:(rank + 1) * n])),
        bool(torch.equal(got[1], ref[1][:, rank * n:(rank + 1) * n])),
        bool(torch.equal(got[2], ref[2][:, rank * m:(rank + 1) * m])),
        bool(torch.equal(got[3], ref[3][:, rank * m:(rank + 1) * m]))]
    return out


def main(rank, world, store_path, out_dir, weights_path, mode):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(weights_path, "rb") as f:
        weights = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        if mode == "cuda":
            out = _device_cases(rank, world)
        else:
            out = _run_cases(rank, world, weights)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Ranks:
    """``world`` processes of this file, started at once; ``results``
    waits for them (each rank's dict). Every rank is killed, and
    ``results`` raises, past the deadline or when one fails."""

    def __init__(self, tmp_dir, weights, world=WORLD, deadline=150.0,
                 mode="cpu"):
        weights = dict(weights, tmp=str(tmp_dir))
        wpath = os.path.join(tmp_dir, "weights.pkl")
        with open(wpath, "wb") as f:
            pickle.dump(weights, f)
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.dirname(here), here,
                        os.environ.get("PYTHONPATH", "")]))
        self.tmp_dir, self.world = str(tmp_dir), world
        self.logs = [os.path.join(tmp_dir, f"rank{r}.log")
                     for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(r),
                     str(world), os.path.join(tmp_dir, "store"),
                     self.tmp_dir, wpath, mode],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        self.end = time.monotonic() + deadline
        self._results = None

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    @property
    def results(self):
        if self._results is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.end - time.monotonic()))
            finally:
                self.stop()
            bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
            if bad:
                raise RuntimeError(f"ranks {bad} failed:\n" + "\n".join(
                    open(self.logs[r], errors="replace").read()[-3000:]
                    for r in bad))
            self._results = []
            for r in range(self.world):
                with open(os.path.join(self.tmp_dir, f"rank{r}.pkl"),
                          "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
