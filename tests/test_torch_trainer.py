"""The port's training utilities, Trainer and export against the JAX
package (``utils/train_utils.py``, ``utils/trainer.py``, ``utils/export.py``).

Inputs come from numpy with a seed. The Trainer comparison runs both
packages' Trainers on the same PLY batches (8 clouds of 96-128 points, one
bucket of 128, B=2), the JAX side on a one-device mesh under
``force_impl("pallas")`` (Pallas in interpret mode), with the JAX model's
weights carried across by ``load_jax_params``.

Tolerances: the first step's loss rtol 1e-5 (the LayerNorm statistics
round differently, ~1e-6 relative, test_torch_train.py); steps 2 and 3
rtol 1e-4: after an Adam update a grad that differs by ~2^-13 of its
tensor's largest (the bf16-split Pallas scatter) can move an entry whose
grad is near zero by up to the learning rate, since Adam divides by the
grad's own scale; clamp_gradients rtol 1e-6 (the sum order of the squares
differs); the schedules rtol 1e-6 with atol 1e-6 of the base rate or end
weight (the reference computes in f32, and its 1 + cos cancels near the
end of the decay: values of ~1e-6 of the base rate carry ~1e-12 absolute
error there; the port computes in double); export round trips exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import pytorch_points_tpu as jppt
from pytorch_points_tpu.data import BucketedBatcher as JaxBatcher
from pytorch_points_tpu.data import PlyFolderDataset as JaxDataset
from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.models import PointCloudAutoencoder as JaxAutoencoder
from pytorch_points_tpu.utils import train_utils as jax_tu
from pytorch_points_tpu.utils.trainer import Trainer as JaxTrainer
from pytorch_points_tpu_torch.compat import load_jax_params
from pytorch_points_tpu_torch.data import BucketedBatcher, PlyFolderDataset
from pytorch_points_tpu_torch.models import PointCloudAutoencoder
from pytorch_points_tpu_torch.ops import chamfer_distance
from pytorch_points_tpu_torch.utils import (
    Trainer,
    benchmark,
    clamp_gradients,
    export_fn,
    export_forward,
    linear_loss_weight,
    load_exported,
    load_network,
    profiling,
    save_network,
    step_lr_schedule,
    train_utils,
    warmup_cosine_lr_schedule,
    weights_init,
)
from torch_inputs import write_ply_clouds

NPOINT1, NPOINT2 = 32, 8
B, MULTIPLE = 2, 128
STEPS = 3


@pytest.fixture(scope="module")
def ply_root(tmp_path_factory):
    return write_ply_clouds(tmp_path_factory.mktemp("ply"))


@pytest.fixture(scope="module")
def jax_model():
    # built under nnx.jit: eager construction compiles each op alone
    return nnx.jit(lambda: JaxAutoencoder(npoint1=NPOINT1, npoint2=NPOINT2,
                                          rngs=nnx.Rngs(0)))()


@pytest.fixture(scope="module")
def jax_params(jax_model):
    return jax.tree.map(np.asarray,
                        nnx.to_pure_dict(nnx.state(jax_model, nnx.Param)))


def _port_model(jax_params):
    model = PointCloudAutoencoder(NPOINT1, NPOINT2, device="cpu")
    load_jax_params(model, jax_params)
    return model


def _port_loss(m, batch):
    pred = m(batch["points"], batch["mask"])
    return chamfer_distance(pred, batch["points"], p_mask=batch["mask"],
                            q_mask=batch["mask"])


def _tensors(batches):
    for b in batches:
        yield {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# The Trainer against the JAX Trainer
# ---------------------------------------------------------------------------


def test_trainer_matches_jax_trainer(ply_root, jax_model, jax_params):
    jbatcher = JaxBatcher(JaxDataset(ply_root), B, multiple=MULTIPLE,
                          max_buckets=1, seed=0, drop_remainder=True)
    assert jbatcher.buckets == [MULTIPLE]

    def jloss(m, batch):
        pred = m(batch["points"], mask=batch["mask"])
        return jppt.chamfer_distance(pred, batch["points"],
                                     p_mask=batch["mask"],
                                     q_mask=batch["mask"])

    want = []
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    try:
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        jtr = JaxTrainer(jax_model, optax.adam(1e-3), jloss, mesh=mesh,
                         log_every=1)
        # the state replicated on the mesh from the start, as every step
        # returns it: one compile of the step instead of two
        jtr.state = jax.device_put(jtr.state, NamedSharding(mesh, P()))
        jtr.fit(iter(jbatcher), steps=STEPS, prefetch=None,
                on_log=lambda s, v: want.append(v))
    finally:
        jax_dispatch.force_impl(None)
        jax.clear_caches()

    model = _port_model(jax_params)
    batcher = BucketedBatcher(PlyFolderDataset(ply_root), B,
                              multiple=MULTIPLE, max_buckets=1, seed=0,
                              drop_remainder=True)
    got = []
    tr = Trainer(model, torch.optim.Adam(model.parameters(), 1e-3),
                 _port_loss, log_every=1)
    last = tr.fit(_tensors(batcher), steps=STEPS,
                  on_log=lambda s, v: got.append(v))
    assert tr.step == STEPS and last == got[-1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)


def test_trainer_logs_checkpoints_and_restores(ply_root, jax_params,
                                               tmp_path):
    model = _port_model(jax_params)
    batcher = BucketedBatcher(PlyFolderDataset(ply_root), B,
                              multiple=MULTIPLE, seed=0)
    logged = []
    tr = Trainer(model, torch.optim.Adam(model.parameters(), 1e-3),
                 _port_loss, ckpt_dir=str(tmp_path), log_every=2,
                 ckpt_every=2)
    last = tr.fit(_tensors(batcher), steps=3,
                  on_log=lambda s, v: logged.append((s, v)))
    assert [s for s, _ in logged] == [2] and np.isfinite(last)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2", "3"]
    trained = {k: v.clone() for k, v in model.state_dict().items()}

    fresh = _port_model(jax_params)
    tr2 = Trainer(fresh, torch.optim.Adam(fresh.parameters(), 1e-3),
                  _port_loss, ckpt_dir=str(tmp_path))
    tr2.restore(step=3)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, trained[k]), k


def test_trainer_nan_guard_and_remat(jax_params):
    model = _port_model(jax_params)

    def nan_loss(m, batch):
        return _port_loss(m, batch) * float("nan")

    batch = {"points": torch.zeros(2, 16, 3).uniform_(-1, 1),
             "mask": torch.ones(2, 16, dtype=torch.bool)}
    tr = Trainer(model, torch.optim.SGD(model.parameters(), 1e-3), nan_loss,
                 log_every=1)
    with pytest.raises(FloatingPointError, match="step 1"):
        tr.fit([batch], prefetch=None)
    # remat=True: the whole loss checkpointed (test_torch_sorted_bn_bf16.py
    # holds its grads to the plain step's); a fresh model, the NaN step
    # above having poisoned the first one's weights
    model = _port_model(jax_params)
    tr = Trainer(model, torch.optim.SGD(model.parameters(), 1e-3), _port_loss,
                 log_every=1, remat=True)
    assert np.isfinite(tr.fit([batch], prefetch=None))


# ---------------------------------------------------------------------------
# train_utils against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", [0.3, 1.0, 1.0 + 2e-7, 50.0])
def test_clamp_gradients_matches_jax(target):
    """``target`` is the grads' norm over max_norm=1: below, at, just
    above it, and far above."""
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((7, 5)), "b": rng.standard_normal(11)}
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in grads.values()))
    grads = {k: (v * target / norm).astype(np.float32)
             for k, v in grads.items()}
    want, want_norm = jax_tu.clamp_gradients(
        {k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
    got, got_norm = clamp_gradients(
        {k: torch.from_numpy(v) for k, v in grads.items()}, 1.0)
    np.testing.assert_allclose(got_norm.item(), float(want_norm), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,args", [
    ("linear_loss_weight", (0.1, 2.0, 10, 60)),
    ("step_lr_schedule", (1e-3, 25, 0.5, 1e-5)),
    ("warmup_cosine_lr_schedule", (1e-3, 90, 12, 1e-5)),
    ("warmup_cosine_lr_schedule", (3e-4, 50, 0, 0.0)),
])
def test_schedules_match_jax(name, args):
    port = {"linear_loss_weight": linear_loss_weight,
            "step_lr_schedule": step_lr_schedule,
            "warmup_cosine_lr_schedule": warmup_cosine_lr_schedule}[name]
    want = getattr(jax_tu, name)(*args)
    got = port(*args)
    steps = range(0, 130, 3)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-6,
                               atol=1e-6 * args[1 if name == "linear_loss_weight"
                                                else 0])


def test_schedule_drives_lambda_lr():
    sched = step_lr_schedule(1e-2, 2, 0.5)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], 1e-2)
    lr = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: sched(s) / 1e-2)
    seen = []
    for _ in range(5):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        lr.step()
    np.testing.assert_allclose(seen, [sched(s) for s in range(5)],
                               rtol=1e-12)


@pytest.mark.parametrize("method", ["xavier_uniform", "xavier_normal",
                                    "kaiming_uniform", "kaiming_normal",
                                    "normal"])
def test_weights_init_matches_jax_statistics(method):
    """A wide Linear (in 600, out 200, the flax kernel [600, 200]): both
    packages' draws have the same bounds and standard deviation (2%);
    biases and LayerNorm parameters are untouched."""
    fan_in, fan_out = 600, 200
    ref = np.asarray(jax_tu.weights_init(
        {"layer": {"kernel": jnp.zeros((fan_in, fan_out))}}, method,
        seed=0)["layer"]["kernel"])
    net = torch.nn.Sequential(torch.nn.Linear(fan_in, fan_out),
                              torch.nn.LayerNorm(fan_out))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    weights_init(net, method, seed=0)
    got = net[0].weight.detach().numpy().T
    assert got.shape == ref.shape == (fan_in, fan_out)
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]) == (k != "0.weight"), k
    np.testing.assert_allclose(got.std(), ref.std(), rtol=0.02)
    np.testing.assert_allclose(abs(got.mean()), 0, atol=0.01 * ref.std())
    if method != "normal":  # bounded draws: the same bound on both sides
        bound = np.abs(ref).max()
        assert np.abs(got).max() <= bound * 1.01
        assert np.abs(got).max() >= bound * 0.97


def test_save_load_tolerant_and_strict(tmp_path, caplog):
    state = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4),
             "nested": {"c": torch.full((2,), 7.0)}}
    save_network(state, tmp_path, step=5, meta={"epoch": 3})
    target = {"a": torch.zeros(2, 3, dtype=torch.float64),
              "b": torch.zeros(5), "nested": {"c": torch.zeros(2)},
              "d": torch.zeros(1)}
    # the package's logger does not propagate: listen on it directly
    train_utils.log.addHandler(caplog.handler)
    try:
        out, extra = load_network(target, tmp_path, step=5)
    finally:
        train_utils.log.removeHandler(caplog.handler)
    assert extra == {"meta": {"epoch": 3}}
    assert out["a"].dtype == torch.float64
    assert torch.equal(out["a"], state["a"].double())
    assert torch.equal(out["b"], torch.zeros(5))  # shape mismatch: kept
    assert torch.equal(out["nested"]["c"], state["nested"]["c"])
    assert torch.equal(out["d"], torch.zeros(1))  # missing: kept
    assert "shape mismatch at b" in caplog.text
    assert "missing checkpoint entry d" in caplog.text
    with pytest.raises(ValueError, match="shape mismatch"):
        load_network(target, tmp_path, step=5, strict=True)
    with pytest.raises(KeyError, match="missing"):
        load_network({"d": torch.zeros(1)}, tmp_path, step=5, strict=True)
    model = torch.nn.Linear(3, 2)
    save_network(model, tmp_path / "m")
    fresh = torch.nn.Linear(3, 2)
    restored, _ = load_network(fresh, tmp_path / "m", strict=True)
    fresh.load_state_dict(restored)
    assert torch.equal(fresh.weight, model.weight)


# ---------------------------------------------------------------------------
# export, benchmark, profiling
# ---------------------------------------------------------------------------


def test_export_fn_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.standard_normal((2, 64, 3)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 48, 3)).astype(np.float32))
    path = tmp_path / "chamfer.pt2"
    blob = export_fn(lambda a, b: chamfer_distance(a, b), (p, q),
                     path=str(path))
    assert path.read_bytes() == blob
    restored = load_exported(str(path))
    assert "ppt.nn_both_directions" in restored.code
    assert torch.equal(restored(p, q), chamfer_distance(p, q))


def test_export_forward_roundtrip(jax_params):
    model = _port_model(jax_params).eval()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 128, 3)).astype(np.float32))
    restored = load_exported(export_forward(model, x))
    for op in ("fps", "ball_query", "gather_rows", "knn"):
        assert f"ppt.{op}" in restored.code, op
    got = restored(x)
    want = model(x)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError):
        export_forward(model, x, platforms=("cuda",))


def test_measure_sync_and_trace(tmp_path):
    x = torch.ones(64, 64)
    benchmark.device_sync({"a": [x]})
    t = benchmark.measure(lambda a: a @ a, x, iters=2, warmup=1, repeats=3)
    assert 0 < t < 1
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("step"), profiling.op_scope("matmul"):
            x @ x
    names = {e.key for e in prof.key_averages()}
    assert {"step", "ppt.matmul"} <= names
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
