"""The port's ``parallel/`` against the JAX package's: the 11 sharded ops,
the data-parallel step (BatchNorm, remat) and the Trainer on a mesh.

One module-scoped fixture starts 4 gloo ranks once (``torch_parallel_ranks
.py``, a process each, on the CPU); they run every case and return their
shards. The JAX side runs each function on a 4-device mesh, so the
per-shard float sums come in the same order, the sharded ops under
``force_impl("pallas")`` (the Pallas kernels in interpret mode) and on
dyadic-grid clouds where the NN scans or the auction are held bit for bit.

Tolerances: indices, assignments and grid distances exact; a gradient
summed over ranks (a replicated input's) rtol 1e-6 with atol 1e-6 of its
scale: gloo's all-reduce adds the ranks' partial sums in another order
than the reference's psum. The train steps use SGD, whose update is linear in
the gradient, so the parameters after each step are held to rtol 1e-5
(atol 1e-7), and the losses to rtol 1e-5. (Adam divides by each grad's
own scale: a grad that is rounding noise, such as a Linear's bias before
a BatchNorm, which the norm's mean removes, moves its entry by the whole
rate either way.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import nnx
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from pytorch_points_tpu import parallel as jpar
from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.layers import SharedMLP as JaxSharedMLP
from pytorch_points_tpu.models import PointCloudAutoencoder as JaxAutoencoder
from pytorch_points_tpu.ops import chamfer_distance as jax_chamfer
from pytorch_points_tpu.ops.interpolate import interpolation_weights
from pytorch_points_tpu_torch import parallel
from torch_parallel_ranks import LR, NPOINT1, NPOINT2, STEPS, WORLD, inputs
from torch_parallel_ranks import Ranks

DATA = inputs()


def _mesh(axis):
    return Mesh(np.asarray(jax.devices()[:WORLD]), (axis,))


class _Tiny(nnx.Module):
    """The reference's BatchNorm train-step model
    (tests/test_models_parallel.py)."""

    def __init__(self, rngs):
        self.mlp = JaxSharedMLP([3, 16, 3], norm="batch", act_last=False,
                                rngs=rngs)

    def __call__(self, x):
        return self.mlp(x)


def _pure(model, kind=nnx.Param):
    return jax.tree.map(np.asarray, nnx.to_pure_dict(nnx.state(model, kind)))


@pytest.fixture(scope="module")
def jax_models():
    ae = nnx.jit(lambda: JaxAutoencoder(npoint1=NPOINT1, npoint2=NPOINT2,
                                        rngs=nnx.Rngs(0)))()
    tiny = _Tiny(nnx.Rngs(0))
    return ae, tiny


@pytest.fixture(scope="module")
def started(jax_models, tmp_path_factory):
    """The ranks, started; they run while the JAX side computes."""
    ae, tiny = jax_models
    weights = {"autoencoder": _pure(ae),
               "bn": (_pure(tiny.mlp), _pure(tiny.mlp, nnx.BatchStat))}
    ranks = Ranks(tmp_path_factory.mktemp("ranks"), weights)
    yield ranks
    ranks.stop()


def _cat(ranks, case, i, axis=1):
    """Output ``i`` of ``case`` assembled from the ranks' shards."""
    return np.concatenate([r[case][i] for r in ranks], axis)


def _same(ranks, case, i):
    """A replicated output: equal on every rank; rank 0's."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[case][i], ranks[0][case][i])
    return ranks[0][case][i]


def _eq(got, want):
    np.testing.assert_array_equal(got, np.asarray(want))


def _close_sum(got, want):
    """A gradient summed over ranks."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The JAX side, computed while the ranks run
# ---------------------------------------------------------------------------


def _sharded_ops():
    """The reference's sharded ops on the 4-device points mesh, under
    ``force_impl("pallas")``: {case: outputs}."""
    mesh = _mesh("points")
    out = {}
    c = DATA["nn"]
    out["nn"] = jpar.nndistance_sharded(c["p"], c["q"], mesh)
    # the chamfer's value from the sharded op; its gradient from the
    # one-device chamfer's rule along the matched pairs (the sharded op is
    # differentiable only where its NN scan is XLA, whose min splits a
    # tie's gradient between the tied points)
    c = DATA["chamfer"]
    out["chamfer"] = (jpar.chamfer_sharded(c["p"], c["q"], mesh),
                      *jax.jit(jax.grad(jax_chamfer, (0, 1)))(
                          jnp.asarray(c["p"]), jnp.asarray(c["q"])))
    for case in ("ring", "ring_ties"):
        c = DATA[case]
        out[case] = jpar.nndistance_ring(c["p"], c["q"], mesh)
    c = DATA["fps"]
    out["fps"] = [jpar.furthest_point_sample_sharded(c["xyz"], 16, mesh,
                                                     mask=m)
                  for m in (None, jnp.asarray(c["mask"]))]
    c = DATA["bq"]
    out["bq"] = [jpar.ball_query_sharded(c["xyz"], c["cen"], 0.8, 8, mesh,
                                         mask=m)
                 for m in (None, jnp.asarray(c["mask"]))]
    c = DATA["group"]

    def group_loss(f):
        g = jpar.group_points_sharded(f, c["idx"], mesh)
        return jnp.sum(g * c["w"]), g

    (_, g), grad = jax.jit(jax.value_and_grad(group_loss, has_aux=True))(
        jnp.asarray(c["feats"]))
    out["group"] = (g, grad)
    c = DATA["interp"]
    d, i = jpar.three_nn_sharded(c["unknown"], c["known"], mesh)
    w = interpolation_weights(d)

    def interp_loss(f):
        o = jpar.three_interpolate_sharded(f, i, w, mesh)
        return jnp.sum(o * c["w"]), o

    (_, o), grad = jax.jit(jax.value_and_grad(interp_loss, has_aux=True))(
        jnp.asarray(c["feats"]))
    out["interp"] = (d, i, o, grad)
    c = DATA["emd"]
    out["emd"] = []
    for kw in ({}, dict(p_mask=c["mask"], q_mask=c["mask"])):
        def emd_loss(p, q, kw=kw):
            d, a = jpar.earth_mover_distance_sharded(p, q, mesh, eps=0.01,
                                                     max_iters=45, **kw)
            return jnp.sum(d * c["w"]), (d, a)

        (_, (d, a)), (gp, gq) = jax.jit(jax.value_and_grad(
            emd_loss, (0, 1), has_aux=True))(jnp.asarray(c["p"]),
                                             jnp.asarray(c["q"]))
        out["emd"] += [d, a, gp, gq]
    c = DATA["knn"]
    out["knn"] = [jpar.knn_sharded(c["q"], c["s"], 8, mesh, support_mask=m)
                  for m in (None, c["mask"])]
    c = DATA["sag"]
    out["sag"] = []
    for kw in ({}, dict(normalize_radius=True, mask=jnp.asarray(c["mask"]))):
        def sag_loss(x, feats, kw=kw):
            o = jpar.sample_and_group_sharded(x, feats, 16, 8, 0.8, mesh,
                                              **kw)
            return jnp.sum(o[1] * c["w"]) + jnp.sum(o[0] ** 2), o

        (_, o), grads = jax.jit(jax.value_and_grad(
            sag_loss, (0, 1), has_aux=True))(jnp.asarray(c["xyz"]),
                                             jnp.asarray(c["feats"]))
        out["sag"] += [*o, *grads]
    return out


def _train_steps(ae, tiny):
    """The JAX step's losses and parameters after each step on the
    4-device data mesh, for the autoencoder (Chamfer) and the BatchNorm
    model, both with SGD."""
    mesh = _mesh("data")
    loss_fn = jpar.reconstruction_loss(emd_weight=0.0)
    step, state = jpar.make_train_step(ae, optax.sgd(LR), mesh, loss_fn,
                                       donate=False)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    losses, params = [], []
    for pts in DATA["train"]["points"]:
        state, loss = step(state, {"points": jnp.asarray(pts)})
        losses.append(float(loss))
        params.append(jax.tree.map(np.asarray, nnx.to_pure_dict(
            state.params)))

    def bn_loss(m, batch):
        return jnp.mean((m(batch["points"]) - batch["points"]) ** 2)

    step, state = jpar.make_train_step(tiny, optax.sgd(LR), mesh, bn_loss,
                                       donate=False)
    state, loss = step(state, {"points": jnp.asarray(DATA["bn"]["points"])})
    bn = (float(loss), jax.tree.map(np.asarray, nnx.to_pure_dict(
        state.params)), jax.tree.map(np.asarray, nnx.to_pure_dict(
            state.rest)))
    return losses, params, bn


@pytest.fixture(scope="module")
def want(jax_models, started):
    """Every JAX result, under ``force_impl("pallas")`` (the XLA NN scan
    picks other near-tie winners: one flipped pair in the train steps'
    Chamfer moves a parameter by 1e-4 of itself); ``started`` first, so
    the ranks run meanwhile."""
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    try:
        out = _sharded_ops()
        out["train"] = _train_steps(*jax_models)
    finally:
        jax_dispatch.force_impl(None)
        jax.clear_caches()
    return out


# ---------------------------------------------------------------------------
# The sharded ops
# ---------------------------------------------------------------------------


def test_nndistance_sharded_matches_jax(started, want):
    ranks, w = started.results, want["nn"]
    for i in (0, 1):  # direction 1: replicated
        _eq(_same(ranks, "nn", i), w[i])
    for i in (2, 3):  # direction 2: sharded like q
        _eq(_cat(ranks, "nn", i), w[i])


def test_chamfer_sharded_matches_jax(started, want):
    ranks, (val, gp, gq) = started.results, want["chamfer"]
    np.testing.assert_allclose(_same(ranks, "chamfer", 0), val, rtol=1e-6)
    _close_sum(_same(ranks, "chamfer", 1), gp)
    _close_sum(_cat(ranks, "chamfer", 2), gq)


@pytest.mark.parametrize("case", ["ring", "ring_ties"])
def test_nndistance_ring_matches_jax(started, want, case):
    for i in range(4):
        _eq(_cat(started.results, case, i), want[case][i])


@pytest.mark.parametrize("masked", [False, True])
def test_fps_sharded_matches_jax(started, want, masked):
    _eq(_same(started.results, "fps", int(masked)), want["fps"][masked])


@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_sharded_matches_jax(started, want, masked):
    for i in range(2):
        _eq(_cat(started.results, "bq", 2 * masked + i), want["bq"][masked][i])


def test_group_points_sharded_values_and_grads(started, want):
    ranks, (g, grad) = started.results, want["group"]
    _eq(_cat(ranks, "group", 0), g)
    _close_sum(_same(ranks, "group", 1), grad)


def test_three_nn_interpolate_sharded_matches_jax(started, want):
    ranks, (d, i, out, grad) = started.results, want["interp"]
    _eq(_cat(ranks, "interp", 0), d)
    _eq(_cat(ranks, "interp", 1), i)
    np.testing.assert_allclose(_cat(ranks, "interp", 2), out, rtol=1e-6,
                               atol=1e-6)
    _close_sum(_same(ranks, "interp", 3), grad)


@pytest.mark.parametrize("masked", [False, True])
def test_emd_sharded_matches_jax(started, want, masked):
    ranks = started.results
    o = 4 * masked
    d, a, gp, gq = want["emd"][o:o + 4]
    _eq(_same(ranks, "emd", o + 1), a)
    _eq(_same(ranks, "emd", o), d)
    np.testing.assert_allclose(_same(ranks, "emd", o + 2), gp, rtol=1e-6)
    np.testing.assert_allclose(_cat(ranks, "emd", o + 3), gq, rtol=1e-6)
    if masked:
        assert (_same(ranks, "emd", o)[:, 48:] == 0).all()
        assert (_same(ranks, "emd", o + 2)[:, 48:] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_knn_sharded_matches_jax(started, want, masked):
    for i in range(2):
        _eq(_cat(started.results, "knn", 2 * masked + i),
            want["knn"][masked][i])


@pytest.mark.parametrize("variant", ["plain", "masked_normalized"])
def test_sample_and_group_sharded_matches_jax(started, want, variant):
    ranks = started.results
    o = 0 if variant == "plain" else 6
    w = want["sag"][o:o + 6]
    _eq(_same(ranks, "sag", o), w[0])
    for i in (1, 2, 3):
        _eq(_cat(ranks, "sag", o + i), w[i])
    _close_sum(_cat(ranks, "sag", o + 4), w[4])
    _close_sum(_cat(ranks, "sag", o + 5), w[5])


def test_unequal_shards_raise(started):
    """M = 10 over 4 ranks (shards 3, 3, 2, 2): every rank raises."""
    for r in started.results:
        assert "needs equal shards" in r["unequal"], r["unequal"]


def test_make_mesh_needs_the_world_size():
    """Outside a process group the world is one rank: a 4-rank mesh
    raises, as the reference's does on too few devices."""
    if "WORLD_SIZE" in os.environ:
        pytest.skip("a launcher set WORLD_SIZE")
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        parallel.make_mesh({"points": 4}, device_type="cpu")


# ---------------------------------------------------------------------------
# The data-parallel step and the Trainer against the JAX step on 4 devices
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flat(v, path + "/")
        else:
            yield path, np.asarray(v)


def _port_name(path):
    """JAX parameter path -> the port's state_dict key, and whether the
    value is transposed there."""
    mod, leaf = path.rsplit("/", 1)
    key = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}.get(leaf, leaf)
    return mod.replace("/", ".") + "." + key, leaf == "kernel"


def _match_params(state, jax_tree, init=None):
    """The port's state_dict against a JAX tree: each entry to rtol 1e-5;
    with ``init`` (the JAX tree before the steps), each entry's update to
    1e-4 of the tensor's largest update or one ulp of the entry, the
    finest an update of a float32 parameter can be told."""
    start = dict(_flat(init)) if init is not None else {}
    for path, value in _flat(jax_tree):
        key, transpose = _port_name(path)
        got = state[key].T if transpose else state[key]
        if path in start:
            step = value - start[path]
            bar = np.maximum(1e-4 * np.abs(step).max(), np.spacing(value))
            bad = np.abs(got - value) > bar
            assert not bad.any(), (key, got[bad], value[bad], bar[bad])
        else:
            np.testing.assert_allclose(got, value, rtol=1e-5, atol=1e-7,
                                       err_msg=key)


def _every_rank_equal(ranks, name):
    for r in ranks[1:]:
        for k, v in r["train"][name][-1].items():
            np.testing.assert_array_equal(v, ranks[0]["train"][name][-1][k])


def test_data_parallel_step_matches_jax(started, want, jax_models):
    """Two steps. After the first the parameters differ in their last
    bits; the second step's gradient, about 10 for the first layer's bias
    at this rate, carries that into its update: held to 1e-4 of it."""
    losses, params, _ = want["train"]
    ranks = started.results
    got, state = ranks[0]["train"]["remat=False"]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    _every_rank_equal(ranks, "remat=False")
    _match_params(state, params[-1], init=_pure(jax_models[0]))


def test_data_parallel_remat_matches_jax(started, want):
    """remat=True: the same loss and update as the reference's step."""
    losses, params, _ = want["train"]
    ranks = started.results
    got, state = ranks[0]["train"]["remat=True"]
    np.testing.assert_allclose(got[0], losses[0], rtol=1e-5)
    _every_rank_equal(ranks, "remat=True")
    _match_params(state, params[0])


def test_data_parallel_batchnorm_matches_jax(started, want):
    """The running statistics are averaged over the ranks, as the
    reference's step pmeans its BatchStats."""
    loss, jparams, jstats = want["train"][2]
    ranks = started.results
    got, state = ranks[0]["train"]["bn"]
    np.testing.assert_allclose(got, loss, rtol=1e-5)
    _every_rank_equal(ranks, "bn")
    _match_params(state, jparams["mlp"])
    _match_params(state, jstats["mlp"])
    assert not np.allclose(state["norms.0.running_mean"], 0.0)


def test_trainer_mesh_matches_jax(started, want, jax_models):
    """The Trainer on the 4-rank mesh: the JAX step's losses at every log
    point on every rank, one checkpoint (rank 0's) that every rank
    restores."""
    losses, params, _ = want["train"]
    ranks = started.results
    for r in ranks:
        logged, last, files, state = r["train"]["trainer"]
        np.testing.assert_allclose(logged, losses, rtol=1e-5)
        assert last == logged[-1] and files == [str(STEPS)]
        _match_params(state, params[-1], init=_pure(jax_models[0]))
    _every_rank_equal(ranks, "trainer")
