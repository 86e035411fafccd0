"""The port's autograd Functions, the FPS + group + chamfer headline loss and
the config-5 train step (without its EMD term) against the JAX package.

The JAX side runs under ``force_impl("pallas")`` (Pallas kernels in
interpret mode, jit caches cleared around it) with ``jax.value_and_grad``
/ ``nnx.value_and_grad``; the port runs its plain PyTorch versions on the
CPU. Inputs and weights come from numpy with a seed (the model's weights
are the JAX model's, carried across by ``load_jax_params``).

Tolerances: indices exactly equal; values rtol 1e-5 (1e-6 for the loss
alone); gradients atol GRAD_TOL * max|g_ref| per tensor. The JAX backward
scatters through its bf16-split Pallas kernel whenever it has 4096 updates
or more (~2^-16 relative error per update) and sums in another order; the
model's LayerNorm statistics round differently in flax (mean of squares)
and in torch (two-pass), about 1e-6 relative in the forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_points_tpu.kernels import ballquery as jax_bq
from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.models import PointCloudAutoencoder as JaxAutoencoder
from pytorch_points_tpu.ops import chamfer as jax_chamfer
from pytorch_points_tpu.ops import grouping as jax_grouping
from pytorch_points_tpu.ops import interpolate as jax_interp
from pytorch_points_tpu.ops import sampling as jax_sampling
from pytorch_points_tpu_torch.compat import load_jax_params
from pytorch_points_tpu_torch.compat.jax_params import _flatten
from pytorch_points_tpu_torch.models import PointCloudAutoencoder
from pytorch_points_tpu_torch.ops import (
    ball_query,
    chamfer,
    chamfer_distance,
    furthest_point_sample_and_gather,
    gather_points,
    group_points,
    interpolation_weights,
    knn,
    scatter_add,
    three_interpolate,
    three_nn,
)
from pytorch_points_tpu_torch.parallel import (
    make_train_step,
    reconstruction_loss,
)
from torch_inputs import autoencoder_inputs, cloud, valid_mask

GRAD_TOL = 2.0**-13
RTOL = 1e-5


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def pallas():
    """Force the JAX package onto its Pallas kernels (interpret mode) for
    the whole module: the jit caches are cleared on the way in and out, so
    every trace in between sees the forced route."""
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


def _assert_grads(got, ref):
    for g, r in zip(got, ref, strict=True):
        r = np.asarray(r)
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max())


def _compare(jax_fn, port_fn, arrays, argnums, weights):
    """sum(out_i * w_i) of both sides: values, then grads wrt ``argnums``."""

    def jloss(*xs):
        outs = jax_fn(*xs)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    rv, rg = jax.value_and_grad(jloss, argnums)(*map(jnp.asarray, arrays))
    ts = [_t(a) for a in arrays]
    for i in argnums:
        ts[i].requires_grad_()
    outs = port_fn(*ts)
    value = sum((o * _t(w)).sum() for o, w in zip(outs, weights))
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=RTOL)
    _assert_grads([ts[i].grad for i in argnums], rg)


def _weights(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# Each Function's gradient against the JAX custom_vjp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [3, 32])
def test_gather_points_grad(c):
    rng = np.random.default_rng(20)
    f = rng.standard_normal((2, 300, c)).astype(np.float32)
    idx = rng.integers(0, 300, (2, 4096)).astype(np.int32)
    _compare(lambda f, i: (jax_sampling.gather_points(f, i),),
             lambda f, i: (gather_points(f, i),),
             [f, idx], (0,), _weights(rng, (2, 4096, c)))


def test_scatter_add_grad():
    rng = np.random.default_rng(21)
    target = _t(rng.standard_normal((2, 50, 4)).astype(np.float32))
    upd = _t(rng.standard_normal((2, 300, 4)).astype(np.float32))
    idx = _t(rng.integers(0, 50, (2, 300)).astype(np.int32))
    target.requires_grad_()
    upd.requires_grad_()
    out = scatter_add(target, idx, upd)
    w = _t(rng.standard_normal((2, 50, 4)).astype(np.float32))
    (out * w).sum().backward()
    want = torch.zeros_like(w)
    for b in range(2):
        want[b].index_add_(0, idx[b].long(), upd[b].detach())
    assert torch.equal(out.detach(), target.detach() + want)
    assert torch.equal(target.grad, w)
    assert torch.equal(upd.grad, w.gather(1, idx.long()[..., None]
                                          .expand(-1, -1, 4)))


@pytest.mark.parametrize("masked", [False, True])
def test_fps_emitted_coords_grad(masked):
    rng = np.random.default_rng(22)
    xyz = cloud(rng, 2, 500)
    mask = valid_mask(rng, 2, 500) if masked else None
    (w,) = _weights(rng, (2, 96, 3))

    def jfn(x):
        coords, idx = jax_sampling.furthest_point_sample_and_gather(
            x, 96, mask=None if mask is None else jnp.asarray(mask))
        return (coords,)

    def tfn(x):
        coords, idx = furthest_point_sample_and_gather(x, 96, mask=_t(mask))
        assert idx.dtype == torch.int32 and not idx.requires_grad
        return (coords,)

    _compare(jfn, tfn, [xyz], (0,), [w])


def test_group_points_grad():
    rng = np.random.default_rng(23)
    f = rng.standard_normal((2, 400, 16)).astype(np.float32)
    idx = rng.integers(0, 400, (2, 128, 32)).astype(np.int32)
    _compare(lambda f, i: (jax_grouping.group_points(f, i),),
             lambda f, i: (group_points(f, i),),
             [f, idx], (0,), _weights(rng, (2, 128, 32, 16)))


@pytest.mark.parametrize("masked", [False, True])
def test_knn_grad(masked):
    rng = np.random.default_rng(24)
    q, s = cloud(rng, 2, 1400), cloud(rng, 2, 300)
    mask = valid_mask(rng, 2, 300) if masked else None

    def jfn(q, s):
        d, i = jax_grouping.knn(q, s, 3, support_mask=None if mask is None
                                else jnp.asarray(mask))
        return (d,)

    def tfn(q, s):
        d, i = knn(q, s, 3, support_mask=_t(mask))
        ref_i = jax_grouping.knn(jnp.asarray(q.detach().numpy()),
                                 jnp.asarray(s.detach().numpy()), 3,
                                 support_mask=None if mask is None
                                 else jnp.asarray(mask))[1]
        np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
        return (d,)

    _compare(jfn, tfn, [q, s], (0, 1), _weights(rng, (2, 1400, 3)))


def test_three_interpolate_grad():
    # The FP path: grads into the low-res features and, through the
    # inverse-distance weights and three_nn's distances, both clouds.
    rng = np.random.default_rng(25)
    hi, lo = cloud(rng, 2, 1400), cloud(rng, 2, 128)
    f = rng.standard_normal((2, 128, 24)).astype(np.float32)

    def jfn(hi, lo, f):
        d, i = jax_interp.three_nn(hi, lo)
        return (jax_interp.three_interpolate(
            f, i, jax_interp.interpolation_weights(d)),)

    def tfn(hi, lo, f):
        d, i = three_nn(hi, lo)
        return (three_interpolate(f, i, interpolation_weights(d)),)

    _compare(jfn, tfn, [hi, lo, f], (0, 1, 2), _weights(rng, (2, 1400, 24)))


# ---------------------------------------------------------------------------
# The headline loss (bench.py) at a CPU size
# ---------------------------------------------------------------------------

B, N, P, RADIUS, NSAMPLE = 2, 1024, 128, 0.2, 32


def _headline_jax(pred, gt, reg_weight):
    cen, _ = jax_sampling.furthest_point_sample_and_gather(pred, P)
    nidx, _ = jax_bq.ball_query(pred, cen, RADIUS, NSAMPLE)
    centered = jax_grouping.group_points(pred, nidx) - cen[:, :, None, :]
    return (jax_chamfer.chamfer_distance(pred, gt)
            + reg_weight * jnp.mean(centered**2))


def _headline_port(pred, gt, reg_weight):
    cen, _ = furthest_point_sample_and_gather(pred, P)
    nidx, _ = ball_query(pred, cen, RADIUS, NSAMPLE)
    centered = group_points(pred, nidx) - cen[:, :, None, :]
    return chamfer_distance(pred, gt) + reg_weight * (centered**2).mean()


@pytest.mark.parametrize("reg_weight", [1e-6, 1.0])
def test_headline_value_and_grad(monkeypatch, reg_weight):
    monkeypatch.setattr(jax_chamfer, "_SORTED_MIN_POINTS", 512)
    monkeypatch.setattr(chamfer, "_SORTED_MIN_POINTS", 512)
    rng = np.random.default_rng(26)
    gt = cloud(rng, B, N)
    pred = (rng.uniform(-1, 1, (B, N, 3)) * 0.98 + 0.01).astype(np.float32)
    assert jax_chamfer.chamfer_path(pred, gt, reduction="mean") == (
        "sorted_loss")
    assert chamfer.chamfer_path(_t(pred), _t(gt), reduction="mean") == (
        "sorted_loss")
    rv, rg = jax.value_and_grad(_headline_jax)(jnp.asarray(pred),
                                               jnp.asarray(gt), reg_weight)
    x = _t(pred).requires_grad_()
    value = _headline_port(x, _t(gt), reg_weight)
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=1e-6)
    _assert_grads([x.grad], [rg])


# ---------------------------------------------------------------------------
# Config 5 without its EMD term: PointCloudAutoencoder + chamfer + Adam
# ---------------------------------------------------------------------------


def _port_grads(model):
    """JAX-style paths -> grads, Linear weights transposed back to [in,out]."""
    out = {}
    for name, module in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(module, torch.nn.Linear):
            out[f"{path}/kernel"] = module.weight.grad.T
            out[f"{path}/bias"] = module.bias.grad
        elif isinstance(module, torch.nn.LayerNorm):
            out[f"{path}/scale"] = module.weight.grad
            out[f"{path}/bias"] = module.bias.grad
    return out


def test_config5_without_emd_matches_jax_and_trains():
    xyz, _ = autoencoder_inputs(masked=False, b=2, n=512)
    jmodel = JaxAutoencoder(npoint1=128, npoint2=32, rngs=nnx.Rngs(0))
    tree = jax.tree.map(np.asarray,
                        nnx.to_pure_dict(nnx.state(jmodel, nnx.Param)))

    def jloss(m):
        x = jnp.asarray(xyz)
        return jax_chamfer.chamfer_distance(m(x), x)

    rv, rgrads = nnx.value_and_grad(jloss)(jmodel)
    ref = {k: np.asarray(v)
           for k, v in _flatten(nnx.to_pure_dict(rgrads))}

    port = PointCloudAutoencoder(npoint1=128, npoint2=32)
    load_jax_params(port, tree)
    loss_fn = reconstruction_loss()
    batch = {"points": _t(xyz)}
    value = loss_fn(port, batch)
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=RTOL)
    got = _port_grads(port)
    assert got.keys() == ref.keys()
    for path in sorted(ref):
        r = ref[path]
        np.testing.assert_allclose(got[path].numpy(), r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=path)

    before = [p.detach().clone() for p in port.parameters()]
    step = make_train_step(port, torch.optim.Adam(port.parameters(), 1e-3),
                           loss_fn)
    losses = [step(batch).item() for _ in range(3)]
    assert np.isfinite(losses).all()
    assert all(not torch.equal(b, a) for b, a in zip(before,
                                                     port.parameters()))


def test_reconstruction_loss_refuses_emd():
    with pytest.raises(NotImplementedError, match="EMD"):
        reconstruction_loss(emd_weight=0.1)
