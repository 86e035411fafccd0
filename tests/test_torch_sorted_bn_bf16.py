"""The port's remaining model surface against the JAX package: the
Morton-consistent SA front half (``sample_and_group_sorted`` and
``PointNetSAModule(sorted_pipeline=True)``), flax's BatchNorm
(``norm="batch"``), the bf16 ``dtype`` policy (with the gather's bf16
instance and the kNN's bf16 input) and rematerialisation.

Weights come from the JAX modules through ``load_jax_params``; inputs from
numpy with a seed. The JAX side runs its Pallas kernels in interpret mode
(``force_impl("pallas")``) and is jitted whole; the port runs its plain
PyTorch versions on the CPU.

Tolerances:
  * ``sample_and_group_sorted``: all five outputs bitwise; the sorted SA
    module's pooled features within 2e-5 under the centroid permutation
    (the reference's own test's bar);
  * BatchNorm, float32: outputs and grads atol 1e-5, running statistics
    atol 1e-6 after two SGD steps (reduction order only);
  * bf16: outputs within BF16_TOL of each tensor's largest magnitude, two
    bf16 units in the last place (2^-7): one rounding of a different
    float32 accumulation order, and a second where an ulp flip passes
    through the next layer; grads at fixed bars set from gaps measured over
    24 seeds (``_hold_bf16_grads``); the gather's bf16 plain version and
    its backward bitwise, the bf16 kNN's indices identical;
  * remat: losses and grads equal to ``remat=False`` within rtol 1e-6 (the
    reference's ``test_train_step_remat_matches``), BatchNorm's running
    statistics bitwise equal after one step each way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.layers import DenseEdgeConv as JaxDenseEdgeConv
from pytorch_points_tpu.layers import PointNetFPModule as JaxFP
from pytorch_points_tpu.layers import PointNetSAModule as JaxSA
from pytorch_points_tpu.layers import SharedMLP as JaxSharedMLP
from pytorch_points_tpu.ops import group_points as jax_group_points
from pytorch_points_tpu.ops import knn as jax_knn
from pytorch_points_tpu.ops import sample_and_group_sorted as jax_sgs
from pytorch_points_tpu_torch.compat import load_jax_params
from pytorch_points_tpu_torch.compat.jax_params import _flatten
from pytorch_points_tpu_torch.kernels.gather import gather_rows_torch
from pytorch_points_tpu_torch.layers import (
    DenseEdgeConv,
    PointNetFPModule,
    PointNetSAModule,
    SharedMLP,
)
from pytorch_points_tpu_torch.layers.blocks import BatchNorm
from pytorch_points_tpu_torch.models import PointCloudAutoencoder
from pytorch_points_tpu_torch.ops import (
    group_points,
    knn,
    sample_and_group_sorted,
)
from pytorch_points_tpu_torch.parallel import (
    make_train_step,
    reconstruction_loss,
)
from pytorch_points_tpu_torch.utils import Trainer

BF16_TOL = 2.0**-7
BF16_GRAD_BAR_MLP, BF16_GRAD_BAR_PAIR = 2.0**-5, 2.0**-4
BN_ATOL, STAT_ATOL = 1e-5, 1e-6
LR = 0.1


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module", autouse=True)
def pallas():
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


def _params(model):
    return jax.tree.map(np.asarray,
                        nnx.to_pure_dict(nnx.state(model, nnx.Param)))


def _stats(model):
    return jax.tree.map(np.asarray,
                        nnx.to_pure_dict(nnx.state(model, nnx.BatchStat)))


def _port_grads(model):
    """JAX-style paths -> grads, Linear weights transposed to [in, out]."""
    out = {}
    for name, m in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(m, torch.nn.Linear):
            out[f"{path}/kernel"] = m.weight.grad.T
            out[f"{path}/bias"] = m.bias.grad
        elif isinstance(m, (torch.nn.LayerNorm, BatchNorm)):
            out[f"{path}/scale"] = m.weight.grad
            out[f"{path}/bias"] = m.bias.grad
    return {k: v.numpy() for k, v in out.items()}


def _cloud(seed, b, n):
    return np.random.default_rng(seed).uniform(-1, 1, (b, n, 3)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# sample_and_group_sorted and the sorted SA module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("features,use_xyz,normalize", [
    (0, True, False), (5, True, True), (5, False, False)])
def test_sample_and_group_sorted_bitwise(features, use_xyz, normalize):
    rng = np.random.default_rng(30)
    xyz = rng.uniform(-1, 1, (2, 512, 3)).astype(np.float32)
    f = (rng.standard_normal((2, 512, features)).astype(np.float32)
         if features else None)
    ref = jax.jit(lambda a, b: jax_sgs(
        a, b, 64, 16, 0.3, use_xyz=use_xyz, normalize_radius=normalize))(
            xyz, f)
    got = sample_and_group_sorted(_t(xyz), _t(f), 64, 16, 0.3,
                                  use_xyz=use_xyz,
                                  normalize_radius=normalize)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), r)


def test_sa_module_sorted_pipeline_pooled_matches_jax():
    """The sorted SA module against the JAX one (same weights), and its
    pooled features against the unsorted port module's under the centroid
    permutation, the reference's own check (nsample large enough that no
    ball saturates)."""
    xyz = _cloud(31, 2, 512)
    kw = dict(npoint=64, radius=0.25, nsample=48, norm=None)
    jsa = JaxSA(0, [16, 32], rngs=nnx.Rngs(0), sorted_pipeline=True, **kw)
    sas = PointNetSAModule(0, [16, 32], sorted_pipeline=True, device="cpu",
                           **kw)
    sa0 = PointNetSAModule(0, [16, 32], device="cpu", **kw)
    load_jax_params(sas, _params(jsa))
    load_jax_params(sa0, _params(jsa))
    rx, rf = nnx.jit(lambda m, x: m(x))(jsa, jnp.asarray(xyz))
    with torch.no_grad():
        nxs, fs = sas(_t(xyz))
        nx0, f0 = sa0(_t(xyz))
    np.testing.assert_array_equal(nxs.numpy(), np.asarray(rx))
    np.testing.assert_allclose(fs.numpy(), np.asarray(rf), rtol=0, atol=2e-5)
    nxs, fs, nx0, f0 = map(np.asarray, (nxs, fs, nx0, f0))
    for b in range(2):
        key0 = {tuple(r): i for i, r in enumerate(nx0[b].round(6).tolist())}
        perm = [key0[tuple(r)] for r in nxs[b].round(6).tolist()]
        np.testing.assert_allclose(fs[b], f0[b][perm], atol=2e-5)


def test_sorted_pipeline_only_for_unmasked_radius_grouping():
    xyz = _t(_cloud(32, 1, 256))
    mask = torch.ones((1, 256), dtype=torch.bool)
    kw = dict(npoint=16, radius=0.3, nsample=8, norm=None, device="cpu")
    sas = PointNetSAModule(0, [8], sorted_pipeline=True, **kw)
    sa0 = PointNetSAModule(0, [8], **kw)
    with torch.no_grad():
        # a mask takes sample_and_group: centroids in FPS order
        assert torch.equal(sas(xyz, mask=mask)[0], sa0(xyz, mask=mask)[0])
        assert not torch.equal(sas(xyz)[0], sa0(xyz)[0])


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------


def _bn_step_jax(model, x):
    def loss(m):
        y = m(x)
        return jnp.mean(y * y), y

    (value, y), grads = nnx.value_and_grad(loss, has_aux=True)(model)
    params = nnx.state(model, nnx.Param)
    nnx.update(model, jax.tree.map(lambda p, g: p - LR * g, params, grads))
    return value, y, grads


def test_shared_mlp_batchnorm_matches_flax():
    """Two SGD steps of SharedMLP(norm="batch") on [B,P,S,C] inputs:
    outputs, grads and the running statistics after each, then the eval
    forward on the running statistics; flax's biased-variance update."""
    rng = np.random.default_rng(33)
    xs = [rng.standard_normal((2, 16, 8, 6)).astype(np.float32) * 2 + 0.5
          for _ in range(2)]
    jm = JaxSharedMLP([6, 16, 8], norm="batch", rngs=nnx.Rngs(0))
    port = SharedMLP([6, 16, 8], norm="batch", device="cpu")
    load_jax_params(port, _params(jm), _stats(jm))
    step = nnx.jit(_bn_step_jax)
    opt = torch.optim.SGD(port.parameters(), LR)
    for x in xs:
        rv, ry, rg = step(jm, jnp.asarray(x))
        opt.zero_grad(set_to_none=True)
        y = port(_t(x))
        value = (y * y).mean()
        value.backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry),
                                   rtol=0, atol=BN_ATOL)
        np.testing.assert_allclose(value.item(), float(rv), rtol=1e-5)
        ref = dict(_flatten(nnx.to_pure_dict(rg)))
        got = _port_grads(port)
        assert got.keys() == ref.keys()
        for path in ref:
            np.testing.assert_allclose(got[path], np.asarray(ref[path]),
                                       rtol=0, atol=BN_ATOL, err_msg=path)
        opt.step()
        stats = dict(_flatten(_stats(jm)))
        for name, m in port.named_modules():
            if isinstance(m, BatchNorm):
                path = name.replace(".", "/")
                np.testing.assert_allclose(m.running_mean.numpy(),
                                           stats[f"{path}/mean"], rtol=0,
                                           atol=STAT_ATOL)
                np.testing.assert_allclose(m.running_var.numpy(),
                                           stats[f"{path}/var"], rtol=0,
                                           atol=STAT_ATOL)
    jm.eval()
    port.eval()
    ref = np.asarray(nnx.jit(lambda m, x: m(x))(jm, jnp.asarray(xs[0])))
    with torch.no_grad():
        out = port(_t(xs[0]))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=BN_ATOL)


def test_batchnorm_keeps_the_biased_variance():
    """The running variance takes the biased batch variance (flax), not
    torch's unbiased one; momentum 0.9, eps 1e-5."""
    bn = BatchNorm(3)
    x = torch.tensor([[0.0, 1.0, 2.0], [2.0, 3.0, 6.0]])
    bn(x)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.1 * x.mean(0).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * x.var(0, unbiased=False).numpy(),
                               rtol=1e-6)


def test_load_jax_params_takes_batch_stats_either_way():
    jm = JaxSharedMLP([4, 8, 8], norm="batch", rngs=nnx.Rngs(1))
    x = jnp.asarray(np.random.default_rng(34).standard_normal((3, 5, 4)),
                    jnp.float32)
    nnx.jit(lambda m, v: m(v))(jm, x)  # move the running statistics
    both = jax.tree.map(np.asarray, nnx.to_pure_dict(
        nnx.state(jm, (nnx.Param, nnx.BatchStat))))
    ports = [SharedMLP([4, 8, 8], norm="batch", device="cpu")
             for _ in range(2)]
    load_jax_params(ports[0], _params(jm), _stats(jm))
    load_jax_params(ports[1], both)
    stats = dict(_flatten(_stats(jm)))
    for port in ports:
        np.testing.assert_array_equal(
            port.norms[1].running_var.numpy(), stats["norms/1/var"])
        np.testing.assert_array_equal(
            port.norms[0].weight.detach().numpy(),
            dict(_flatten(_params(jm)))["norms/0/scale"])
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(ports[0], _params(jm))  # no statistics
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(SharedMLP([4, 8, 8], device="cpu"), both)


# ---------------------------------------------------------------------------
# the bf16 policy
# ---------------------------------------------------------------------------


def test_gather_plain_bf16_bitwise_equals_group_points():
    rng = np.random.default_rng(35)
    f = jnp.asarray(rng.standard_normal((2, 64, 128)), jnp.bfloat16)
    idx = rng.integers(0, 64, (2, 16, 8)).astype(np.int32)
    ref = np.asarray(jax.jit(jax_group_points)(f, idx))
    ft = _t(_f32(f)).to(torch.bfloat16)
    got = group_points(ft, _t(idx))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))
    direct = gather_rows_torch(ft, _t(idx).reshape(2, -1))
    assert torch.equal(direct, got.reshape(2, -1, 128))


@pytest.mark.parametrize("c", [3, 24])
def test_knn_bf16_indices_match_pallas(c):
    """bf16 query/support: the Pallas scan casts to f32 at entry, and so
    does the port, so the indices are those of the f32 call on the cast
    values."""
    rng = np.random.default_rng(36)
    x = jnp.asarray(rng.standard_normal((2, 256, c)), jnp.bfloat16)
    _, ridx = jax.jit(lambda a: jax_knn(a, a, 9))(x)
    xt = _t(_f32(x)).to(torch.bfloat16)
    d, idx = knn(xt, xt, 9)
    assert d.dtype == torch.float32
    d32, idx32 = knn(xt.float(), xt.float(), 9)
    assert torch.equal(idx, idx32) and torch.equal(d, d32)
    if c == 3:  # the reference's Pallas scan reads three channels
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))


def _bf16_close(got, ref):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=BF16_TOL * np.abs(ref).max())


def test_shared_mlp_bf16_matches_flax():
    x = np.random.default_rng(37).standard_normal((2, 32, 8, 6)).astype(
        np.float32)
    for norm in ("layer", "batch", None):
        jm = JaxSharedMLP([6, 32, 16], norm=norm, dtype=jnp.bfloat16,
                          rngs=nnx.Rngs(0))
        port = SharedMLP([6, 32, 16], norm=norm, dtype=torch.bfloat16,
                         device="cpu")
        stats = _stats(jm) if norm == "batch" else None
        load_jax_params(port, _params(jm), stats)
        ref = nnx.jit(lambda m, v: m(v))(jm, jnp.asarray(x))
        with torch.no_grad():
            out = port(_t(x))
        assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert all(p.dtype == torch.float32 for p in port.parameters())
        _bf16_close(out.float(), _f32(ref))


class _Cotangent(nnx.Module):
    """A JAX Linear with a zero float32 Param added to its output (exact in
    bf16): the Param's grad is the Linear's output cotangent."""

    def __init__(self, linear, lead):
        self.linear = linear
        self.dy = nnx.Param(jnp.zeros((*lead, linear.out_features),
                                      jnp.float32))

    def __call__(self, x):
        y = self.linear(x)
        return y + self.dy[...].astype(y.dtype)


def _probe_cotangents(mlp, lead):
    for i, linear in enumerate(list(mlp.layers)):
        mlp.layers[i] = _Cotangent(linear, lead)


def _bf16_grad_gaps(got, jax_grads):
    """{path: gap} of the port's bf16 grads (JAX paths -> arrays) from the
    JAX bf16 model's (a pure dict), whose Linears went through
    :func:`_probe_cotangents`, in bf16 units: 2^-8 of each reference's
    largest magnitude.

    A Linear's bias grad is the sum of its output cotangent over every
    position; XLA on the CPU sums a bf16 cotangent in bf16, each partial
    sum rounded, where the port (and the TPU) accumulate in float32. So
    the bias's reference is the float32 sum of the JAX cotangent, rounded
    once to bf16, and its unit is taken of the sum of the cotangent's
    magnitudes (the sum's own scale: the bias of a Linear that feeds a
    BatchNorm has a gradient of zero up to rounding)."""
    ref = dict(_flatten(jax_grads))
    got = dict(got)
    gaps = {}
    for path in [p for p in ref if p.endswith("/dy")]:
        layer = path[:-len("/dy")]
        dy = np.asarray(ref.pop(path), np.float64)
        dy = dy.reshape(-1, dy.shape[-1])
        total = np.asarray(jnp.asarray(dy.sum(0), jnp.bfloat16), np.float32)
        ref.pop(f"{layer}/linear/bias")
        ref[f"{layer}/kernel"] = ref.pop(f"{layer}/linear/kernel")
        gap = np.abs(got.pop(f"{layer}/bias") - total).max()
        gaps[f"{layer}/bias"] = gap / np.abs(dy).sum(0).max() * 2.0**8
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        r = np.asarray(r, np.float32)
        gaps[path] = np.abs(got[path] - r).max() / np.abs(r).max() * 2.0**8
    return gaps


def _hold_bf16_grads(gaps, bar):
    for path, gap in gaps.items():
        assert gap <= bar * 2.0**8, (path, gap)


def _shared_mlp_bf16_grad_gaps(norm, seed):
    """SharedMLP([6, 32, 16]) at bf16 on the JAX module's weights: the
    gaps of the parameter and input grads of the mean square of the
    output."""
    x = np.random.default_rng(seed).standard_normal((2, 32, 8, 6))
    xb = jnp.asarray(x, jnp.bfloat16)
    jm = JaxSharedMLP([6, 32, 16], norm=norm, dtype=jnp.bfloat16,
                      rngs=nnx.Rngs(seed))
    port = SharedMLP([6, 32, 16], norm=norm, dtype=torch.bfloat16,
                     device="cpu")
    load_jax_params(port, _params(jm),
                    _stats(jm) if norm == "batch" else None)
    _probe_cotangents(jm, (2, 32, 8))

    def jloss(m, v):
        return jnp.mean(m(v).astype(jnp.float32) ** 2)

    rg, rx = nnx.jit(nnx.grad(jloss, argnums=(0, 1)))(jm, xb)
    xt = _t(_f32(xb)).to(torch.bfloat16).requires_grad_()
    (port(xt).float() ** 2).mean().backward()
    got = _port_grads(port)
    got["x"] = xt.grad.float().numpy()
    return _bf16_grad_gaps(got, {**nnx.to_pure_dict(rg), "x": rx})


@pytest.mark.parametrize("norm", ["layer", "batch", None])
def test_shared_mlp_bf16_grads_match_flax(norm):
    """The bf16 Linear, LayerNorm and BatchNorm backward: parameter and
    input grads of the mean square of the output.

    Over seeds 0-23 the largest gap was 3.7 bf16 units (of 2^-8 of each
    grad's scale) under either norm, and none without one (the bf16
    products are exact and both sides accumulate in float32); the bar is
    2^-5, eight units. ``python tests/test_torch_sorted_bn_bf16.py``
    prints the spread."""
    _hold_bf16_grads(_shared_mlp_bf16_grad_gaps(norm, 41), BF16_GRAD_BAR_MLP)


def test_gather_plain_bf16_backward_matches_group_points():
    """The bf16 gather's backward (the row scatter, summed in float32):
    on a cotangent of eighths every partial sum is exact in bf16, so the
    port's grad and the reference's agree bitwise."""
    rng = np.random.default_rng(42)
    f = jnp.asarray(rng.standard_normal((2, 64, 16)), jnp.bfloat16)
    idx = rng.integers(0, 64, (2, 16, 8)).astype(np.int32)
    g = rng.integers(-8, 9, (2, 16, 8, 16)) / 8
    _, vjp = jax.vjp(lambda a: jax_group_points(a, idx), f)
    (ref,) = vjp(jnp.asarray(g, jnp.bfloat16))
    ft = _t(_f32(f)).to(torch.bfloat16).requires_grad_()
    group_points(ft, _t(idx)).backward(_t(g).to(torch.bfloat16))
    assert ft.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(ft.grad.float().numpy(), _f32(ref))


def _port_sa_fp(params, xyz, f):
    """The port's SA2 -> FP pair in bf16 on the JAX pair's weights:
    (output, loss, [SA grads, FP grads]) of the mean square of the
    output."""
    bf16 = torch.bfloat16
    sa = PointNetSAModule(16, [32, 32], npoint=32, radius=0.5, nsample=8,
                          dtype=bf16, device="cpu")
    fp = PointNetFPModule(32 + 16, [32, 16], dtype=bf16, device="cpu")
    load_jax_params(sa, params[0])
    load_jax_params(fp, params[1])
    feat = _t(f).to(bf16)
    nx, nf = sa(_t(xyz), feat)
    assert nf.dtype == bf16
    out = fp(_t(xyz), nx, feat, nf)
    assert out.dtype == bf16
    value = (out.float() ** 2).mean()
    value.backward()
    return out.detach().float(), value.item(), [_port_grads(sa),
                                                _port_grads(fp)]


def _sa_fp_pair_bf16(seed):
    """The SA2 -> FP pair at bf16, JAX and port on the same weights:
    (port output, JAX output, port loss, JAX loss, {path: gap} of the
    parameter grads, SA's under "sa/", FP's under "fp/")."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (2, 128, 3)).astype(np.float32)
    f = jnp.asarray(rng.standard_normal((2, 128, 16)), jnp.bfloat16)
    kw = dict(npoint=32, radius=0.5, nsample=8)
    jsa = JaxSA(16, [32, 32], dtype=jnp.bfloat16, rngs=nnx.Rngs(seed), **kw)
    jfp = JaxFP(32 + 16, [32, 16], dtype=jnp.bfloat16,
                rngs=nnx.Rngs(seed + 1))
    params = (_params(jsa), _params(jfp))
    _probe_cotangents(jsa.mlp, (2, 32, 8))
    _probe_cotangents(jfp.mlp, (2, 128))

    def jloss(sa_m, fp_m, x, feat):
        nx, nf = sa_m(x, feat)
        out = fp_m(x, nx, feat, nf)
        return jnp.mean(out.astype(jnp.float32) ** 2), out

    (rv, rout), rgrads = nnx.jit(nnx.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jsa, jfp, jnp.asarray(xyz), f)
    out, value, grads = _port_sa_fp(params, xyz, _f32(f))
    gaps = {}
    for stage, got, rg in zip(("sa", "fp"), grads, rgrads):
        gaps.update({f"{stage}/{k}": v for k, v in _bf16_grad_gaps(
            got, nnx.to_pure_dict(rg)).items()})
    return out, _f32(rout), value, float(rv), gaps


def test_sa_fp_pair_bf16_matches_jax():
    """SA2 on bf16 SA1 features (K3's bf16 instance) and an FP stage
    interpolating them back (three_nn on f32 coordinates, the bf16 gather),
    forward and parameter grads.

    Over seeds 0-23 the largest grad gap was 7.9 bf16 units (of 2^-8 of
    each grad's scale), in SA's first kernel: a one-ulp difference in a
    LayerNorm's float32 arithmetic flips a bf16 rounding, which can make
    or break a tie in the max-pool and moves that neighbour's cotangent.
    The bar is 2^-4, sixteen units; a grad scaled by 0.9 misses it by at
    least ten. ``python tests/test_torch_sorted_bn_bf16.py`` prints the
    spread."""
    out, ref_out, value, ref_value, gaps = _sa_fp_pair_bf16(38)
    _bf16_close(out, ref_out)
    np.testing.assert_allclose(value, ref_value, rtol=2 * BF16_TOL)
    _hold_bf16_grads(gaps, BF16_GRAD_BAR_PAIR)


def test_dense_edge_conv_bf16_matches_jax():
    """The feature-space graph of bf16 features (the kNN on their f32
    casts), and the convs in bf16."""
    rng = np.random.default_rng(39)
    f = jnp.asarray(rng.integers(-8, 9, (2, 96, 8)) / 8, jnp.bfloat16)
    jm = JaxDenseEdgeConv(8, 8, 3, 8, dtype=jnp.bfloat16, rngs=nnx.Rngs(0))
    port = DenseEdgeConv(8, 8, 3, 8, dtype=torch.bfloat16, device="cpu")
    load_jax_params(port, _params(jm))
    jax_dispatch.force_impl("xla")  # the all-channel graph (exact on grid)
    try:
        ref = nnx.jit(lambda m, v: m(v))(jm, f)
    finally:
        jax_dispatch.force_impl("pallas")
    with torch.no_grad():
        out = port(_t(_f32(f)).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    _bf16_close(out.float(), _f32(ref))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def _autoencoder(norm="layer", remat=False, dtype=None):
    return PointCloudAutoencoder(16, 8, norm=norm, remat=remat, dtype=dtype,
                                 device="cpu")


def _batch():
    return {"points": _t(np.random.default_rng(40).standard_normal(
        (2, 64, 3)).astype(np.float32))}


@pytest.mark.parametrize("norm", ["layer", "batch"])
def test_remat_step_equals_plain_step(norm):
    """One step with remat=True (each SA/FP stage checkpointed) and one
    with make_train_step(remat=True) (the whole loss checkpointed) against
    a plain step: loss, grads and, under BatchNorm, running statistics
    updated once."""
    loss_fn = reconstruction_loss(emd_weight=0.0)
    runs = {}
    for label, model_remat, step_remat in (("plain", False, False),
                                           ("stages", True, False),
                                           ("whole", False, True)):
        model = _autoencoder(norm, model_remat)
        step = make_train_step(model, torch.optim.SGD(model.parameters(),
                                                      0.0), loss_fn,
                               remat=step_remat)
        loss = step(_batch())
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        bufs = {n: b.clone() for n, b in model.named_buffers()}
        runs[label] = (loss.item(), grads, bufs)
    ref_loss, ref_grads, ref_bufs = runs["plain"]
    for label in ("stages", "whole"):
        loss, grads, bufs = runs[label]
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
        for n, g in ref_grads.items():
            np.testing.assert_allclose(grads[n].numpy(), g.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=n)
        assert bufs.keys() == ref_bufs.keys()
        for n, b in ref_bufs.items():
            assert torch.equal(bufs[n], b), (label, n)
    if norm == "batch":  # the statistics did move, once
        bn = _autoencoder(norm).encoder.sa1.mlp.norms[0]
        assert not torch.equal(ref_bufs["encoder.sa1.mlp.norms.0.running_var"],
                               bn.running_var)


def test_trainer_with_remat_runs():
    model = _autoencoder("batch")
    tr = Trainer(model, torch.optim.Adam(model.parameters(), 1e-3),
                 reconstruction_loss(emd_weight=0.0), log_every=1,
                 remat=True)
    last = tr.fit([_batch(), _batch()], prefetch=None)
    assert np.isfinite(last) and tr.step == 2


if __name__ == "__main__":
    # The spread behind the bf16 grad bars: the largest gap, in bf16
    # units, of each grad over seeds 0-23.
    jax_dispatch.force_impl("pallas")
    spread = {}
    for seed in range(24):
        cases = {f"mlp {norm}": _shared_mlp_bf16_grad_gaps(norm, seed)
                 for norm in ("layer", "batch", None)}
        cases["pair"] = _sa_fp_pair_bf16(seed)[4]
        for case, gaps in cases.items():
            for path, gap in gaps.items():
                key = f"{case} {path}"
                spread[key] = max(spread.get(key, 0.0), float(gap))
    for key, gap in sorted(spread.items(), key=lambda kv: -kv[1]):
        print(f"{gap:8.3f}  {key}")
