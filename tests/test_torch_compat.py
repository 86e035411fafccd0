"""The port's ``compat`` (the reference's channels-first wrappers and the
torch bridge) against the JAX package's ``compat``.

The wrappers run on the cases of ``tests/test_utils_geo_losses.py``'s
``test_compat_layouts`` (B=2, N=100, 16 samples, 7 feature channels),
the JAX side under ``force_impl("pallas")`` (the Pallas kernels in
interpret mode). Clouds are on the dyadic grid k/64 wherever a wrapper
runs a nearest-neighbour scan, so every distance is exact and both sides
must agree bit for bit; the normals are held sign-invariantly to 1e-4 and
the normalisation to 1e-6 of its scale, as ``test_torch_geometry.py``
holds the ops themselves.

The bridge: ``linear_kernel_from_conv`` equal to the JAX one, and
``load_shared_mlp_from_torch`` on the case of the JAX package's
``test_torch_bridge``: the loaded port ``SharedMLP`` (eval mode) against
the loaded JAX one and the torch Conv1d+BatchNorm1d stack (rtol 1e-5:
float32 matmuls in different orders), with and without ``act_last``, and
the same ``ValueError``s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_points_tpu import compat as jcompat
from pytorch_points_tpu.compat import torch_bridge as jtb
from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.layers import SharedMLP as JaxSharedMLP
from pytorch_points_tpu_torch import compat
from pytorch_points_tpu_torch.compat import torch_bridge as tb
from pytorch_points_tpu_torch.layers import SharedMLP

RNG = np.random.default_rng(61)
XYZ = (RNG.integers(-64, 65, (2, 3, 100)) / 64).astype(np.float32)  # [B,3,N]
FEATS = RNG.standard_normal((2, 7, 100)).astype(np.float32)
KNOWN = (RNG.integers(-64, 65, (2, 12, 3)) / 64).astype(np.float32)
IDX_GROUP = RNG.integers(0, 100, (2, 16, 4)).astype(np.int32)
SPHERE = RNG.standard_normal((2, 3, 128)).astype(np.float32)
SPHERE /= np.linalg.norm(SPHERE, axis=1, keepdims=True)


@pytest.fixture(scope="module", autouse=True)
def pallas():
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _bnc(a):
    return np.ascontiguousarray(np.swapaxes(a, 1, 2))


def _calls():
    """{name: call(compat module)}: the 11 wrappers, NCHW and not."""
    idx = np.asarray(jcompat.furthest_point_sample(XYZ, 16)[1])
    sampled = np.asarray(jcompat.furthest_point_sample(XYZ, 16)[0])
    w = RNG.uniform(0.1, 1.0, (2, 100, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    nn3 = RNG.integers(0, 12, (2, 100, 3)).astype(np.int32)
    feats12 = RNG.standard_normal((2, 5, 12)).astype(np.float32)
    return {
        "furthest_point_sample": (
            lambda m: m.furthest_point_sample(XYZ, 16)),
        "furthest_point_sample_nhwc": (
            lambda m: m.furthest_point_sample(_bnc(XYZ), 16, NCHW=False)),
        "gather_points": (lambda m: m.gather_points(FEATS, idx)),
        "group_points": (lambda m: m.group_points(FEATS, IDX_GROUP)),
        "ball_query": (
            lambda m: m.ball_query(0.8, 8, _bnc(XYZ), _bnc(sampled))),
        "group_knn": (lambda m: m.group_knn(5, sampled, XYZ)),
        "group_knn_nhwc": (
            lambda m: m.group_knn(5, _bnc(sampled), _bnc(XYZ), unique=False,
                                  NCHW=False)),
        "three_nn": (lambda m: m.three_nn(_bnc(XYZ), KNOWN)),
        "three_interpolate": (
            lambda m: m.three_interpolate(feats12, nn3, w)),
        "nndistance": (lambda m: m.nndistance(_bnc(XYZ), KNOWN)),
        "sample_and_group": (
            lambda m: m.sample_and_group(XYZ, FEATS, npoint=8, nsample=4,
                                         radius=0.8)),
        "sample_and_group_xyz_only": (
            lambda m: m.sample_and_group(XYZ, None, npoint=8, nsample=4,
                                         radius=0.8, use_xyz=False)),
        "normalize_point_batch": (
            lambda m: m.normalize_point_batch(XYZ * 3 + 1)),
        "normalize_point_batch_nhwc": (
            lambda m: m.normalize_point_batch(_bnc(XYZ) * 3 + 1, NCHW=False)),
        "batch_normals": (lambda m: m.batch_normals(SPHERE)),
        "batch_normals_nhwc": (
            lambda m: m.batch_normals(_bnc(SPHERE), nn_size=12, NCHW=False)),
    }


CALLS = _calls()


class _Numpy:
    """The port's compat with numpy arguments turned into tensors."""

    def __getattr__(self, name):
        fn = getattr(compat, name)

        def call(*args, **kw):
            args = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
            kw = {k: _t(v) if isinstance(v, np.ndarray) else v
                  for k, v in kw.items()}
            return fn(*args, **kw)

        return call


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_wrapper_matches_jax(name):
    call = CALLS[name]
    want = _leaves(call(jcompat))
    got = _leaves(call(_Numpy()))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if name.startswith("batch_normals"):
            axis = 1 if name == "batch_normals" else 2
            dist = np.minimum(np.abs(g - w), np.abs(g + w)).max(axis)
            assert dist.max() <= 1e-4
        elif name.startswith("normalize"):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-6 * max(np.abs(w).max(), 1))
        else:
            np.testing.assert_array_equal(g, w)


WRAPPERS = ["ball_query", "batch_normals", "furthest_point_sample",
            "gather_points", "group_knn", "group_points", "nndistance",
            "normalize_point_batch", "sample_and_group", "three_interpolate",
            "three_nn"]


def test_compat_exports_the_reference_names():
    for name in WRAPPERS:
        assert callable(getattr(jcompat, name)) and callable(
            getattr(compat, name)), name
    assert sorted(compat.__all__) == sorted(
        WRAPPERS + ["load_jax_params", "torch_bridge"])
    assert not hasattr(tb, "to_jax") and not hasattr(tb, "from_jax")


# ---------------------------------------------------------------------------
# The torch bridge
# ---------------------------------------------------------------------------


def _torch_stack():
    """The JAX bridge test's reference stack: two Conv1d with BatchNorm1d
    whose running statistics and affine parameters are random."""
    torch.manual_seed(0)
    convs = [torch.nn.Conv1d(3, 8, 1), torch.nn.Conv1d(8, 4, 1)]
    bns = [torch.nn.BatchNorm1d(8), torch.nn.BatchNorm1d(4)]
    with torch.no_grad():
        for bn in bns:
            bn.running_mean.normal_()
            bn.running_var.uniform_(0.5, 2.0)
            bn.weight.normal_()
            bn.bias.normal_()
    for m in convs + bns:
        m.eval()
    return convs, bns


def _bn_state(bn):
    return {"weight": bn.weight, "bias": bn.bias,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


@pytest.mark.parametrize("shape", [(8, 3, 1), (8, 3, 1, 1)])
def test_linear_kernel_from_conv_matches_jax(shape):
    w = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    got = tb.linear_kernel_from_conv(w)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, jtb.linear_kernel_from_conv(w))


@pytest.mark.parametrize("act_last", [True, False])
def test_load_shared_mlp_from_torch_matches_jax(act_last):
    convs, bns = _torch_stack()
    weights = [c.weight for c in convs]
    biases = [c.bias for c in convs]
    states = [_bn_state(bn) for bn in (bns if act_last else bns[:1])]
    if not act_last:
        states.append(None)  # a placeholder for the head's missing norm
    jmlp = JaxSharedMLP([3, 8, 4], norm="batch", act_last=act_last,
                        rngs=nnx.Rngs(0))
    jtb.load_shared_mlp_from_torch(jmlp, weights, biases, states)
    jmlp.eval()
    mlp = SharedMLP([3, 8, 4], norm="batch", act_last=act_last,
                    device="cpu")
    tb.load_shared_mlp_from_torch(mlp, weights, biases, states)
    mlp.eval()

    x = np.random.default_rng(62).standard_normal((2, 16, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jmlp)(jnp.asarray(x)))
    with torch.no_grad():
        got = mlp(_t(x)).numpy()
        h = _t(_bnc(x))
        for i, c in enumerate(convs):
            h = c(h)
            if act_last or i == 0:
                h = torch.relu(bns[i](h))
        ref = np.swapaxes(h.numpy(), 1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _bad_calls():
    convs, bns = _torch_stack()
    w = [c.weight for c in convs]
    st = [_bn_state(bn) for bn in bns]
    return {
        "conv_count": (dict(norm="batch"), (w[:1],)),
        "conv_shape": (dict(norm="batch"), (w[::-1],)),
        "bn_count": (dict(norm="batch"), (w, None, st[:1])),
        "bn_on_layer_norm": (dict(norm="layer"), (w, None, st)),
        "bn_on_no_norm": (dict(norm=None), (w, None, st)),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_load_shared_mlp_from_torch_raises_as_jax(case):
    kw, args = _bad_calls()[case]
    with pytest.raises(ValueError) as want:
        jtb.load_shared_mlp_from_torch(
            JaxSharedMLP([3, 8, 4], rngs=nnx.Rngs(0), **kw), *args)
    with pytest.raises(ValueError) as got:
        tb.load_shared_mlp_from_torch(
            SharedMLP([3, 8, 4], device="cpu", **kw), *args)
    assert str(got.value) == str(want.value)
