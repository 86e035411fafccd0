"""kNN for any k and any channel count, and the ported ops' API, against
the JAX package.

* k > 64: the port's plain versions (what a CPU tensor runs, and what the
  card's one-pass heaps and wide ring lists are held to) against the
  reference's Pallas scans in interpret mode under ``force_impl("pallas")``,
  with the jit caches cleared around it. Indices identical; distances rtol
  1e-6, since XLA's CPU backend contracts some interpret-mode multiply-adds
  into FMAs (about one distance in six an ulp away).
* C != 3: ``ops.knn`` against the reference with ``impl="xla"``, whose
  all-channel distance is the documented [B,N,C] contract (its Pallas scan
  reads three channels). On dyadic-grid features (k/64) the reference's
  matmul form is exact, so indices and distances are held equal. Gradients:
  atol GRAD_TOL * max|g_ref| per tensor (the two backward scatters sum in
  other orders).
* API: ``chamfer_path`` and ``knn_path`` called with the reference's
  positional arguments give the reference's Pallas-route answers; the top
  level exports the reference's ported ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_points_tpu as reference
import pytorch_points_tpu_torch as port
from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.kernels import topk_scan as jax_topk
from pytorch_points_tpu.ops import chamfer as jax_chamfer
from pytorch_points_tpu.ops import grouping as jax_grouping
from pytorch_points_tpu_torch import ops
from pytorch_points_tpu_torch.kernels import topk_scan
from pytorch_points_tpu_torch.ops import chamfer, grouping

RTOL = 1e-6
GRAD_TOL = 2.0**-13


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.fixture
def pallas():
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


@pytest.fixture
def ring_at_512(monkeypatch, pallas):
    """Both packages send supports of 512 points and up to the ring scan."""
    monkeypatch.setattr(jax_topk, "RING_MIN_NS", 512)
    monkeypatch.setattr(topk_scan, "RING_MIN_NS", 512)


def _assert_knn(got, ref, rtol=RTOL):
    d, i = got
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref[0]), rtol=rtol,
                               atol=0)
    assert d.dtype == torch.float32 and i.dtype == torch.int32


def _uniform(seed, b, nq, ns, c=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, nq, c)).astype(np.float32),
            rng.uniform(-1, 1, (b, ns, c)).astype(np.float32))


def _grid(seed, b, n, c):
    """Dyadic-grid features k/64: every distance exact, many ties."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-64, 65, (b, n, c)) / 64).astype(np.float32)


# ---------------------------------------------------------------------------
# k > 64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [65, 100, 128])
def test_knn_torch_any_k_matches_pallas_stream(pallas, k):
    # the filed inputs: query [1,256,3], support [1,1024,3], default_rng(0)
    q, s = _uniform(0, 1, 256, 1024)
    ref = jax_topk.knn(jnp.asarray(q), jnp.asarray(s), k)
    _assert_knn(topk_scan.knn_torch(_t(q), _t(s), k), ref)
    _assert_knn(topk_scan.knn(_t(q), _t(s), k, impl="torch"), ref)


def test_ops_knn_k100_on_the_ring_matches_pallas(ring_at_512):
    # the ring scans (K9, and K10 on a masked support) at k = 100
    q, s = _uniform(0, 1, 256, 1024)
    s[:, 600:700] = s[:, :100]  # duplicate ties
    mask = np.arange(1024)[None] < 900
    for m in (None, mask):
        assert grouping.knn_path(_t(q), _t(s), 100, _t(m)) == (
            jax_grouping.knn_path(q, s, 100, None if m is None
                                  else jnp.asarray(m)))
        ref = jax_grouping.knn(jnp.asarray(q), jnp.asarray(s), 100,
                               support_mask=None if m is None
                               else jnp.asarray(m))
        _assert_knn(grouping.knn(_t(q), _t(s), 100, support_mask=_t(m)),
                    ref)


def test_knn_ring_stats_k100_match_pallas_on_the_grid(pallas):
    # the stats twin's counters read the list's worst entry, which k > 16
    # keeps in a heap on the card; on the grid both sides are exact
    q, s = _grid(41, 1, 512, 3), _grid(42, 1, 1536, 3)
    d, i, st = topk_scan._knn_ring_stats_call(_t(q), _t(s), 100)
    rd, ri, rst = jax_topk._knn_ring_stats_call(jnp.asarray(q),
                                                jnp.asarray(s), 100)
    _assert_knn((d, i), (rd, ri), rtol=0)
    np.testing.assert_array_equal(st.numpy(),
                                  np.asarray(rst).astype(np.int32))


# ---------------------------------------------------------------------------
# any C
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("c", [1, 5, 24])
def test_ops_knn_any_channels_matches_xla(c, masked):
    rng = np.random.default_rng(43)
    f = _grid(44 + c, 2, 256, c)
    mask = rng.uniform(size=(2, 256)) < 0.8 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jax_grouping.knn(jnp.asarray(f), jnp.asarray(f), 17,
                           support_mask=jmask, impl="xla")
    got = grouping.knn(_t(f), _t(f), 17, support_mask=_t(mask))
    _assert_knn(got, ref, rtol=0)
    assert grouping.knn_path(_t(f), _t(f), 17, _t(mask)) == "stream"


def test_ops_knn_c24_grads_match_xla():
    # config 7's first feature-space graph: DenseEdgeConv on 24 channels
    f, g = _grid(45, 2, 256, 24), _grid(46, 2, 300, 24)
    w = np.random.default_rng(47).standard_normal((2, 256, 17)).astype(
        np.float32)

    def jloss(q, s):
        d, _ = jax_grouping.knn(q, s, 17, impl="xla")
        return jnp.sum(d * w)

    rv, rg = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(f), jnp.asarray(g))
    tq, ts = _t(f).requires_grad_(), _t(g).requires_grad_()
    d, _ = grouping.knn(tq, ts, 17)
    value = (d * _t(w)).sum()
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=RTOL)
    for got, ref in zip((tq.grad, ts.grad), rg):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max())


def test_knn_torch_c3_keeps_the_xyz_sum_order():
    # the any-C fold from channel 0 is the xyz form ((dx^2 + dy^2) + dz^2)
    q, s = _uniform(48, 2, 100, 300)
    dx, dy, dz = (_t(q)[:, :, None, c] - _t(s)[:, None, :, c]
                  for c in range(3))
    want, idx = torch.sort((dx * dx + dy * dy) + dz * dz, dim=-1, stable=True)
    d, i = topk_scan.knn_torch(_t(q), _t(s), 20)
    assert torch.equal(d, want[..., :20])
    assert torch.equal(i, idx[..., :20].to(torch.int32))


# ---------------------------------------------------------------------------
# API parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8192, 512])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_chamfer_path_takes_the_reference_arguments(pallas, n, masked,
                                                    reduction):
    p = np.zeros((1, n, 3), np.float32)
    m = np.ones((1, n), bool) if masked else None
    ref = jax_chamfer.chamfer_path(p, p, m, None, "auto", reduction)
    for impl in ("auto", "pallas", "xla"):
        assert chamfer.chamfer_path(_t(p), _t(p), _t(m), None, impl,
                                    reduction) == ref
    assert ref in ("sorted_loss", "sorted", "sorted_masked", "dense-pallas")
    if n == 8192 and not masked and reduction == "mean":
        assert ref == "sorted_loss"


def test_knn_path_takes_the_reference_arguments(pallas):
    q = np.zeros((1, 16, 3), np.float32)
    for ns, masked in ((8192, False), (8192, True), (8191, False)):
        s = np.zeros((1, ns, 3), np.float32)
        m = np.ones((1, ns), bool) if masked else None
        ref = jax_grouping.knn_path(q, s, 16, m, "auto")
        # the port holds the Pallas semantics: the reference's impl values
        # name the route the port takes
        for impl in ("auto", "pallas", "xla", "torch"):
            assert grouping.knn_path(_t(q), _t(s), 16, _t(m), impl) == ref
    with pytest.raises(ValueError, match="impl"):
        grouping.knn_path(_t(q), _t(s), 16, None, "mosaic")


EXPORTS = ("ball_query", "furthest_point_sample",
           "furthest_point_sample_and_gather", "gather_points", "group_knn",
           "group_points", "knn", "sample_and_group", "three_interpolate",
           "three_nn")


@pytest.mark.parametrize("name", EXPORTS)
def test_top_level_exports_the_ported_ops(name):
    assert name in port.__all__ and hasattr(reference, name)
    assert getattr(port, name) is getattr(ops, name)
