"""The port's masked sorted chamfer (the band with window centres, K7, then
K6's resident scan) and the masked headline against the JAX package.

The JAX kernels run in Pallas interpret mode and the ops under
``force_impl("pallas")``, the jit caches cleared around it (and around
every change of the sorted-path threshold, read at trace time). The port
runs its plain PyTorch versions on the CPU. Inputs come from numpy with a
seed.

Tolerances, and why: indices exactly equal; distances rtol 1e-6 (XLA's CPU
backend contracts some interpret-mode multiply-adds into FMAs, about one
distance in six an ulp away); on dyadic-grid clouds (k/64), where every
distance is exact, the band bounds are held equal. Against the port's own
dense plain version (K5) on the same poisoned clouds: bitwise. Gradients:
atol GRAD_TOL * max|g_ref| per tensor (the JAX backward scatter splits
updates into bf16 parts and sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.core.masking import poison_points as jax_poison
from pytorch_points_tpu.kernels import ballquery as jax_bq
from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.kernels import distance_tiles as jax_dt
from pytorch_points_tpu.kernels import nn_sorted as jax_ns
from pytorch_points_tpu.ops import chamfer as jax_chamfer
from pytorch_points_tpu.ops import grouping as jax_grouping
from pytorch_points_tpu.ops import sampling as jax_sampling
from pytorch_points_tpu_torch.core.masking import poison_points
from pytorch_points_tpu_torch.kernels import distance_tiles, nn_sorted
from pytorch_points_tpu_torch.ops import (
    ball_query,
    chamfer,
    furthest_point_sample_and_gather,
    group_points,
)
from torch_inputs import cloud, emd_cloud, valid_mask

RTOL = 1e-6
GRAD_TOL = 2.0**-13


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def pallas():
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


@pytest.fixture
def sorted_at_256(monkeypatch):
    """Both packages take the sorted paths from 256 points a cloud."""
    jax.clear_caches()
    monkeypatch.setattr(jax_chamfer, "_SORTED_MIN_POINTS", 256)
    monkeypatch.setattr(chamfer, "_SORTED_MIN_POINTS", 256)
    yield
    jax.clear_caches()


def _assert_nn(got, ref):
    for g, r in zip(got, ref, strict=True):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == r.dtype
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=0)
        else:
            np.testing.assert_array_equal(g, r)


def _poisoned(seed, b, n, m, pfrac, qfrac, kind="random"):
    """(p, q, pm, qm, pp, qp): clouds, random validity masks of about the
    given fractions, and the clouds poisoned as nndistance poisons them."""
    rng = np.random.default_rng(seed)
    if kind == "grid":
        p, q = emd_cloud(rng, b, n, "grid"), emd_cloud(rng, b, m, "grid")
    else:
        p, q = cloud(rng, b, n), cloud(rng, b, m)
    pm, qm = valid_mask(rng, b, n, pfrac), valid_mask(rng, b, m, qfrac)
    pp = np.asarray(jax_poison(jnp.asarray(p), jnp.asarray(pm), sign=1.0))
    qp = np.asarray(jax_poison(jnp.asarray(q), jnp.asarray(qm), sign=-1.0))
    return p, q, pm, qm, pp, qp


# ---------------------------------------------------------------------------
# The masked sort, the band centres and the band (K7)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "grid"])
def test_sort_by_morton_masked_matches_jax(kind):
    _, _, pm, _, pp, _ = _poisoned(60, 2, 700, 8, 0.7, 1.0, kind)
    valid = np.abs(pp[..., 0]) < 2.0e4
    np.testing.assert_array_equal(valid, pm)
    rx, rperm, rvalid = jax_ns.sort_by_morton_masked(jnp.asarray(pp),
                                                     jnp.asarray(valid))
    x, perm, sv = nn_sorted.sort_by_morton_masked(_t(pp), _t(valid))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(rvalid))
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(
        nn_sorted._morton_codes_masked(_t(pp), _t(valid)).numpy(),
        np.asarray(jax_ns._morton_codes_masked(
            jnp.asarray(pp), jnp.asarray(valid))).astype(np.int64))
    assert perm.dtype == torch.int32
    assert not sv[:, pm.sum(1).min():].all()  # the poison sorts last


@pytest.mark.parametrize("ni,njq", [(32, 32), (32, 24), (5, 9)])
def test_band_centers_match_jax(ni, njq):
    rng = np.random.default_rng(61)
    vp = rng.integers(0, ni * 512 + 1, 6).astype(np.int32)
    vq = rng.integers(0, njq * 512 + 1, 6).astype(np.int32)
    vp[0] = 0  # an empty cloud clamps its divisor to 1
    ref = jax_ns._band_centers(jnp.asarray(vp), jnp.asarray(vq), ni, njq, 512)
    got = nn_sorted._band_centers(_t(vp), _t(vq), ni, njq, 512)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32


def test_band_min_dynamic_matches_pallas_on_grid():
    _, _, pm, qm, pp, qp = _poisoned(62, 2, 1024, 1536, 0.7, 0.9, "grid")
    ps, _, _ = nn_sorted.sort_by_morton_masked(_t(pp), _t(pm))
    qs, _, _ = nn_sorted.sort_by_morton_masked(_t(qp), _t(qm))
    cen = nn_sorted._band_centers(_t(pm.sum(1)), _t(qm.sum(1)), 2, 3, 512)
    ref = jax_ns.band_min_dynamic(jnp.asarray(ps.numpy()),
                                  jnp.asarray(qs.numpy()),
                                  jnp.asarray(cen.numpy()), tb=512)
    got = nn_sorted.band_min_dynamic(ps, qs, cen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# nndistance_indexed_masked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pfrac,qfrac", [(0.8, 0.5), (1.0, 0.3), (0.6, 1.0)])
def test_nndistance_indexed_masked_matches_pallas_and_dense(pfrac, qfrac):
    p, q, pm, qm, pp, qp = _poisoned(63, 2, 512, 512, pfrac, qfrac)
    got = nn_sorted.nndistance_indexed_masked(_t(pp), _t(qp))
    ref = jax_ns.nndistance_indexed_masked(jnp.asarray(pp), jnp.asarray(qp))
    dense = distance_tiles.nn_both_directions(_t(pp), _t(qp))
    rows = (pm, pm, qm, qm)
    _assert_nn([g[_t(v)] for g, v in zip(got, rows)],
               [np.asarray(r)[v] for r, v in zip(ref, rows)])
    for g, r, v in zip(got, dense, rows):
        assert g.dtype == r.dtype and torch.equal(g[_t(v)], r[_t(v)])
        assert (g[_t(~v)] == 0).all()  # invalid rows are (0, 0)
    if pfrac == 1.0:  # all-valid p: the p direction of the unmasked path
        plain = nn_sorted.nndistance_indexed(_t(p), _t(qp))
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def test_nndistance_indexed_masked_all_valid_equals_unmasked():
    p, q, _, _, _, _ = _poisoned(64, 2, 700, 600, 1.0, 1.0)
    got = nn_sorted.nndistance_indexed_masked(_t(p), _t(q))
    for g, r in zip(got, nn_sorted.nndistance_indexed(_t(p), _t(q))):
        assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# The masked ops: nndistance, chamfer_distance, the masked headline
# ---------------------------------------------------------------------------


def test_masked_nndistance_value_grad_and_path_match_jax(sorted_at_256):
    p, q, pm, qm, _, _ = _poisoned(65, 2, 700, 600, 0.8, 0.75)
    assert chamfer.chamfer_path(_t(p), _t(q), _t(pm), _t(qm)) == (
        "sorted_masked")
    assert jax_chamfer.chamfer_path(p, q, pm, qm) == "sorted_masked"
    rng = np.random.default_rng(66)
    w1 = rng.standard_normal(pm.shape).astype(np.float32)
    w2 = rng.standard_normal(qm.shape).astype(np.float32)

    def jloss(p, q):
        d1, _, d2, _ = jax_chamfer.nndistance(p, q, pm, qm)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    rv, rg = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(p), jnp.asarray(q))
    tp, tq = _t(p).requires_grad_(), _t(q).requires_grad_()
    out = chamfer.nndistance(tp, tq, _t(pm), _t(qm))
    value = (out[0] * _t(w1)).sum() + (out[2] * _t(w2)).sum()
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=RTOL)
    _assert_nn([o.detach() for o in out],
               jax_chamfer.nndistance(jnp.asarray(p), jnp.asarray(q), pm, qm))
    for g, r, m in zip((tp.grad, tq.grad), rg, (pm, qm)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max())
        assert (g.numpy()[~m] == 0).all()  # padded points get no grad


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_masked_chamfer_distance_matches_jax(sorted_at_256, reduction):
    p, q, pm, qm, _, _ = _poisoned(67, 2, 640, 512, 0.75, 0.9)
    rng = np.random.default_rng(68)
    w = ([rng.standard_normal(m.shape).astype(np.float32) for m in (pm, qm)]
         if reduction == "none" else [np.float32(1.0)])

    def total(out, w):
        out = out if isinstance(out, tuple) else (out,)
        return sum((o * wi).sum() for o, wi in zip(out, w))

    rv, rg = jax.value_and_grad(
        lambda p, q: total(jax_chamfer.chamfer_distance(
            p, q, pm, qm, reduction=reduction), w), (0, 1)
    )(jnp.asarray(p), jnp.asarray(q))
    tp, tq = _t(p).requires_grad_(), _t(q).requires_grad_()
    value = total(chamfer.chamfer_distance(tp, tq, _t(pm), _t(qm),
                                           reduction=reduction),
                  [_t(x) for x in w])
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=RTOL)
    for g, r, m in zip((tp.grad, tq.grad), rg, (pm, qm)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max())
        assert (g.numpy()[~m] == 0).all()


B, N, P, RADIUS, NSAMPLE = 2, 1024, 128, 0.2, 32


def _masked_headline_jax(pred, gt, pm, gm, reg_weight):
    cen, _ = jax_sampling.furthest_point_sample_and_gather(pred, P, mask=pm)
    nidx, _ = jax_bq.ball_query(pred, cen, RADIUS, NSAMPLE, mask=pm)
    centered = jax_grouping.group_points(pred, nidx) - cen[:, :, None, :]
    return (jax_chamfer.chamfer_distance(pred, gt, p_mask=pm, q_mask=gm)
            + reg_weight * jnp.mean(centered**2))


def _masked_headline_port(pred, gt, pm, gm, reg_weight):
    cen, _ = furthest_point_sample_and_gather(pred, P, mask=pm)
    nidx, _ = ball_query(pred, cen, RADIUS, NSAMPLE, mask=pm)
    centered = group_points(pred, nidx) - cen[:, :, None, :]
    return (chamfer.chamfer_distance(pred, gt, p_mask=pm, q_mask=gm)
            + reg_weight * (centered**2).mean())


@pytest.mark.parametrize("reg_weight", [1e-6, 1.0])
def test_masked_headline_value_and_grad(sorted_at_256, reg_weight):
    """bench.py's masked headline at a CPU size: 75% prefix-valid masks,
    p_mask = q_mask, the chamfer on the sorted_masked path."""
    rng = np.random.default_rng(69)
    gt = cloud(rng, B, N)
    pred = (rng.uniform(-1, 1, (B, N, 3)) * 0.98 + 0.01).astype(np.float32)
    pm = np.broadcast_to(np.arange(N) < int(N * 0.75), (B, N)).copy()
    assert chamfer.chamfer_path(_t(pred), _t(gt), _t(pm), _t(pm),
                                reduction="mean") == "sorted_masked"
    rv, rg = jax.value_and_grad(_masked_headline_jax)(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(pm), jnp.asarray(pm),
        reg_weight)
    x = _t(pred).requires_grad_()
    value = _masked_headline_port(x, _t(gt), _t(pm), _t(pm), reg_weight)
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=RTOL)
    r = np.asarray(rg)
    np.testing.assert_allclose(x.grad.numpy(), r, rtol=0,
                               atol=GRAD_TOL * np.abs(r).max())
    assert (x.grad.numpy()[~pm] == 0).all()
