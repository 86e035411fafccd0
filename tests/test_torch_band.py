"""The band pass (K6's band and K7) as the port's pipelines call it.

The CUDA band kernel visits only the window sub-tiles that can lower a
row's running minimum and computes no row past each cloud's live count
(``nn_sorted._band_rows``, ``_band_rows_masked``). On the CPU:

* its plain emulation (``band_visits_torch``: the kernel's visiting order,
  skip test and fold counter) equals the dense plain version
  ``band_min_torch`` bitwise on the live rows, and its counter equals a
  numpy walk of the same order written with loops;
* the pipeline entries' plain versions (-1 past the live rows, K7's window
  centres from the valid counts) equal the JAX package's band kernels in
  Pallas interpret mode followed by the reference's ``jnp.where``, bitwise
  on dyadic-grid clouds (k/64), where every distance is exact.

Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.kernels import distance_tiles as jax_dt
from pytorch_points_tpu.kernels import nn_sorted as jax_ns
from pytorch_points_tpu_torch.core.masking import poison_points
from pytorch_points_tpu_torch.kernels import nn_sorted
from torch_inputs import cloud, emd_cloud

TB = 512


@pytest.fixture(scope="module", autouse=True)
def pallas():
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


def _t(a):
    return torch.from_numpy(np.array(a))


def _gap2(lo, hi, a_lo, a_hi):
    g = np.maximum(np.maximum(lo - a_hi, a_lo - hi), np.float32(0))
    g = g * g
    return (g[..., 0] + g[..., 1]) + g[..., 2]


def _numpy_band(ps, qsub, tbq, centers, live):
    """The kernel's walk of one cloud with loops: each warp of 32 rows
    takes the groups of 4 sub-tiles of 16 window points in the order of
    their keys, a group's sub-tiles in index order, and folds a sub-tile
    when some live lane's gap to its box is below the lane's minimum.
    Returns (out [n] with -1 past ``live``, folds [ni])."""
    sub, grp, f32 = nn_sorted.BAND_SUB, nn_sorted.BAND_GROUP, np.float32
    n = ps.shape[0]
    ni, njq, nw = n // TB, qsub.shape[0] // tbq, 3 * tbq
    k = -(-nw // sub)
    kg = -(-k // grp)
    low = (1 << max(1, (kg - 1).bit_length())) - 1
    out = np.full(n, -1, f32)
    folds = np.zeros(ni, np.int64)
    for i in range(ni):
        c = i * njq // ni if centers is None else int(centers[i])
        win = np.concatenate([qsub[min(max(c + w - 1, 0), njq - 1) * tbq:][:tbq]
                              for w in range(3)])
        subs = [win[s * sub:(s + 1) * sub] for s in range(k)]
        slo = np.stack([x.min(0) for x in subs])
        shi = np.stack([x.max(0) for x in subs])
        glo = np.stack([slo[g * grp:(g + 1) * grp].min(0) for g in range(kg)])
        ghi = np.stack([shi[g * grp:(g + 1) * grp].max(0) for g in range(kg)])
        for w0 in range(0, TB, 32):
            rows = i * TB + np.arange(w0, min(TB, w0 + 32))
            p = ps[rows]
            alive = rows < live
            if not alive.any():
                continue
            wlo, whi = p[alive].min(0), p[alive].max(0)
            keys = [(int(_gap2(glo[g], ghi[g], wlo, whi).view(np.uint32))
                     & ~low) | g for g in range(kg)]
            acc = np.where(alive, np.inf, -np.inf).astype(f32)
            for g in np.argsort(keys):
                for s in range(g * grp, min(k, g * grp + grp)):
                    if not (_gap2(slo[s], shi[s], p, p) < acc).any():
                        continue
                    folds[i] += 1
                    d = subs[s][None] - p[:, None]
                    d = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                        + d[..., 2] * d[..., 2]
                    acc = np.minimum(acc, d.min(1))
            out[rows] = np.where(alive, acc, f32(-1))
    return out, folds


def _sorted(x):
    return nn_sorted.sort_by_morton(_t(x))[0]


def _band_inputs(kind, seed=70):
    """(ps [B,n,3], qs [B,m,3], tbq, stride, centers or None, live): sorted
    clouds (whole 512-point p tiles) and each cloud's live rows."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return (_sorted(cloud(rng, 2, 1024)), _sorted(cloud(rng, 2, 1536)),
                128, 4, None, torch.tensor([1024, 700], dtype=torch.int32))
    if kind == "ties":  # a dyadic grid of 8 steps, and duplicated points
        p, q = cloud(rng, 2, 1024, "grid"), cloud(rng, 2, 1200, "grid")
        q[:, 600:900] = q[:, :300]
        return (_sorted(p), _sorted(q), 128, 1, None,
                torch.tensor([1001, 1024], dtype=torch.int32))
    if kind == "poison_window":  # cloud 1's q all poison: every window
        p, q = cloud(rng, 2, 1024), cloud(rng, 2, 1536)
        qm = np.ones((2, 1536), bool)
        qm[1] = False
        qp = poison_points(_t(q), _t(qm), -1.0)
        qs = nn_sorted.sort_by_morton_masked(qp, _t(qm))[0]
        cen = torch.tensor([[0, 2], [1, 0]], dtype=torch.int32)
        return _sorted(p), qs, TB, 1, cen, torch.tensor([1024, 1000],
                                                        dtype=torch.int32)
    if kind == "one_tile":  # ni = 1
        return (_sorted(cloud(rng, 2, 512)), _sorted(cloud(rng, 2, 2048)),
                TB, 1, None, 512)
    # "ragged_tbq": a window of 13.5 sub-tiles, the last group short
    return (_sorted(cloud(rng, 1, 1024)), _sorted(cloud(rng, 1, 700)), 72,
            1, None, 999)


@pytest.mark.parametrize("kind", ["uniform", "ties", "poison_window",
                                  "one_tile", "ragged_tbq"])
def test_band_emulation_matches_dense_band_and_numpy_walk(kind):
    ps, qs, tbq, stride, centers, live = _band_inputs(kind)
    qsub = nn_sorted._band_qsub(qs, tbq, stride)
    b, n = ps.shape[:2]
    dense = nn_sorted.band_min_torch(ps, qsub, TB, tbq, centers)
    out, folds = nn_sorted.band_visits_torch(ps, qsub, TB, tbq, centers,
                                             live)
    rows = nn_sorted._live_rows(live, b, n, "cpu")
    assert torch.equal(out[rows], dense[rows])
    assert (out[~rows] == -1).all()
    lives = live.tolist() if torch.is_tensor(live) else [live] * b
    for i in range(b):
        ref, ref_folds = _numpy_band(
            ps[i].numpy(), qsub[i].numpy(), tbq,
            None if centers is None else centers[i].numpy(), lives[i])
        np.testing.assert_array_equal(out[i].numpy(), ref)
        np.testing.assert_array_equal(folds[i].numpy(), ref_folds)
    # the skips are real: fewer folds than the window's sub-tiles
    nw_sub = -(-3 * tbq // nn_sorted.BAND_SUB)
    assert folds.sum() < nw_sub * sum(-(-x // 32) for x in lives)


def _grid_masked(seed, b, n, m, vp, vq):
    """Dyadic-grid clouds poisoned past prefix counts vp, vq (p +x, q -x)."""
    rng = np.random.default_rng(seed)
    p, q = emd_cloud(rng, b, n, "grid"), emd_cloud(rng, b, m, "grid")
    pm = np.arange(n)[None] < np.array(vp)[:, None]
    qm = np.arange(m)[None] < np.array(vq)[:, None]
    return (poison_points(_t(p), _t(pm), 1.0).numpy(),
            poison_points(_t(q), _t(qm), -1.0).numpy(), pm, qm)


def test_band_rows_masked_matches_pallas_then_where():
    # ragged counts, counts of 0 (cloud 2: every row -1 both ways) and
    # counts equal to N and M (cloud 0). A window of poison alone is held by
    # the emulation test: its distances are not exact in f32, and XLA's CPU
    # backend contracts some of them into FMAs
    n, m = 1500, 1100
    vp, vq = [1500, 777, 0], [1100, 402, 0]
    pp, qp, pm, qm = _grid_masked(71, 3, n, m, vp, vq)
    got = nn_sorted._band_bounds_masked(_t(pp), _t(qp), _t(pm), _t(qm), 512,
                                        64, TB, "torch")
    sp, sq, _, _, pvs, qvs, d1, d2 = (np.asarray(x) for x in got)
    ref_sp, _, ref_pvs = jax_ns.sort_by_morton_masked(jnp.asarray(pp),
                                                      jnp.asarray(pm))
    ref_sq, _, ref_qvs = jax_ns.sort_by_morton_masked(jnp.asarray(qp),
                                                      jnp.asarray(qm))
    rpp = jax_dt._pad_points_poison(ref_sp, 1536)
    rqp = jax_dt._pad_points_poison_neg(ref_sq, 1536)
    np.testing.assert_array_equal(sp, np.asarray(rpp))
    np.testing.assert_array_equal(sq, np.asarray(rqp))
    rpvs = jnp.pad(ref_pvs, ((0, 0), (0, 1536 - n)))
    rqvs = jnp.pad(ref_qvs, ((0, 0), (0, 1536 - m)))
    np.testing.assert_array_equal(pvs, np.asarray(rpvs))
    cvp = jnp.asarray(vp, jnp.int32)
    cvq = jnp.asarray(vq, jnp.int32)
    c1 = jax_ns._band_centers(cvp, cvq, 3, 3, TB)
    c2 = jax_ns._band_centers(cvq, cvp, 3, 3, TB)
    ref1 = jnp.where(rpvs, jax_ns.band_min_dynamic(rpp, rqp, c1, tb=TB), -1.0)
    ref2 = jnp.where(rqvs, jax_ns.band_min_dynamic(rqp, rpp, c2, tb=TB), -1.0)
    np.testing.assert_array_equal(d1, np.asarray(ref1))
    np.testing.assert_array_equal(d2, np.asarray(ref2))
    assert (d1[2] == -1).all() and (d2[2] == -1).all()
    # the entry alone, with its fold counter against the emulation's
    counts = torch.zeros((3, 3), dtype=torch.int32)
    one = nn_sorted._band_rows_masked(_t(sp), _t(sq), _t(np.int32(vp)),
                                      _t(np.int32(vq)), counts=counts)
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref1))
    cen = nn_sorted._band_centers(_t(np.int32(vp)), _t(np.int32(vq)), 3, 3,
                                  TB)
    _, folds = nn_sorted.band_visits_torch(_t(sp), _t(sq), TB, TB, cen,
                                           _t(np.int32(vp)))
    assert torch.equal(counts, folds) and (counts[2] == 0).all()


@pytest.mark.parametrize("n,m", [(1000, 1300), (1024, 512)])
def test_band_rows_matches_pallas_with_padding_at_minus_one(n, m):
    # K6's form: stride-4 windows of 128 points; padding rows -1 where the
    # scan takes them, every row its bound for the reference's telemetry
    rng = np.random.default_rng(72)
    p, q = emd_cloud(rng, 2, n, "grid"), emd_cloud(rng, 2, m, "grid")
    ps = np.asarray(jax_ns.sort_by_morton(jnp.asarray(p))[0])
    qs = np.asarray(jax_ns.sort_by_morton(jnp.asarray(q))[0])
    n_pad, m_pad = -(-n // TB) * TB, -(-m // TB) * TB
    pp = jax_dt._pad_points_poison(jnp.asarray(ps), n_pad)
    qp = jax_dt._pad_points_poison_neg(jnp.asarray(qs), m_pad)
    ref1 = jax_ns.band_min(pp, qp, tb=TB, tbq=128, stride=4)
    ref2 = jax_ns.band_min(qp, pp, tb=TB, tbq=128, stride=4)
    for live in (True, False):
        got = nn_sorted._band_bounds(_t(ps), _t(qs), 512, 64, TB, "torch",
                                     live=live)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(pp))
        r1 = jnp.where(jnp.arange(n_pad) < (n if live else n_pad), ref1, -1.0)
        r2 = jnp.where(jnp.arange(m_pad) < (m if live else m_pad), ref2, -1.0)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(r1))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(r2))
