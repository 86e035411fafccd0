"""The port's scatter (K4), dense NN (K5, K13) and Morton-pruned NN (K6)
kernel modules and its nndistance / chamfer_distance ops against the JAX
package.

The JAX kernels run in Pallas interpret mode, as the JAX package's own
kernel tests run them on the CPU; the ops run under ``force_impl("pallas")``
with the jit caches cleared around it. The port runs its plain PyTorch
versions (CPU tensors). Inputs come from numpy with a seed.

Tolerances, and why:
  * indices: exactly equal; NN distances: rtol 1e-6. The port rounds each
    operation of ((dx*dx + dy*dy) + dz*dz) on its own, as the TPU does;
    XLA's CPU backend contracts some of the interpret-mode multiply-adds
    into FMAs, which moves about one distance in six by an ulp. Bitwise
    equality is held where both sides round alike: the pruned scan against
    the dense one here, each kernel against its plain version on the card
    (tests/test_torch_cuda.py);
  * K4 against the float64 oracle: rtol 1e-6 plus the f32 summation bound
    k 2^-24 sum|u| of a row of k updates;
  * K4 against the JAX kernel: that kernel splits each update into bf16
    parts, ~2^-16 relative error per update at parts=2 (and in the older
    layout), so 2^-14 sum|u| per element; at parts=3 each update is exact
    and only the MXU's f32 summation order differs, 2 k 2^-24 sum|u|; a
    permutation write is bitwise;
  * gradients: atol GRAD_TOL * max|g_ref| per tensor: the JAX backward
    scatters through the bf16-split kernel (~2^-16 relative per update)
    whenever it has 4096 updates or more, and sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.kernels import distance_tiles as jax_dt
from pytorch_points_tpu.kernels import nn_sorted as jax_ns
from pytorch_points_tpu.kernels import scatter as jax_scatter
from pytorch_points_tpu.ops import chamfer as jax_chamfer
from pytorch_points_tpu_torch.kernels import distance_tiles, nn_sorted, scatter
from pytorch_points_tpu_torch.ops import chamfer
from torch_inputs import SCATTER_CASES, nn_inputs, scatter_inputs

RTOL = 1e-6
GRAD_TOL = 2.0**-13
EPS32 = 2.0**-24


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _row_stats(idx, upd, n):
    """Per output element: (updates in its row, sum of |u|), in float64."""
    b = idx.shape[0]
    count = np.zeros((b, n, 1))
    abs_sum = np.zeros((b, n, upd.shape[-1]))
    oracle = np.zeros((b, n, upd.shape[-1]))
    for bi in range(b):
        ok = (idx[bi] >= 0) & (idx[bi] < n)
        np.add.at(count[bi], idx[bi][ok], 1.0)
        np.add.at(abs_sum[bi], idx[bi][ok], np.abs(upd[bi][ok]))
        np.add.at(oracle[bi], idx[bi][ok], upd[bi][ok].astype(np.float64))
    return count, abs_sum, oracle


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


# ---------------------------------------------------------------------------
# K4: scatter-add
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_matches_float64_oracle(case):
    idx, upd, n = scatter_inputs(case)
    out = scatter.scatter_add(_t(idx), _t(upd), n).numpy()
    count, abs_sum, oracle = _row_stats(idx, upd, n)
    assert out.shape == oracle.shape and out.dtype == np.float32
    assert (np.abs(out - oracle)
            <= RTOL * np.abs(oracle) + count * EPS32 * abs_sum).all()
    if case == "permutation":
        want = np.zeros_like(out)
        np.put_along_axis(want, idx[..., None].astype(np.int64), upd, 1)
        np.testing.assert_array_equal(out, want)  # bitwise
    if case == "empty_rows":
        assert (out[count[..., 0] == 0] == 0).all()


@pytest.mark.parametrize("form", ["t2", "t3", "csum"])
@pytest.mark.parametrize("case", ["duplicates", "empty_rows", "permutation",
                                  "out_of_range"])
def test_scatter_matches_pallas(form, case):
    idx, upd, n = scatter_inputs(case)
    if form == "csum":
        ref = jax_scatter.scatter_add_csum(jnp.asarray(idx), jnp.asarray(upd),
                                           n)
    else:
        ref = jax_scatter.scatter_add_csum_t(
            jnp.asarray(idx), jnp.asarray(upd), n, parts=int(form[1]))
    ref = np.asarray(ref)
    out = scatter.scatter_add(_t(idx), _t(upd), n).numpy()
    count, abs_sum, _ = _row_stats(idx, upd, n)
    if form == "t3":
        if case == "permutation":
            np.testing.assert_array_equal(out, ref)
        assert (np.abs(out - ref) <= 2 * count * EPS32 * abs_sum).all()
    else:
        assert (np.abs(out - ref) <= 2.0**-14 * abs_sum).all()


def test_scatter_auto_flattens_lead_dims_and_keeps_dtype():
    from pytorch_points_tpu_torch.ops.scatter_impl import scatter_add_auto

    idx, upd, n = scatter_inputs("random")
    i4 = _t(np.stack([idx, idx[::-1]]))  # [2, B, K]
    u4 = _t(np.stack([upd, -upd])).to(torch.float64)
    out = scatter_add_auto(i4, u4, n)
    assert out.shape == (2, 2, n, 3) and out.dtype == torch.float64
    torch.testing.assert_close(
        out[1], scatter.scatter_add(_t(idx[::-1]), _t(-upd), n).double(),
        rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K5 / K13: dense NN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "masked", "grid"])
def test_nn_both_directions_matches_pallas(kind):
    p, q = nn_inputs(kind, 300, 260)
    ref = jax_dt.nn_both_directions(jnp.asarray(p), jnp.asarray(q))
    out = distance_tiles.nn_both_directions(_t(p), _t(q))
    if kind == "masked":
        # Poisoned rows (|x| >= BIG_COORD) see only distances ~4e8, where an
        # ulp is 32 and the CPU's FMAs pick other near-tie winners; nndistance
        # zeroes those rows. Compare the valid rows.
        pv, qv = np.abs(p[..., 0]) < 2.0e4, np.abs(q[..., 0]) < 2.0e4
        out = [o[_t(v)] for o, v in zip(out, (pv, pv, qv, qv))]
        ref = [np.asarray(r)[v] for r, v in zip(ref, (pv, pv, qv, qv))]
    _assert_nn(out, ref)
    assert out[1].dtype == torch.int32 and out[0].dtype == torch.float32


@pytest.mark.parametrize("kind", ["random", "grid"])
def test_nn_one_direction_matches_pallas(kind):
    p, q = nn_inputs(kind, 200, 333)
    ref = jax_dt.nn_one_direction(jnp.asarray(p), jnp.asarray(q))
    _assert_nn(distance_tiles.nn_one_direction(_t(p), _t(q)), ref)


# ---------------------------------------------------------------------------
# K6: Morton-pruned NN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "grid"])
def test_sort_by_morton_matches_jax(kind):
    p, _ = nn_inputs(kind, 700, 8)
    ref_x, ref_perm = jax_ns.sort_by_morton(jnp.asarray(p))
    x, perm = nn_sorted.sort_by_morton(_t(p))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(ref_perm))
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref_x))
    np.testing.assert_array_equal(
        nn_sorted._morton_codes(_t(p)).numpy(),
        np.asarray(jax_dt._morton_codes(jnp.asarray(p))).astype(np.int64))


@pytest.mark.parametrize("form", ["tbq128_stride4", "tbq512", "centers"])
def test_band_min_matches_pallas(form):
    p, q = nn_inputs("random", 1000, 1500)
    ps = np.asarray(jax_ns.sort_by_morton(jnp.asarray(p))[0])
    qs = np.asarray(jax_ns.sort_by_morton(jnp.asarray(q))[0])
    pp = jax_dt._pad_points_poison(jnp.asarray(ps), 1024)
    qp = jax_dt._pad_points_poison_neg(jnp.asarray(qs), 1536)
    np.testing.assert_array_equal(
        nn_sorted._pad_poison(_t(ps), 1024, 1.0).numpy(), np.asarray(pp))
    np.testing.assert_array_equal(
        nn_sorted._pad_poison(_t(qs), 1536, -1.0).numpy(), np.asarray(qp))
    if form == "centers":  # the masked form (K7's band_min_dynamic)
        cen = np.array([[2, 0], [1, 1]], np.int32)
        ref = jax_ns.band_min_dynamic(pp, qp, jnp.asarray(cen), tb=512)
        out = nn_sorted.band_min_dynamic(_t(pp), _t(qp), _t(cen), tb=512)
    else:
        tbq, stride = (128, 4) if form == "tbq128_stride4" else (512, 1)
        ref = jax_ns.band_min(pp, qp, tb=512, tbq=tbq, stride=stride)
        out = nn_sorted.band_min(_t(pp), _t(qp), tb=512, tbq=tbq,
                                 stride=stride)
    _assert_nn([out], [ref])


@pytest.mark.parametrize("n,m", [(600, 700), (1024, 300)])
def test_nndistance_indexed_and_sums_match_pallas(n, m):
    p, q = nn_inputs("random", n, m)
    ref = jax_ns.nndistance_indexed(jnp.asarray(p), jnp.asarray(q))
    _assert_nn(nn_sorted.nndistance_indexed(_t(p), _t(q)), ref)
    ref_s = jax_ns.nndistance_sums(jnp.asarray(p), jnp.asarray(q))
    out_s = nn_sorted.nndistance_sums(_t(p), _t(q))
    for o, r in zip(out_s[:2], ref_s[:2]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL)
    # Rows come in the sorted order, or in the input order where the
    # reference's worklist budget overflowed (it does at (1024, 300)): hold
    # each side's rows to its targets and compare the NN ids in input order.
    rows = np.arange(p.shape[0])[:, None]
    for side in (out_s, ref_s):
        i1o, i2o, rows_p, rows_q, tgt_p, tgt_q = map(np.asarray, side[2:])
        np.testing.assert_array_equal(rows_p, p[rows, tgt_p])
        np.testing.assert_array_equal(rows_q, q[rows, tgt_q])
        i1, i2 = np.empty_like(i1o), np.empty_like(i2o)
        i1[rows, tgt_p], i2[rows, tgt_q] = i1o, i2o
        np.testing.assert_array_equal(i1, np.asarray(ref[1]))
        np.testing.assert_array_equal(i2, np.asarray(ref[3]))


@pytest.mark.parametrize("kind", ["random", "grid"])
def test_sorted_path_equals_dense(kind):
    p, q = nn_inputs(kind, 1100, 900)
    dense = distance_tiles.nn_both_directions(_t(p), _t(q))
    for o, r in zip(nn_sorted.nndistance_indexed(_t(p), _t(q)), dense):
        assert torch.equal(o, r)
    ps, _ = nn_sorted.sort_by_morton(_t(p))
    qs, _ = nn_sorted.sort_by_morton(_t(q))
    for o, r in zip(nn_sorted.nndistance_presorted(ps, qs),
                    distance_tiles.nn_both_directions(ps, qs)):
        assert torch.equal(o, r)


# ---------------------------------------------------------------------------
# nndistance / chamfer_distance: values and gradients
# ---------------------------------------------------------------------------


def _assert_nn(got, ref):
    """(d, i, ...) tuples: indices equal, distances to RTOL."""
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == r.dtype
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=0)
        else:
            np.testing.assert_array_equal(g, r)


def _assert_grads(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max())


def _port_value_and_grads(fn, *arrays):
    ts = [_t(a).requires_grad_() for a in arrays]
    value = fn(*ts)
    value.backward()
    return value.detach().numpy(), [t.grad for t in ts]


@pytest.fixture
def sorted_at_256(monkeypatch):
    monkeypatch.setattr(jax_chamfer, "_SORTED_MIN_POINTS", 256)
    monkeypatch.setattr(chamfer, "_SORTED_MIN_POINTS", 256)


@pytest.mark.parametrize("path", ["dense", "sorted"])
def test_nndistance_value_and_grad_match_jax(monkeypatch, path):
    if path == "sorted":
        monkeypatch.setattr(jax_chamfer, "_SORTED_MIN_POINTS", 256)
        monkeypatch.setattr(chamfer, "_SORTED_MIN_POINTS", 256)
    p, q = nn_inputs("random", 600, 520)
    rng = np.random.default_rng(13)
    w1 = rng.standard_normal(p.shape[:2]).astype(np.float32)
    w2 = rng.standard_normal(q.shape[:2]).astype(np.float32)

    def jloss(p, q):
        d1, _, d2, _ = jax_chamfer.nndistance(p, q)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    def tloss(p, q):
        d1, _, d2, _ = chamfer.nndistance(p, q)
        return (d1 * _t(w1)).sum() + (d2 * _t(w2)).sum()

    rv, rg = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(p), jnp.asarray(q))
    v, g = _port_value_and_grads(tloss, p, q)
    np.testing.assert_allclose(v, float(rv), rtol=RTOL)
    _assert_grads(g, rg)
    _assert_nn(chamfer.nndistance(_t(p), _t(q)),
               jax_chamfer.nndistance(jnp.asarray(p), jnp.asarray(q)))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("one_sided", [False, True])
@pytest.mark.parametrize("path", ["dense", "sorted"])
def test_chamfer_distance_matches_jax(monkeypatch, reduction,
                                      one_sided, path):
    if path == "sorted":
        monkeypatch.setattr(jax_chamfer, "_SORTED_MIN_POINTS", 256)
        monkeypatch.setattr(chamfer, "_SORTED_MIN_POINTS", 256)
    p, q = nn_inputs("random", 640, 512)
    want = {("dense", "mean"): "dense-pallas",
            ("dense", "sum"): "dense-pallas",
            ("dense", "none"): "dense-pallas",
            ("sorted", "mean"): "sorted_loss",
            ("sorted", "sum"): "sorted_loss", ("sorted", "none"): "sorted"}
    assert chamfer.chamfer_path(_t(p), _t(q), reduction=reduction) == (
        want[path, reduction])

    def total(out, w):
        out = out if isinstance(out, tuple) else (out,)
        return sum((o * wi).sum() for o, wi in zip(out, w))

    rng = np.random.default_rng(14)
    w = [rng.standard_normal(s).astype(np.float32)
         for s in (p.shape[:2], q.shape[:2])] if reduction == "none" else [1.0]
    rv, rg = jax.value_and_grad(
        lambda p, q: total(jax_chamfer.chamfer_distance(
            p, q, reduction=reduction, one_sided=one_sided), w),
        (0, 1))(jnp.asarray(p), jnp.asarray(q))
    v, g = _port_value_and_grads(
        lambda p, q: total(chamfer.chamfer_distance(
            p, q, reduction=reduction, one_sided=one_sided),
            [_t(x) if isinstance(x, np.ndarray) else x for x in w]), p, q)
    np.testing.assert_allclose(v, float(rv), rtol=RTOL)
    _assert_grads(g, rg)


def test_masked_chamfer_matches_jax_sorted_masked(sorted_at_256):
    # At sizes where the reference takes its masked sorted path (K7), so
    # does the port: same values and grads.
    rng = np.random.default_rng(15)
    p, q = nn_inputs("random", 700, 600)
    pm = rng.uniform(size=p.shape[:2]) < 0.8
    qm = rng.uniform(size=q.shape[:2]) < 0.8
    assert jax_chamfer.chamfer_path(p, q, pm, qm) == "sorted_masked"
    assert chamfer.chamfer_path(_t(p), _t(q), _t(pm), _t(qm)) == (
        "sorted_masked")
    rv, rg = jax.value_and_grad(
        lambda p, q: jax_chamfer.chamfer_distance(p, q, pm, qm), (0, 1)
    )(jnp.asarray(p), jnp.asarray(q))
    v, g = _port_value_and_grads(
        lambda p, q: chamfer.chamfer_distance(p, q, _t(pm), _t(qm)), p, q)
    np.testing.assert_allclose(v, float(rv), rtol=RTOL)
    _assert_grads(g, rg)
    _assert_nn(chamfer.nndistance(_t(p), _t(q), _t(pm), _t(qm)),
               jax_chamfer.nndistance(jnp.asarray(p), jnp.asarray(q), pm, qm))
    assert (g[0].numpy()[~pm] == 0).all() and (g[1].numpy()[~qm] == 0).all()
