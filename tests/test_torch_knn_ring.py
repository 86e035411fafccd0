"""The port's Morton-ring kNN (K9, K10 and the ring stats twin) and its kNN
ops (the ring dispatch, ``knn_path``, ``duplicate_shadow_mask``,
``group_knn``) against the JAX package.

The JAX kernels run in Pallas interpret mode and the ops under
``force_impl("pallas")``, with the jit caches cleared around it (and around
every change of the ring threshold, which is read at trace time). The port
runs its plain PyTorch versions on the CPU. Inputs come from numpy with a
seed.

Tolerances, and why: indices exactly equal; distances rtol 1e-6, since XLA's
CPU backend contracts some interpret-mode multiply-adds into FMAs (about
one distance in six an ulp away). On dyadic-grid clouds (k/64) every
distance and every AABB bound is exact, so distances and the stats twin's
per-tile counters are held equal there. On real-valued clouds an ulp can
flip one skip test, so the counters are held only to their sums within 1%.
Gradients: atol GRAD_TOL * max|g_ref| per tensor (the JAX backward scatter
splits updates into bf16 parts and sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.core.masking import poison_points as jax_poison
from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.kernels import topk_scan as jax_topk
from pytorch_points_tpu.ops import grouping as jax_grouping
from pytorch_points_tpu_torch.core.masking import poison_points
from pytorch_points_tpu_torch.kernels import topk_scan
from pytorch_points_tpu_torch.ops import grouping
from torch_inputs import emd_cloud

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
def ring_at_512(monkeypatch):
    """Both packages send supports of 512 points and up to the ring scan."""
    jax.clear_caches()
    monkeypatch.setattr(jax_topk, "RING_MIN_NS", 512)
    monkeypatch.setattr(topk_scan, "RING_MIN_NS", 512)
    yield
    jax.clear_caches()


def _assert_knn(got, ref):
    d, i = got
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref[0]), rtol=RTOL,
                               atol=0)
    assert d.dtype == torch.float32 and i.dtype == torch.int32


def _normal(seed, b, nq, ns):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, nq, 3)).astype(np.float32),
            rng.standard_normal((b, ns, 3)).astype(np.float32))


def _masked_support(seed, b, nq, ns):
    """Queries, a support with duplicate valid points, and its prefix mask
    with ragged valid counts (the reference's masked ring test)."""
    q, s = _normal(seed, b, nq, ns)
    s[:, 100:110] = s[:, 0:10]
    n_valid = np.array([int(ns * 0.7) - 13 * i for i in range(b)])
    return q, s, np.arange(ns)[None, :] < n_valid[:, None], n_valid


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,nq,ns,k", [(2, 300, 1024, 5), (1, 700, 1024, 16)])
def test_knn_ring_matches_pallas_and_stream(b, nq, ns, k):
    q, s = _normal(30, b, nq, ns)
    got = topk_scan.knn_ring(_t(q), _t(s), k)
    _assert_knn(got, jax_topk.knn_ring(jnp.asarray(q), jnp.asarray(s), k))
    stream = topk_scan.knn_torch(_t(q), _t(s), k)
    assert torch.equal(got[0], stream[0]) and torch.equal(got[1], stream[1])


def test_knn_ring_duplicate_support_matches_pallas():
    # every distance tied: lowest-index ties through the ring order
    q, base = _normal(31, 1, 128, 512)
    s = np.concatenate([base, base], axis=1)
    got = topk_scan.knn_ring(_t(q), _t(s), 6)
    _assert_knn(got, jax_topk.knn_ring(jnp.asarray(q), jnp.asarray(s), 6))
    stream = topk_scan.knn_torch(_t(q), _t(s), 6)
    assert torch.equal(got[1], stream[1])


@pytest.mark.parametrize("b,nq,ns,k", [(2, 300, 1024, 5), (1, 257, 1536, 16)])
def test_knn_ring_masked_matches_pallas(b, nq, ns, k):
    q, s, mask, n_valid = _masked_support(32, b, nq, ns)
    sp = np.asarray(jax_poison(jnp.asarray(s), jnp.asarray(mask), sign=-1.0))
    np.testing.assert_array_equal(
        poison_points(_t(s), _t(mask), sign=-1.0).numpy(), sp)
    got = topk_scan.knn_ring_masked(_t(q), _t(sp), k)
    _assert_knn(got, jax_topk.knn_ring_masked(jnp.asarray(q),
                                              jnp.asarray(sp), k))
    stream = topk_scan.knn_torch(_t(q), _t(sp), k)
    assert torch.equal(got[0], stream[0]) and torch.equal(got[1], stream[1])
    assert (got[1].numpy() < n_valid[:, None, None]).all()  # no poison row


def _grid(seed, b, n):
    return emd_cloud(np.random.default_rng(seed), b, n, "grid")


def _grid_clusters(seed, b, n):
    """Grid points (k/256) in two cubes around x = y = z = +-0.5: every
    distance still exact, and the far cube's chunks fail the skip test."""
    x = _grid(seed, b, n) * np.float32(0.25)
    side = np.where(np.arange(n) % 2 == 0, 0.5, -0.5).astype(np.float32)
    return x + side[None, :, None]


def _far_queries(seed, b, n):
    """Queries far out at x = -1e5, nearer to the support's pad rows
    (x <= -8e4) than to its points: the nearest pad row enters the list."""
    q = _grid(seed, b, n)
    q[..., 0] = -1e5
    return q


@pytest.mark.parametrize("kind,b,nq,ns,k", [
    ("grid", 2, 300, 1024, 5),
    ("grid", 1, 512, 1000, 8),  # ns=1000 pads the last chunk
    ("clusters", 2, 1024, 2048, 8),
    ("clusters", 1, 1500, 3000, 16),
    ("far", 1, 512, 1000, 8),
])
def test_knn_ring_stats_counters_equal_pallas(kind, b, nq, ns, k):
    if kind == "clusters":
        q, s = _grid_clusters(33, b, nq), _grid_clusters(34, b, ns)
    else:
        q = (_far_queries if kind == "far" else _grid)(33, b, nq)
        s = _grid(34, b, ns)
    d, i, st = topk_scan._knn_ring_stats_call(_t(q), _t(s), k)
    rd, ri, rst = jax_topk._knn_ring_stats_call(jnp.asarray(q),
                                                jnp.asarray(s), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(st.numpy(), np.asarray(rst).astype(np.int32))
    assert st.shape == (b, -(-nq // 512), 2)
    if kind == "clusters":  # the skip test drops chunks
        assert (st[..., 0] < -(-ns // 512)).any()
    if kind == "far":  # a pad row (id 2^24) is in the list
        assert (i == 2**24).any()


def test_knn_ring_stats_unroll_invariant_on_tie_grid():
    # three-way ties everywhere on a grid base: results do not depend on the
    # unroll, the trip counts do, exactly as the reference's
    q = _grid(35, 2, 256)
    base = _grid(36, 2, 512)
    s = np.concatenate([base, base, base], axis=1)
    stream = topk_scan.knn_torch(_t(q), _t(s), 8)
    for u in (1, 2, 3):
        d, i, st = topk_scan._knn_ring_stats_call(_t(q), _t(s), 8, unroll=u)
        _, _, rst = jax_topk._knn_ring_stats_call(jnp.asarray(q),
                                                  jnp.asarray(s), 8,
                                                  unroll=u)
        assert torch.equal(d, stream[0]) and torch.equal(i, stream[1])
        np.testing.assert_array_equal(st.numpy(),
                                      np.asarray(rst).astype(np.int32))


def _jax_ring_support(s, masked):
    """The reference's sorted, padded support [B, m_pad, 4] (x, y, z, id as
    f32; far-away pad rows of id 2^24), built as ``knn_ring`` and
    ``knn_ring_masked`` build it before their pallas_call."""
    from pytorch_points_tpu.core.masking import BIG_COORD
    from pytorch_points_tpu.kernels import nn_sorted as jax_sorted

    s = jnp.asarray(s)
    b, ns, _ = s.shape
    if masked:
        ss, perm, _ = jax_sorted.sort_by_morton_masked(
            s, jnp.abs(s[..., 0]) < BIG_COORD)
    else:
        ss, perm = jax_sorted.sort_by_morton(s)
    sup4 = jnp.concatenate([ss, perm[..., None].astype(jnp.float32)], -1)
    padm = -(-ns // 512) * 512 - ns
    first = ns if masked else 0
    offs = -(BIG_COORD * 4.0
             + 8.0 * (first + jnp.arange(padm, dtype=jnp.float32)))
    pad = jnp.zeros((b, padm, 4), jnp.float32).at[:, :, 0].set(offs[None])
    pad = pad.at[:, :, 3].set(float(jax_topk._IDX_RING))
    return np.asarray(jnp.concatenate([sup4, pad], axis=1))


@pytest.mark.parametrize("masked,ns", [(False, 1000), (False, 1536),
                                       (True, 1300)])
def test_ring_boxes_match_reference_chunk_aabb(masked, ns):
    # the chunk-box table against min / max over every row of each chunk
    # (pad and poison rows too) of the reference's own sorted, padded support
    q, s, mask, _ = _masked_support(46, 2, 100, ns)
    if masked:
        s = np.asarray(jax_poison(jnp.asarray(s), jnp.asarray(mask),
                                  sign=-1.0))
    ref = _jax_ring_support(s, masked)
    sup4 = topk_scan._ring_inputs(_t(q), _t(s), masked)[1]
    np.testing.assert_array_equal(sup4.numpy(), ref)
    boxes = topk_scan.ring_boxes_torch(_t(ref)).numpy()
    ch = ref.reshape(2, -1, 512, 4)
    assert boxes.shape == (2, ch.shape[1], 17, 8)
    # the chunk's box, then its 16 sub-chunks' of 32 rows
    for box, rows in ((boxes[:, :, 0], ch),
                      (boxes[:, :, 1:], ch.reshape(2, -1, 16, 32, 4))):
        np.testing.assert_array_equal(box[..., :3], rows[..., :3].min(-2))
        np.testing.assert_array_equal(box[..., 4:7], rows[..., :3].max(-2))
        np.testing.assert_array_equal(
            box[..., 3], (rows[..., 3] == 2**24).any(-1).astype(np.float32))
        assert (box[..., 7] == 0).all()
    assert boxes[:, -1, 0, 3].all() == (ns % 512 != 0)


def _independent_warp_scans(qsp, sup4, k):
    """Independent count of the ring kernel's work on a support with no pad
    rows: for each warp of 32 sorted queries, walking its tile's ring, the
    sub-chunks of 32 rows it scans. At a ring step the warp needs a box when
    some query's AABB bound (f32, each operation rounded alone) is <= the
    round_up(k, 8)-th smallest distance over the chunks its warp scanned
    before (+inf until there are that many); it scans the sub-chunks it
    needs of a chunk it needs."""
    b, q_pad, _ = qsp.shape
    nj = sup4.shape[1] // 512
    kp = -(-k // 8) * 8
    zero = np.float32(0)

    def bound(rows, q):  # [..., n, 3] rows, [32, 3] queries -> [32, ...]
        lo, hi = rows.min(axis=-2), rows.max(axis=-2)
        g = np.maximum(np.maximum(lo[None] - q[:, None], q[:, None] - hi[None]),
                       zero)
        return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + (
            g[..., 2] * g[..., 2])

    out = np.zeros((b, q_pad // 32), np.int32)
    for bi in range(b):
        for w in range(q_pad // 32):
            centre = ((w * 32 // 512 * 512 + 256) * nj) // q_pad
            q = qsp[bi, w * 32:(w + 1) * 32]
            seen = np.empty((32, 0), np.float32)
            worst = np.full(32, np.inf, np.float32)
            for j in range(nj):
                off = ((j + 1) // 2) * (2 * (j % 2) - 1)
                c = (centre + off + nj) % nj
                ch = sup4[bi, c * 512:(c + 1) * 512, :3]
                if not (bound(ch[None], q)[:, 0] <= worst).any():
                    continue
                subs = bound(ch.reshape(16, 32, 3), q)  # [32, 16]
                out[bi, w] += (subs <= worst[:, None]).any(axis=0).sum()
                dd = q[:, None, :] - ch[None, :, :]
                d = (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]) + (
                    dd[..., 2] * dd[..., 2])
                seen = np.concatenate([seen, d], axis=1)
                if seen.shape[1] >= kp:
                    worst = np.partition(seen, kp - 1, axis=1)[:, kp - 1]
    return out


@pytest.mark.parametrize("kind,b,nq,ns,k", [
    ("grid", 2, 1024, 4096, 8),
    ("clusters", 1, 700, 4096, 5),
    ("grid", 1, 1500, 3072, 16),
])
def test_ring_work_counter_matches_independent_count(kind, b, nq, ns, k):
    make = _grid_clusters if kind == "clusters" else _grid
    qsp, sup4, _, _ = topk_scan._ring_inputs(_t(make(47, b, nq)),
                                             _t(make(48, b, ns)), False)
    counts = torch.empty((b, qsp.shape[1] // 32), dtype=torch.int32)
    d, i, st = topk_scan.knn_ring_torch(qsp, sup4, k, stats=True,
                                        counts=counts)
    np.testing.assert_array_equal(
        counts.numpy(), _independent_warp_scans(qsp.numpy(), sup4.numpy(), k))
    # the same lists without the counters; the warps scan fewer sub-chunks
    # than their tiles' visited chunks hold
    d2, i2, _ = topk_scan.knn_ring_torch(qsp, sup4, k)
    assert torch.equal(d, d2) and torch.equal(i, i2)
    per_tile = counts.reshape(b, -1, 16).sum(dim=2)
    assert (per_tile <= 16 * 16 * st[..., 0]).all()
    assert (per_tile < 16 * 16 * st[..., 0]).any()


def test_knn_ring_stats_on_real_clouds():
    q, s = _normal(37, 2, 300, 1536)
    d, i, st = topk_scan.knn_ring_stats(_t(q), _t(s), 8)
    rd, ri, rst = jax_topk.knn_ring_stats(jnp.asarray(q), jnp.asarray(s), 8)
    _assert_knn((d, i), (rd, ri))
    assert st.keys() == rst.keys() and st["chunks"] == rst["chunks"]
    for key in ("visit_rate", "trips_per_visit", "steps_per_visit"):
        np.testing.assert_allclose(st[key], rst[key], rtol=0.01)


# ---------------------------------------------------------------------------
# ops: the ring dispatch, knn_path, duplicate_shadow_mask, group_knn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_ops_knn_ring_values_and_grads_match_jax(ring_at_512, masked):
    rng = np.random.default_rng(38)
    q, s = _normal(39, 2, 300, 1024)
    mask = (np.arange(1024)[None] < np.array([[900], [717]])) if masked \
        else None
    jmask = None if mask is None else jnp.asarray(mask)
    assert grouping.knn_path(_t(q), _t(s), 8, _t(mask)) == (
        jax_grouping.knn_path(q, s, 8, jmask))
    w = rng.standard_normal((2, 300, 8)).astype(np.float32)

    def jloss(q, s):
        d, _ = jax_grouping.knn(q, s, 8, support_mask=jmask)
        return jnp.sum(d * w)

    rv, rg = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(q), jnp.asarray(s))
    tq, ts = _t(q).requires_grad_(), _t(s).requires_grad_()
    d, i = grouping.knn(tq, ts, 8, support_mask=_t(mask))
    value = (d * _t(w)).sum()
    value.backward()
    _assert_knn((d.detach(), i), jax_grouping.knn(
        jnp.asarray(q), jnp.asarray(s), 8, support_mask=jmask))
    np.testing.assert_allclose(value.item(), float(rv), rtol=RTOL)
    for g, r in zip((tq.grad, ts.grad), rg):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max())
    if masked:
        assert (ts.grad.numpy()[~mask] == 0).all()


def test_knn_path_markers(ring_at_512):
    q = torch.zeros(1, 128, 3)
    big, small = torch.zeros(1, 1024, 3), torch.zeros(1, 256, 3)
    mask = torch.ones(1, 1024, dtype=torch.bool)
    assert grouping.knn_path(q, big, 8) == "ring"
    assert grouping.knn_path(q, big, 8, mask) == "ring_masked"
    assert grouping.knn_path(q, small, 8) == "stream"
    assert topk_scan.RING_MIN_NS == 512


def test_knn_path_at_the_reference_threshold():
    assert topk_scan.RING_MIN_NS == jax_topk.RING_MIN_NS == 8192
    q = torch.zeros(1, 16, 3)
    assert grouping.knn_path(q, torch.zeros(1, 8192, 3), 16) == "ring"
    assert grouping.knn_path(q, torch.zeros(1, 8191, 3), 16) == "stream"


def _dup_cloud(seed, b, n):
    """A grid cloud (many exact duplicates) with a ragged valid mask."""
    x = _grid(seed, b, n)
    x[:, 50:90] = x[:, 0:40]
    mask = np.random.default_rng(seed + 1).uniform(size=(b, n)) < 0.8
    return x, mask


@pytest.mark.parametrize("masked", [False, True])
def test_duplicate_shadow_mask_matches_jax(masked):
    x, mask = _dup_cloud(40, 2, 600)
    mask = mask if masked else None
    ref = jax_grouping.duplicate_shadow_mask(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    got = grouping.duplicate_shadow_mask(_t(x), _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any()


@pytest.mark.parametrize("masked", [False, True])
def test_group_knn_unique_matches_jax(ring_at_512, masked):
    x, mask = _dup_cloud(42, 2, 1024)
    q = _grid(44, 2, 200)
    feats = np.random.default_rng(45).standard_normal(
        (2, 1024, 5)).astype(np.float32)
    mask = mask if masked else None
    for f in (None, feats):
        ref = jax_grouping.group_knn(
            6, jnp.asarray(q), jnp.asarray(x),
            None if f is None else jnp.asarray(f),
            None if mask is None else jnp.asarray(mask), unique=True)
        got = grouping.group_knn(6, _t(q), _t(x), _t(f), _t(mask),
                                 unique=True)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                                   rtol=RTOL, atol=0)
