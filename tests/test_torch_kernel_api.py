"""The ``kernels`` modules' API against the JAX package: return types,
the reference's tile arguments and names.

The reference runs its Pallas kernels in interpret mode on the CPU (its
kernel functions call ``pallas_call`` directly; ``force_impl("pallas")``
covers what dispatches). Where the port's result does not depend on a tile
argument it accepts it and changes nothing, so each such call is held
bitwise against the same call without it, and the reference with the same
arguments is held as the other port tests hold it. Sizes are small: the
file runs in seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.kernels import distance_tiles as jax_dt
from pytorch_points_tpu.kernels import fps as jax_fps
from pytorch_points_tpu.kernels import gather as jax_gather
from pytorch_points_tpu.kernels import nn_sorted as jax_ns
from pytorch_points_tpu.kernels import scatter as jax_scatter
from pytorch_points_tpu.kernels import topk_scan as jax_topk
from pytorch_points_tpu_torch.kernels import (
    ballquery,
    distance_tiles,
    fps,
    gather,
    nn_sorted,
    scatter,
    topk_scan,
)
from torch_inputs import nn_inputs, scatter_inputs

RTOL = 1e-6  # interpret-mode XLA contracts some multiply-adds (SKILL.md)
EPS32 = 2.0**-24


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _grid(seed, b, n):
    """Dyadic-grid clouds k/64: every distance exact in f32, many ties."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-64, 65, (b, n, 3)) / 64).astype(np.float32)


@pytest.fixture
def pallas():
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


def _same(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_fps_returns_indices_unless_coords_are_asked_for():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    ref_idx = np.asarray(jax_fps.furthest_point_sample(jnp.asarray(xyz), 8))
    ref_both = jax_fps.furthest_point_sample(jnp.asarray(xyz), 8,
                                             emit_coords=True)
    idx = fps.furthest_point_sample(_t(xyz), 8)
    assert isinstance(idx, torch.Tensor) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    idx2, coords = fps.furthest_point_sample(_t(xyz), 8, emit_coords=True)
    np.testing.assert_array_equal(idx2.numpy(), np.asarray(ref_both[0]))
    np.testing.assert_array_equal(coords.numpy(), np.asarray(ref_both[1]))


def test_knn_with_tiles_takes_the_streaming_scan(monkeypatch):
    # supports of 512 points take the ring in both packages, unless tq or
    # tm is given: then the reference runs its streaming scan, and so must
    # the port
    jax.clear_caches()
    monkeypatch.setattr(jax_topk, "RING_MIN_NS", 512)
    monkeypatch.setattr(topk_scan, "RING_MIN_NS", 512)
    rings = []
    real_ring = topk_scan._ring
    monkeypatch.setattr(topk_scan, "_ring",
                        lambda *a, **k: rings.append(1) or real_ring(*a, **k))
    q, s = _grid(1, 2, 200), _grid(2, 2, 512)
    ref = jax_topk.knn(jnp.asarray(q), jnp.asarray(s), 4, tq=128)
    got = topk_scan.knn(_t(q), _t(s), 4, tq=128)
    assert not rings
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    _same(topk_scan.knn(_t(q), _t(s), 4, tm=64), got)
    assert not rings
    _same(topk_scan.knn(_t(q), _t(s), 4), got)  # the ring, same bits
    assert rings
    jax.clear_caches()


@pytest.mark.parametrize("masked", [False, True])
def test_knn_passes_impl_on_to_the_ring(monkeypatch, masked):
    # the tile arguments sit before ``impl`` now: every route must still
    # receive the caller's impl (on a CPU tensor "auto" hides a lost one)
    monkeypatch.setattr(topk_scan, "RING_MIN_NS", 512)
    asked = []
    real = topk_scan.dispatch.resolve
    monkeypatch.setattr(topk_scan.dispatch, "resolve",
                        lambda impl, t, op: asked.append((impl, op))
                        or real(impl, t, op))
    q, s = _grid(14, 1, 100), _grid(15, 1, 512)
    topk_scan.knn(_t(q), _t(s), 4, masked=masked, impl="torch")
    assert asked == [("torch", "knn_ring_masked" if masked else "knn_ring")]


def test_ring_takes_the_reference_tiles():
    q, s = _grid(3, 1, 300), _grid(4, 1, 600)
    base = topk_scan.knn_ring(_t(q), _t(s), 5)
    _same(topk_scan.knn_ring(_t(q), _t(s), 5, tq=256, tm=256, unroll=3),
          base)
    _same(topk_scan.knn_ring(_t(q), _t(s), 5, 512, 512, 2), base)
    poisoned = s.copy()
    poisoned[0, 500:, 0] = -2.0e4 - 4.0 * np.arange(100)
    _same(topk_scan.knn_ring_masked(_t(q), _t(poisoned), 5, tq=256, tm=256,
                                    unroll=1),
          topk_scan.knn_ring_masked(_t(q), _t(poisoned), 5))


def test_ring_stats_refuse_other_tiles():
    q = _grid(5, 1, 300)
    d, i, stats = topk_scan.knn_ring_stats(_t(q), _t(q), 4, tq=512, tm=512,
                                           unroll=2)
    _same((d, i), topk_scan.knn_ring(_t(q), _t(q), 4))
    assert stats["chunks"] == 1
    for tiles in ({"tq": 256}, {"tm": 256}):
        with pytest.raises(ValueError, match="tq=512 and tm=512"):
            topk_scan.knn_ring_stats(_t(q), _t(q), 4, **tiles)


def _tile_calls():
    """(name, call with the reference's tile arguments, call without)."""
    p, q = nn_inputs("random", 300, 200)
    pm, qm = nn_inputs("masked", 300, 200)
    ps, _ = nn_sorted.sort_by_morton(_t(p))
    qs, _ = nn_sorted.sort_by_morton(_t(q))
    rng = np.random.default_rng(6)
    f = _t(rng.standard_normal((2, 300, 5)).astype(np.float32))
    idx = _t(rng.integers(0, 300, (2, 700)).astype(np.int32))
    cen = _t(p[:, :40])
    tiles = dict(tn=256, tm=32, ft=32, tb=256)

    def dense(fn):
        return lambda **a: fn(_t(p), _t(q), **{
            k: v for k, v in a.items() if k in ("tn", "tm")})

    return {
        "nn_one_direction": dense(distance_tiles.nn_one_direction),
        "nn_both_directions": dense(distance_tiles.nn_both_directions),
        "nndistance_indexed": lambda **a: nn_sorted.nndistance_indexed(
            _t(p), _t(q), **a),
        "nndistance_indexed_masked":
            lambda **a: nn_sorted.nndistance_indexed_masked(
                _t(pm), _t(qm), **a),
        "nndistance_presorted": lambda **a: nn_sorted.nndistance_presorted(
            ps, qs, **a),
        "nndistance_sums": lambda **a: nn_sorted.nndistance_sums(
            _t(p), _t(q), **a),
        "gather_rows": lambda **a: gather.gather_rows(
            f, idx, **({"tk": 128} if a else {})),
        "gather_rows_t": lambda **a: gather.gather_rows_t(
            f, idx, **({"tk": 128} if a else {})),
        "ball_query": lambda **a: ballquery.ball_query(
            _t(p), cen, 0.3, 8, **({"tp": 64, "tm": 128} if a else {})),
    }, tiles


@pytest.mark.parametrize("name", sorted(_tile_calls()[0]))
def test_tile_arguments_are_accepted_and_change_nothing(name):
    calls, tiles = _tile_calls()
    _same(calls[name](**tiles), calls[name]())


def test_tile_arguments_match_the_reference(pallas):
    # the reference with its tile arguments set, on grid clouds (exact)
    p, q = nn_inputs("grid", 300, 200)
    ref = jax_dt.nn_both_directions(jnp.asarray(p), jnp.asarray(q), tn=128,
                                    tm=64)
    got = distance_tiles.nn_both_directions(_t(p), _t(q), tn=128, tm=64)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    f = np.random.default_rng(7).standard_normal((2, 300, 5)).astype(
        np.float32)
    idx = np.random.default_rng(8).integers(0, 300, (2, 700)).astype(
        np.int32)
    ref = jax_gather.gather_rows(jnp.asarray(f), jnp.asarray(idx), tk=256)
    np.testing.assert_array_equal(
        gather.gather_rows(_t(f), _t(idx), tk=256).numpy(), np.asarray(ref))


def _row_stats(idx, upd, n):
    """Per output row: update count and sum of |u| (each [B,n,1])."""
    b = idx.shape[0]
    count = np.zeros((b, n, 1))
    abs_sum = np.zeros((b, n, upd.shape[-1]))
    for bi in range(b):
        ok = (idx[bi] >= 0) & (idx[bi] < n)
        np.add.at(count[bi], idx[bi][ok], 1.0)
        np.add.at(abs_sum[bi], idx[bi][ok], np.abs(upd[bi][ok]))
    return count, abs_sum


@pytest.mark.parametrize("form", ["csum", "csum_t2", "csum_t3"])
@pytest.mark.parametrize("case", ["duplicates", "permutation",
                                  "out_of_range"])
def test_scatter_csum_names_match_the_reference(form, case):
    idx, upd, n = scatter_inputs(case)
    if form == "csum":
        ref = jax_scatter.scatter_add_csum(jnp.asarray(idx), jnp.asarray(upd),
                                           n, tk=512)
        out = scatter.scatter_add_csum(_t(idx), _t(upd), n, tk=512)
    else:
        parts = int(form[-1])
        ref = jax_scatter.scatter_add_csum_t(
            jnp.asarray(idx), jnp.asarray(upd), n, tk=512, parts=parts)
        out = scatter.scatter_add_csum_t(_t(idx), _t(upd), n, tk=512,
                                         parts=parts)
    _same(out, scatter.scatter_add(_t(idx), _t(upd), n))
    ref, out = np.asarray(ref), out.numpy()
    count, abs_sum = _row_stats(idx, upd, n)
    # K4's stated tolerance against the reference (test_torch_chamfer.py):
    # two f32 summation orders with 3 parts, the bf16 split's 2^-14 with 2
    if form == "csum_t3":
        if case == "permutation":
            np.testing.assert_array_equal(out, ref)
        assert (np.abs(out - ref) <= 2 * count * EPS32 * abs_sum).all()
    else:
        assert (np.abs(out - ref) <= 2.0**-14 * abs_sum).all()


def test_nndistance_sorted_matches_the_reference(pallas):
    p, q = _grid(9, 2, 300), _grid(10, 2, 250)
    ref = jax_ns.nndistance_sorted(jnp.asarray(p), jnp.asarray(q))
    got = nn_sorted.nndistance_sorted(_t(p), _t(q))
    assert len(got) == 6
    for g, r in zip(got, ref):
        assert g.dtype == (torch.float32 if r.dtype == jnp.float32
                           else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    _same(nn_sorted.nndistance_sorted(_t(p), _t(q), tn=256, tm=32, ft=32,
                                      tb=256), got)


def _assert_stats(got, ref):
    for key in ("count1", "count2"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    assert got["k_max"] == ref["k_max"]
    assert float(got["occupancy"]) == float(ref["occupancy"])
    assert bool(got["overflow"]) == bool(ref["overflow"])


@pytest.mark.parametrize("tiles", [{}, dict(tn=256, tm=32, ft=32, tb=256)],
                         ids=["default", "small"])
def test_worklist_stats_match_the_reference(pallas, tiles):
    # at both tile sets the band's stride-4 subsample of q holds a whole
    # window tile of 128
    p, q = _grid(11, 2, 700), _grid(12, 2, 600)
    q[1] = p[1, :600]  # a cloud whose candidates fit the budget
    ref = jax_ns.worklist_stats(jnp.asarray(p), jnp.asarray(q), **tiles)
    got = nn_sorted.worklist_stats(_t(p), _t(q), **tiles)
    _assert_stats(got, ref)
    rng = np.random.default_rng(13)
    pm = rng.uniform(size=(2, 700)) < 0.75
    qm = rng.uniform(size=(2, 600)) < 0.75
    # the reference's masked twin is not jitted: one compile, not op by op
    masked = jax.jit(jax_ns.worklist_stats_masked,
                     static_argnames=("tn", "tm", "ft", "tb"))
    ref = masked(jnp.asarray(p), jnp.asarray(q), jnp.asarray(pm),
                 jnp.asarray(qm), **tiles)
    got = nn_sorted.worklist_stats_masked(_t(p), _t(q), _t(pm), _t(qm),
                                          **tiles)
    _assert_stats(got, ref)
