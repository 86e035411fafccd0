"""Edges of the ball query (K2) and the worklist NN that their CUDA kernels'
designs lean on, held on the CPU.

* K2 scans in steps (``ballquery.SCAN_STEP`` points, 32 a warp ballot) and
  stops at each centroid's own ``nsample``-th hit. The plain versions,
  ``ball_query`` and ``ball_query_and_group_coords``, are held against the
  JAX package's Pallas kernels (``pytorch_points_tpu.kernels.ballquery``,
  interpret mode on the CPU) at nsample 1, 31, 32, 33 and 64 on clouds of
  333 points whose planted hits put the nsample-th hit on the last point
  of a 32-point chunk, of a step and of the cloud, with zero-hit rows and
  masked support: idx and cnt exactly equal, g bitwise (one float32
  subtraction of the same two numbers on both sides).
* K2's work counter (``counts``): the plain versions' count equals a
  numpy count that walks the steps as the kernel does.
* The worklist NN's kernel merges each pair's row and column minima as
  64-bit keys (float bits of d << 32 | position) by atomicMin, in whatever
  order its blocks run. A torch emulation of that merge, pairs taken in
  shuffled orders, equals ``run_worklist_torch`` bitwise on dyadic-grid
  clouds (k/8: every distance exact, many ties) and on real-valued clouds,
  with
  the list whole and cut at ``k_max`` (rows no pair reaches stay (inf, 0)):
  the CPU proof that the order of the atomics cannot change a bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.kernels import ballquery as jax_bq
from pytorch_points_tpu_torch.kernels import ballquery, distance_tiles
from torch_inputs import BQ_EDGE_NSAMPLES, bq_edge_inputs, cloud

RADIUS = 0.2


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _counts(fn, *args):
    """fn's outputs and the [B,P] work counter it fills."""
    counts = torch.full(args[1].shape[:2], -1, dtype=torch.int32)
    return fn(*args, counts=counts), counts


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nsample", BQ_EDGE_NSAMPLES)
def test_ball_query_step_edges_match_pallas(nsample, masked):
    xyz, cen, mask = bq_edge_inputs(nsample, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jax_bq.ball_query(jnp.asarray(xyz), jnp.asarray(cen), RADIUS,
                            nsample, jmask)
    got, counts = _counts(lambda *a, counts: ballquery.ball_query(
        *a, RADIUS, nsample, _t(mask), counts=counts), _t(xyz), _t(cen))
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    cnt = got[1].numpy()
    assert (cnt[:, 1] == 0).all()  # the far centroid
    if not masked:  # the planted hits, in index order
        assert (cnt[:4, 0] == nsample).all() and cnt[4, 0] == nsample - 1
        np.testing.assert_array_equal(
            got[0].numpy()[[0, 1, 2, 3], 0, nsample - 1],
            [63, 95, 127, xyz.shape[1] - 1])
    np.testing.assert_array_equal(counts.numpy(),
                                  _kernel_walk(xyz, cen, mask, nsample))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nsample", BQ_EDGE_NSAMPLES)
def test_coords_ball_query_step_edges_match_pallas(nsample, masked):
    xyz, cen, mask = bq_edge_inputs(nsample, masked)
    if masked:
        mask[:, 0] = False  # zero-hit rows fill from the unpoisoned point 0
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jax_bq.ball_query_and_group_coords(
        jnp.asarray(xyz), jnp.asarray(cen), RADIUS, nsample, jmask)
    got, counts = _counts(
        lambda *a, counts: ballquery.ball_query_and_group_coords(
            *a, RADIUS, nsample, _t(mask), counts=counts), _t(xyz), _t(cen))
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert [g.dtype for g in got] == [torch.int32, torch.int32,
                                      torch.float32]
    np.testing.assert_array_equal(counts.numpy(),
                                  _kernel_walk(xyz, cen, mask, nsample))


def _kernel_walk(xyz, cen, mask, nsample, radius=RADIUS):
    """The points the kernel's scan tests for each centroid, in numpy: the
    support walked in steps of SCAN_STEP points, stopping after the step
    that brings the hit count to nsample."""
    step = ballquery.SCAN_STEP
    r2 = np.float32(ballquery.squared_radius(radius))
    b, n, _ = xyz.shape
    out = np.zeros(cen.shape[:2], np.int32)
    for bi in range(b):
        for pi in range(cen.shape[1]):
            diff = cen[bi, pi][None] - xyz[bi]  # float32, one rounding each
            sq = diff * diff
            hit = ((sq[:, 0] + sq[:, 1]) + sq[:, 2]) < r2
            if mask is not None:
                hit &= mask[bi]
            found, out[bi, pi] = 0, n
            for base in range(0, n, step):
                found += int(hit[base : base + step].sum())
                if found >= nsample:
                    out[bi, pi] = min(n, base + step)
                    break
    return out


def test_ball_query_counter_on_a_uniform_cloud():
    # 3000 points: scans that stop inside the cloud, in whole steps
    rng = np.random.default_rng(51)
    xyz = cloud(rng, 2, 3000)
    cen = xyz[:, rng.choice(3000, 64, replace=False)].copy()
    for nsample in (4, 32):
        (_, cnt), counts = _counts(lambda *a, counts: ballquery.ball_query(
            *a, 0.3, nsample, counts=counts), _t(xyz), _t(cen))
        got = counts.numpy()
        np.testing.assert_array_equal(
            got, _kernel_walk(xyz, cen, None, nsample, 0.3))
        assert ((got % ballquery.SCAN_STEP == 0) | (got == 3000)).all()
        assert (got < 3000).any()
        assert (got[cnt.numpy() < nsample] == 3000).all()


# ---------------------------------------------------------------------------
# the worklist NN's order-free merge
# ---------------------------------------------------------------------------

TN, TM = 128, 64
NONE_KEY = 0x7F800000 << 32  # (inf, 0)


def _keys(d, pos):
    """Packed keys, int64: float bits of d (d >= +0) << 32 | position."""
    return (d.view(torch.int32).to(torch.int64) << 32) | pos.to(torch.int64)


def _merge_emulation(pp, qp, codes1, count, tn, tm, order_rng):
    """The kernel's merge: every (p-tile, q-tile) pair of the list's first
    min(count, k_max) entries, in a shuffled order, its distance tile once,
    each row's and each column's key minimum folded into the keys by a
    minimum; then the keys unpacked."""
    b, n_pad, _ = pp.shape
    m_pad = qp.shape[1]
    nj = m_pad // tm
    pkeys = torch.full((b, n_pad), NONE_KEY, dtype=torch.int64)
    qkeys = torch.full((b, m_pad), NONE_KEY, dtype=torch.int64)
    for bi in range(b):
        live = codes1[bi, : min(int(count[bi]), codes1.shape[1])]
        for code in live[torch.from_numpy(order_rng.permutation(len(live)))]:
            r0, c0 = int(code) // nj * tn, int(code) % nj * tm
            d = distance_tiles.sqdist_rows(pp[bi, r0 : r0 + tn],
                                           qp[bi, c0 : c0 + tm])
            rows = torch.arange(r0, r0 + tn)
            cols = torch.arange(c0, c0 + tm)
            row_min = _keys(d, cols[None].expand(tn, tm)).amin(dim=1)
            col_min = _keys(d, rows[:, None].expand(tn, tm)).amin(dim=0)
            pkeys[bi, rows] = torch.minimum(pkeys[bi, rows], row_min)
            qkeys[bi, cols] = torch.minimum(qkeys[bi, cols], col_min)

    def unpack(keys):
        d = (keys >> 32).to(torch.int32).view(torch.float32)
        return d, (keys & 0xFFFFFFFF).to(torch.int32)

    return (*unpack(pkeys), *unpack(qkeys))


def _merge_case(kind, seed=41, b=2, n=600, m=500):
    rng = np.random.default_rng(seed)
    p, q = (cloud(rng, b, k, "random" if kind == "uniform" else "grid")
            for k in (n, m))
    n_pad, m_pad = -(-n // TN) * TN, -(-m // TM) * TM
    pp = distance_tiles._pad_poison(_t(p), n_pad, 1.0)
    qp = distance_tiles._pad_poison(_t(q), m_pad, -1.0)
    ni, nj = n_pad // TN, m_pad // TM
    cand = rng.uniform(size=(b, ni, nj)) < 0.3
    for bi in range(b):
        cand[bi, np.arange(ni), rng.integers(0, nj, ni)] = True
        cand[bi, rng.integers(0, ni, nj), np.arange(nj)] = True
    return pp, qp, _t(cand), rng


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("kind", ["grid", "uniform"])
def test_worklist_key_merge_in_any_order_equals_plain(kind, cut):
    pp, qp, cand, rng = _merge_case(kind)
    counts = cand.reshape(cand.shape[0], -1).sum(1)
    k_max = int(counts.min()) - 7 if cut else int(counts.max())
    codes1, codes2, count = distance_tiles._worklist_codes(cand, k_max)
    ref = distance_tiles.run_worklist_torch(pp, qp, codes1, codes2, count,
                                            TN, TM)
    for _ in range(2):  # two shuffled orders
        got = _merge_emulation(pp, qp, codes1, count, TN, TM, rng)
        for g, r in zip(got, ref, strict=True):
            assert g.dtype == r.dtype and torch.equal(g, r)
    if cut:  # some p tile is left without a pair: its rows stay (inf, 0)
        unreached = torch.isinf(ref[0])
        assert unreached.any() and (ref[1][unreached] == 0).all()
    if kind == "grid":  # the grid has ties the keys must break by position
        d = distance_tiles.sqdist_rows(pp[0, :TN], qp[0, :TM])
        assert ((d == d.amin(dim=1, keepdim=True)).sum(dim=1) > 1).any()
