"""K6's candidate test: the port's candidate mask, its sub-tile box table,
its f32 factor and the NN scan's work counter, against the JAX package and
against counts computed here.

On the card the NN scan (``nn_sorted.nn_scan``) decides its candidate
tiles itself, from the band's bounds; its plain version builds the
reference's mask (``_cand_mask``) in torch ops and scans it. Both must
give the reference's mask bitwise (the card tests hold the kernel's
``cand_out`` against ``_cand_mask``), so ``_cand_mask`` is held here
against the JAX package's on sorted, padded clouds: random, tie-grid and
poisoned, at the reference's tiles (512 rows, 64 columns, 64-point
sub-tiles) and at a small tile with two sub-tiles a tile. The JAX function
is plain XLA (no Pallas kernel); masks are compared bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.kernels import nn_sorted as jax_ns
from pytorch_points_tpu_torch.core.masking import BIG_COORD
from pytorch_points_tpu_torch.kernels import distance_tiles, nn_sorted
from torch_inputs import nn_inputs

KINDS = ["random", "grid", "masked"]
# (rows a p-tile, points a q-tile, points a fine sub-tile)
TILES = {"reference": (nn_sorted.TN, nn_sorted.TM, nn_sorted.FT),
         "small": (64, 32, 16)}
ALIGN = 512  # the pruned path's padding unit, max(TN, TM, TB)


def _clouds(kind, n=700, m=900):
    """(ps, qs, d_ub, qid): sorted, padded clouds as the sorted chamfer
    gives them to the scan. Poisoned clouds ("masked") take the masked
    route: valid points sorted over the valid AABB, poison last, band
    windows centred by the valid counts, bound -1 on poisoned rows."""
    p, q = (torch.from_numpy(a) for a in nn_inputs(kind, n, m))
    n_pad = -(-n // ALIGN) * ALIGN
    m_pad = -(-m // ALIGN) * ALIGN
    if kind == "masked":
        pv, qv = p[..., 0].abs() < BIG_COORD, q[..., 0].abs() < BIG_COORD
        ps, _, pvs = nn_sorted.sort_by_morton_masked(p, pv)
        qs, perm_q, _ = nn_sorted.sort_by_morton_masked(q, qv)
        pp = nn_sorted._pad_poison(ps, n_pad, 1.0)
        qp = nn_sorted._pad_poison(qs, m_pad, -1.0)
        pvs = torch.nn.functional.pad(pvs, (0, n_pad - n))
        cen = nn_sorted._band_centers(pv.sum(1), qv.sum(1), n_pad // ALIGN,
                                      m_pad // ALIGN, ALIGN)
        band = nn_sorted.band_min_dynamic(pp, qp, cen)
        d_ub = torch.where(pvs, band, -1.0)
    else:
        ps, _ = nn_sorted.sort_by_morton(p)
        qs, perm_q = nn_sorted.sort_by_morton(q)
        pp = nn_sorted._pad_poison(ps, n_pad, 1.0)
        qp = nn_sorted._pad_poison(qs, m_pad, -1.0)
        d_ub = nn_sorted.band_min(pp, qp, tb=nn_sorted.TB,
                                  tbq=nn_sorted.TBQ, stride=nn_sorted.STRIDE)
        d_ub[:, n:] = -1.0
    return pp, qp, d_ub, nn_sorted._pad_ids(perm_q, m_pad)


def _np_pass(ps, qs, d_ub, ft):
    """[B, n, m / ft] bool, each row's own candidate test against each
    sub-tile box, in numpy float32 (each operation rounded alone, the
    reference's order)."""
    ps, qs, d_ub = ps.numpy(), qs.numpy(), d_ub.numpy()
    b, m = qs.shape[:2]
    qt = qs.reshape(b, m // ft, ft, 3)
    lo, hi = qt.min(axis=2)[:, None], qt.max(axis=2)[:, None]
    lb = np.zeros((b, ps.shape[1], m // ft), np.float32)
    for c in range(3):
        pc = ps[:, :, None, c]
        gap = np.maximum(np.maximum(lo[..., c] - pc, pc - hi[..., c]),
                         np.float32(0.0))
        lb = lb + gap * gap
    return lb * np.float32(1.0 - 1e-5) <= d_ub[:, :, None]


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("kind", KINDS)
def test_cand_mask_matches_jax(kind, tiles):
    ktn, ktm, ft = TILES[tiles]
    ps, qs, d_ub, _ = _clouds(kind)
    got = nn_sorted._cand_mask(ps, qs, d_ub, ft, ktn, ktm)
    ref = jax_ns._cand_mask(*(jnp.asarray(a.numpy()) for a in (ps, qs, d_ub)),
                            ft, ktn, ktm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.sum() < got.numel()  # some pruning, some candidates


def test_lb_scale_is_the_reference_f32_constant():
    # torch and JAX multiply an f32 tensor by the Python float in f32; the
    # CUDA scan's literal 0x1.fffeb0p-1f is these bits
    one = torch.ones(4, dtype=torch.float32) * nn_sorted.LB_SCALE
    ref = np.asarray(jnp.ones(4, jnp.float32) * (1.0 - 1e-5))
    assert one.dtype == torch.float32 and ref.dtype == np.float32
    bits = one.numpy().view(np.uint32)
    assert (bits == 0x3F7FFF58).all()
    assert (ref.view(np.uint32) == 0x3F7FFF58).all()
    assert float.fromhex("0x1.fffeb0p-1") == float(np.float32(1.0 - 1e-5))


@pytest.mark.parametrize("kind", KINDS)
def test_sub_tile_boxes_match_reference(kind):
    _, qs, _, _ = _clouds(kind)
    ft = nn_sorted.FT
    lo, hi = nn_sorted.sub_tile_boxes_torch(qs, ft)
    qt = jnp.asarray(qs.numpy()).reshape(qs.shape[0], -1, ft, 3)
    for got, ref in ((lo, jnp.min(qt, axis=2)), (hi, jnp.max(qt, axis=2))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("kind", KINDS)
def test_scan_work_counter_matches_independent_count(kind, tiles):
    ktn, ktm, ft = TILES[tiles]
    ps, qs, d_ub, qid = _clouds(kind)
    b, n = d_ub.shape
    ni, nj = n // ktn, qs.shape[1] // ktm
    ok = _np_pass(ps, qs, d_ub, ft).reshape(b, n, nj, ktm // ft).any(axis=3)
    warps = ok.reshape(b, ni, ktn // nn_sorted.SCAN_WARP_ROWS,
                       nn_sorted.SCAN_WARP_ROWS, nj).any(axis=3)
    counts = torch.full((b, ni, 2), -1, dtype=torch.int32)
    cand = torch.zeros((b, ni, nj), dtype=torch.bool)
    # the scan's sub-tile is its tile (ft = tm): count at ft = ktm
    ok_t = _np_pass(ps, qs, d_ub, ktm)
    warps_t = ok_t.reshape(b, ni, ktn // nn_sorted.SCAN_WARP_ROWS,
                           nn_sorted.SCAN_WARP_ROWS, nj).any(axis=3)
    nn_sorted.nn_scan_torch(ps, qs, qid, d_ub, ktn, ktm, cand_out=cand,
                            counts=counts)
    np.testing.assert_array_equal(counts[..., 0].numpy(),
                                  warps_t.any(axis=2).sum(axis=2))
    np.testing.assert_array_equal(counts[..., 1].numpy(),
                                  warps_t.sum(axis=(2, 3)))
    np.testing.assert_array_equal(cand.numpy(), warps_t.any(axis=2))
    # finer skipping is real: warps visit fewer (warp, tile) pairs than the
    # block-level mask implies; and the numpy test agrees with the torch
    # one at the sub-tile size too
    assert counts[..., 1].sum() < counts[..., 0].sum() * (
        ktn // nn_sorted.SCAN_WARP_ROWS)
    np.testing.assert_array_equal(
        warps.any(axis=2),
        nn_sorted._cand_mask(ps, qs, d_ub, ft, ktn, ktm).numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_nn_scan_plain_equals_masked_scan_and_dense(kind):
    ps, qs, d_ub, qid = _clouds(kind)
    d, i = nn_sorted.nn_scan(ps, qs, qid, d_ub)
    cand = nn_sorted._cand_mask(ps, qs, d_ub, nn_sorted.FT, nn_sorted.TN,
                                nn_sorted.TM)
    rd, ri = nn_sorted.nn_resident_torch(ps, qs, qid, cand, nn_sorted.TN,
                                         nn_sorted.TM)
    # the dense answer in the scan's tie rule: the lowest ORIGINAL id
    full = torch.stack([distance_tiles.sqdist_rows(a, c)
                        for a, c in zip(ps, qs)])
    dd = full.amin(dim=2)
    di = torch.where(full == dd[..., None], qid[:, None, :],
                     nn_sorted.SENTINEL).amin(dim=2)
    ok = d_ub >= 0
    assert torch.equal(d[ok], rd[ok]) and torch.equal(i[ok], ri[ok])
    assert torch.equal(d[ok], dd[ok]) and torch.equal(i[ok], di[ok])
    assert (d[~ok] == float("inf")).all()
    assert (i[~ok] == nn_sorted.SENTINEL).all()
