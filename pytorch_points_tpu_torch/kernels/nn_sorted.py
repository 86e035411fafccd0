"""Morton-sorted, bound-pruned nearest neighbour (kernel K6: band pass and
resident NN scan).

CUDA kernels: ``csrc/nn_sorted.cu``, which replaces the TPU kernels
``pytorch_points_tpu/kernels/nn_sorted.py::_band_kernel`` (``band_min``)
and ``::_nn_resident_kernel`` (``_run_resident``). The header note there
says what bounds them on the card and why no worklist budget is needed.

The pipeline, as in the JAX package: sort both clouds along a Morton curve
(stable, so the permutation is the reference's); pad them with poison to
whole tiles; bound each point's NN distance from above with the band pass;
mark the (p-tile, q-tile) pairs whose AABB lower bound does not exceed the
bound of some point of the p-tile (``_cand_mask``, torch ops); scan only
those pairs. The scan carries each point's ORIGINAL index and keeps the
lowest on ties, so its results equal the dense kernel (K5) on the original
clouds, distances and indices bitwise.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.core.masking import BIG_COORD
from pytorch_points_tpu_torch.kernels import _build, dispatch
from pytorch_points_tpu_torch.kernels.distance_tiles import (
    _PLAIN_PAIRS,
    sqdist_rows,
)
from pytorch_points_tpu_torch.kernels.scatter import scatter_add

# Tile sizes of the reference's nndistance_indexed / nndistance_sums:
# resident rows (tn) and columns (tm), fine AABB sub-tiles (ft), band rows
# (tb), band window tiles (tbq) over q subsampled by ``STRIDE``.
TN, TM, FT, TB, TBQ, STRIDE = 512, 64, 64, 512, 128, 4
SENTINEL = 2**30  # index of a row that saw no candidate (reference value)


def _morton_codes(xyz: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """[B,N,3] -> [B,N] int64 Morton codes over each cloud's AABB, in the
    reference's operation order (its uint32 codes, held in int64)."""
    lo = xyz.amin(dim=1, keepdim=True)
    hi = xyz.amax(dim=1, keepdim=True)
    t = (xyz - lo) / torch.clamp_min(hi - lo, 1e-12)
    q = (t * (2**bits - 1)).to(torch.int64).clamp_(0, 2**bits - 1)

    def spread(v):  # spread 10 bits to every 3rd bit
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (
        spread(q[..., 2]) << 2)


def sort_by_morton(x: torch.Tensor):
    """[B,N,3] -> (sorted [B,N,3], perm [B,N] int32), sorted = x[perm]; a
    stable sort, as ``jax.lax.sort`` is."""
    x = x.to(torch.float32)
    perm = torch.sort(_morton_codes(x), dim=1, stable=True).indices
    return x.gather(1, perm[..., None].expand_as(x)), perm.to(torch.int32)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pad_poison(x: torch.Tensor, target_n: int, sign: float) -> torch.Tensor:
    """Pad [B,N,3] to [B,target_n,3] with the reference's far-away,
    mutually distant rows, sign * (4 BIG_COORD + 8 i) along x."""
    b, n, c = x.shape
    if n == target_n:
        return x
    pad = x.new_zeros((b, target_n - n, c))
    pad[..., 0] = sign * (BIG_COORD * 4.0 + 8.0 * torch.arange(
        target_n - n, dtype=x.dtype, device=x.device))
    return torch.cat([x, pad], dim=1)


def _pad_ids(ids: torch.Tensor, target_n: int) -> torch.Tensor:
    """Pad [B,N] int32 ids with N, N+1, ... (padding is never an NN)."""
    b, n = ids.shape
    extra = torch.arange(n, target_n, dtype=torch.int32, device=ids.device)
    return torch.cat([ids, extra.expand(b, -1)], dim=1)


# ---------------------------------------------------------------------------
# band pass: per-point upper bound
# ---------------------------------------------------------------------------


def _band_windows(centers, ni: int, njq: int, device) -> torch.Tensor:
    """[B or 1, ni, 3] q-tile indices clamp(center + {-1, 0, +1})."""
    if centers is None:
        centers = (torch.arange(ni, device=device) * njq // ni)[None]
    w = centers.long()[..., None] + torch.arange(-1, 2, device=device)
    return w.clamp_(0, njq - 1)


def band_min_torch(ps: torch.Tensor, qsub: torch.Tensor, tb: int, tbq: int,
                   centers: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: [B,n,3] (n = ni*tb), [B,mq,3] (mq = njq*tbq) ->
    [B,n], each point's min squared distance over its tile's 3-tile q
    window."""
    b, n, _ = ps.shape
    ni, njq = n // tb, qsub.shape[1] // tbq
    win = _band_windows(centers, ni, njq, ps.device).expand(b, ni, 3)
    out = torch.empty((b, n), dtype=torch.float32, device=ps.device)
    for bi in range(b):
        qw = qsub[bi].reshape(njq, tbq, 3)[win[bi]].reshape(ni, 3 * tbq, 3)
        pr = ps[bi].reshape(ni, tb, 3)
        dx, dy, dz = (qw[:, None, :, c] - pr[:, :, None, c] for c in range(3))
        out[bi] = ((dx * dx + dy * dy) + dz * dz).amin(dim=2).reshape(n)
    return out


def band_min_cuda(ps: torch.Tensor, qsub: torch.Tensor, tb: int, tbq: int,
                  centers: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the band kernel: same contract as :func:`band_min_torch`."""
    b, n, _ = ps.shape
    mq = qsub.shape[1]
    ni = n // tb
    _build.require(ps, "nn_band ps", torch.float32, (b, n, 3))
    _build.require(qsub, "nn_band qsub", torch.float32, (b, mq, 3))
    if centers is not None:
        _build.require(centers, "nn_band centers", torch.int32, (b, ni))
    out = torch.empty((b, n), dtype=torch.float32, device=ps.device)
    err = _build.library().ppt_nn_band(
        ps.data_ptr(), qsub.data_ptr(), _build.ptr(centers), b, ni, mq, tb,
        tbq, out.data_ptr(), _build.stream(ps),
    )
    _build.check(err, "ppt_nn_band")
    band_min_cuda.launches += 1
    return out


band_min_cuda.launches = 0


def band_min(ps: torch.Tensor, qs: torch.Tensor, tb: int = TB,
             tbq: int | None = None, stride: int = 1,
             centers: torch.Tensor | None = None, impl: str = "auto"):
    """Per-point min d^2 over a ~3-tile rank window of the (sorted) other
    cloud: an upper bound on each point's NN distance.

    ``ps`` [B,n,>=3] with n a multiple of ``tb``; ``qs`` [B,m,>=3] is
    subsampled by ``stride`` and cut to whole ``tbq`` tiles first, as the
    reference does. The window of p-tile i is q-tiles clamp(c + {-1,0,+1})
    with c = i * njq // ni, or ``centers`` [B, ni] (masked clouds).
    """
    tbq = tb if tbq is None else tbq
    qs = qs[:, ::stride, :3]
    qs = qs[:, : qs.shape[1] - qs.shape[1] % tbq]
    ps = ps[..., :3]
    if ps.shape[1] % tb or qs.shape[1] == 0:
        raise ValueError(f"band_min: n={ps.shape[1]} must be a multiple of "
                         f"tb={tb} and q must hold a whole tbq={tbq} tile")
    if dispatch.resolve(impl, ps, "nn_band") == "cuda":
        if centers is not None:
            centers = centers.to(torch.int32).contiguous()
        return band_min_cuda(ps.contiguous(), qs.contiguous(), tb, tbq,
                             centers)
    return band_min_torch(ps, qs, tb, tbq, centers)


# ---------------------------------------------------------------------------
# candidate mask
# ---------------------------------------------------------------------------


def _cand_mask(ps: torch.Tensor, qs: torch.Tensor, d_ub: torch.Tensor,
               ft: int, ktn: int, ktm: int) -> torch.Tensor:
    """[B, nI, nJ] bool: q-tile J (ktm points) is needed by some point of
    p-tile I (ktn points). The exact AABB lower bound against fine ft-point
    q sub-tiles, OR-folded to kernel tiles; the (1 - 1e-5) factor absorbs
    the f32 rounding of the bound, as in the reference. Materialises
    [B, nI, ktn, nJ*ktm/ft] float temporaries (about 0.5 GB each at B=32
    N=M=16384)."""
    ps = ps[..., :3]
    qs = qs[..., :3]
    b, n, _ = ps.shape
    m = qs.shape[1]
    ni, nj, fpk = n // ktn, m // ktm, ktm // ft
    qt = qs.reshape(b, nj * fpk, ft, 3)
    qlo = qt.amin(dim=2)[:, None, None]  # [B, 1, 1, nJf, 3]
    qhi = qt.amax(dim=2)[:, None, None]
    pr = ps.reshape(b, ni, ktn, 1, 3)
    lb = None
    for c in range(3):
        pc = pr[..., c]
        gap = torch.maximum(qlo[..., c] - pc, pc - qhi[..., c]).clamp_min_(0.0)
        gap = gap.mul_(gap)
        lb = gap if lb is None else lb.add_(gap)
    ok = lb.mul_(1.0 - 1e-5) <= d_ub.reshape(b, ni, ktn, 1)
    return ok.any(dim=2).reshape(b, ni, nj, fpk).any(dim=3)


# ---------------------------------------------------------------------------
# resident NN scan over the candidate tile pairs
# ---------------------------------------------------------------------------


def nn_resident_torch(ps: torch.Tensor, qs: torch.Tensor, qid: torch.Tensor,
                      cand: torch.Tensor, tn: int, tm: int):
    """Plain version: the lexicographic minimum of (d^2, qid) over the q
    points of each row's candidate tiles. [B,np,3], [B,mp,3], [B,mp] int32,
    [B,np/tn,mp/tm] bool -> (d [B,np], id [B,np] int32); a row with no
    candidate gives (inf, SENTINEL)."""
    b, np_, _ = ps.shape
    mp = qs.shape[1]
    dist = torch.empty((b, np_), dtype=torch.float32, device=ps.device)
    ids = torch.empty((b, np_), dtype=torch.int32, device=ps.device)
    rows = tn * max(1, _PLAIN_PAIRS // (tn * mp))
    for bi in range(b):
        for s in range(0, np_, rows):
            e = min(s + rows, np_)
            ok = cand[bi, s // tn : e // tn].repeat_interleave(tn, 0)
            ok = ok.repeat_interleave(tm, 1)
            d = torch.where(ok, sqdist_rows(ps[bi, s:e], qs[bi]),
                            float("inf"))
            mn = d.amin(dim=1, keepdim=True)
            dist[bi, s:e] = mn[:, 0]
            ids[bi, s:e] = torch.where(ok & (d == mn), qid[bi],
                                       SENTINEL).amin(dim=1)
    return dist, ids


def nn_resident_cuda(ps: torch.Tensor, qs: torch.Tensor, qid: torch.Tensor,
                     cand: torch.Tensor, tn: int, tm: int):
    """Launch the resident NN kernel: same contract as
    :func:`nn_resident_torch`."""
    b, np_, _ = ps.shape
    mp = qs.shape[1]
    ni, nj = np_ // tn, mp // tm
    _build.require(ps, "nn_resident ps", torch.float32, (b, np_, 3))
    _build.require(qs, "nn_resident qs", torch.float32, (b, mp, 3))
    _build.require(qid, "nn_resident qid", torch.int32, (b, mp))
    _build.require(cand, "nn_resident cand", torch.bool, (b, ni, nj))
    if not (tn <= 1024 and tn % 32 == 0 and tn % tm == 0
            and tn * 16 + nj * 4 <= 200 * 1024):
        raise ValueError(f"nn_resident: unsupported tiles tn={tn} tm={tm} "
                         f"nj={nj}")
    dist = torch.empty((b, np_), dtype=torch.float32, device=ps.device)
    ids = torch.empty((b, np_), dtype=torch.int32, device=ps.device)
    err = _build.library().ppt_nn_resident(
        ps.data_ptr(), qs.data_ptr(), qid.data_ptr(), cand.data_ptr(), b, ni,
        nj, tn, tm, dist.data_ptr(), ids.data_ptr(), _build.stream(ps),
    )
    _build.check(err, "ppt_nn_resident")
    nn_resident_cuda.launches += 1
    return dist, ids


nn_resident_cuda.launches = 0


def nn_resident(ps: torch.Tensor, qs: torch.Tensor, qid: torch.Tensor,
                cand: torch.Tensor, tn: int = TN, tm: int = TM,
                impl: str = "auto"):
    """NN of each ps row among the qs points of its candidate tiles, ties to
    the lowest ``qid``: (d [B,np], id [B,np] int32)."""
    if ps.shape[1] % tn or qs.shape[1] % tm:
        raise ValueError(f"nn_resident: clouds must be whole tiles, got "
                         f"{ps.shape[1]} rows (tn={tn}), {qs.shape[1]} "
                         f"columns (tm={tm})")
    if dispatch.resolve(impl, ps, "nn_resident") == "cuda":
        return nn_resident_cuda(ps.contiguous(), qs.contiguous(),
                                qid.to(torch.int32).contiguous(),
                                cand.contiguous(), tn, tm)
    return nn_resident_torch(ps, qs, qid, cand, tn, tm)


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------


def _nn_sorted_space(ps, pid, qs, qid, impl):
    """Both directions on sorted clouds carrying ids [B,N] int32: rows in
    the given order, each the (distance, lowest id) of its NN."""
    n, m = ps.shape[1], qs.shape[1]
    align = max(TN, TM, TB)
    n_pad, m_pad = _round_up(n, align), _round_up(m, align)
    pp = _pad_poison(ps, n_pad, 1.0)
    qp = _pad_poison(qs, m_pad, -1.0)
    d_ub1 = band_min(pp, qp, tb=TB, tbq=TBQ, stride=STRIDE, impl=impl)
    d_ub2 = band_min(qp, pp, tb=TB, tbq=TBQ, stride=STRIDE, impl=impl)
    # Padding rows need no NN: no candidate at all (their bound is -1).
    d_ub1[:, n:] = -1.0
    d_ub2[:, m:] = -1.0
    cand1 = _cand_mask(pp, qp, d_ub1, FT, TN, TM)
    cand2 = _cand_mask(qp, pp, d_ub2, FT, TN, TM)
    d1, i1 = nn_resident(pp, qp, _pad_ids(qid, m_pad), cand1, impl=impl)
    d2, i2 = nn_resident(qp, pp, _pad_ids(pid, n_pad), cand2, impl=impl)
    return d1[:, :n], i1[:, :n], d2[:, :m], i2[:, :m]


def nndistance_presorted(ps: torch.Tensor, qs: torch.Tensor,
                         impl: str = "auto"):
    """Both directions on clouds already Morton-sorted: (d1 [B,N], i1,
    d2 [B,M], i2) in the given order, indices into the given other cloud,
    ties to the lowest of them; equal to the dense kernel on these clouds."""
    b, n, _ = ps.shape
    m = qs.shape[1]

    def iota(k):
        return torch.arange(k, dtype=torch.int32,
                            device=ps.device).expand(b, k)

    return _nn_sorted_space(ps.to(torch.float32), iota(n),
                            qs.to(torch.float32), iota(m), impl)


def _unpermute_rows(perm, d, i, n, impl):
    """out[perm[r]] = (d[r], i[r]): one [B,N,2] permutation scatter (K4),
    exact since every row receives one value (ids are exact in f32 below
    2^24)."""
    vals = torch.stack([d, i.to(torch.float32)], dim=-1)
    out = scatter_add(perm, vals, n, impl)
    return out[..., 0], out[..., 1].to(torch.int32)


def nndistance_indexed(p: torch.Tensor, q: torch.Tensor, impl: str = "auto"):
    """Bidirectional NN in ORIGINAL order with the reference's tie-breaks:
    the dense ``nn_both_directions(p, q)`` contract, served by the pruned
    scan. (d1 [B,N], i1 int32, d2 [B,M], i2)."""
    n, m = p.shape[1], q.shape[1]
    ps, perm_p = sort_by_morton(p)
    qs, perm_q = sort_by_morton(q)
    d1s, i1s, d2s, i2s = _nn_sorted_space(ps, perm_p, qs, perm_q, impl)
    d1, i1 = _unpermute_rows(perm_p, d1s, i1s, n, impl)
    d2, i2 = _unpermute_rows(perm_q, d2s, i2s, m, impl)
    return d1, i1, d2, i2


def nndistance_sums(p: torch.Tensor, q: torch.Tensor, impl: str = "auto"):
    """Loss-only twin of :func:`nndistance_indexed`: per-cloud sums of the
    NN distances, with no row un-permute.

    Returns ``(s1 [B], s2 [B], i1o [B,N], i2o [B,M], rows_p, rows_q, tgt_p,
    tgt_q)``: row r of ``rows_p`` (the sorted p cloud) has its nearest
    ORIGINAL q index at ``i1o[b, r]`` and came from original row
    ``tgt_p[b, r]``; likewise for q.
    """
    ps, perm_p = sort_by_morton(p)
    qs, perm_q = sort_by_morton(q)
    d1s, i1s, d2s, i2s = _nn_sorted_space(ps, perm_p, qs, perm_q, impl)
    return (d1s.sum(dim=-1), d2s.sum(dim=-1), i1s, i2s, ps, qs, perm_p,
            perm_q)
