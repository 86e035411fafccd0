"""Morton-sorted, bound-pruned nearest neighbour (kernel K6: band pass and
NN scan; kernel K7: the band pass with per-tile window centres, for masked
clouds).

CUDA kernels: ``csrc/nn_sorted.cu``, which replaces the TPU kernels
``pytorch_points_tpu/kernels/nn_sorted.py::_band_kernel`` (``band_min``),
``::_band_kernel_pf`` (``band_min_dynamic``, the same kernel given a
centre table) and ``::_nn_resident_kernel`` (``_run_resident``) with the
candidate mask in front of it (``_cand_mask``, XLA there). The header note
there says what bounds them on the card and why no worklist budget is
needed.

The pipeline, as in the JAX package: sort both clouds along a Morton curve
(stable, so the permutation is the reference's); pad them with poison to
whole tiles; bound each point's NN distance from above with the band pass;
mark the (p-tile, q-tile) pairs whose AABB lower bound does not exceed the
bound of some point of the p-tile; scan only those pairs. On the card the
NN scan (:func:`nn_scan`) decides the candidates itself, each warp for its
own 32 rows, from the bounds; its plain version builds the reference's
mask (:func:`_cand_mask`, torch ops) and scans it. The scan carries
each point's ORIGINAL index and keeps the lowest on ties, so its results
equal the dense kernel (K5) on the original clouds, distances and indices
bitwise. Masked (poisoned) clouds take
:func:`nndistance_indexed_masked`: valid points sorted over the valid
AABB with the poison last, and band windows centred by the valid counts.
The pipeline's band calls (:func:`_band_rows`, :func:`_band_rows_masked`)
compute only the rows the scan needs and give padding and poisoned rows
-1 directly, where the reference bounds every row and overwrites those.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.core.masking import BIG_COORD, poison_points
from pytorch_points_tpu_torch.kernels import _build, dispatch
from pytorch_points_tpu_torch.kernels.distance_tiles import (
    _PLAIN_PAIRS,
    _interleave,
    _morton_codes,
    _pad_poison,
    _round_up,
    sqdist_rows,
)
from pytorch_points_tpu_torch.kernels.scatter import scatter_add

_ppt_nn_band = _build.entry("ppt_nn_band")
_ppt_nn_scan = _build.entry("ppt_nn_scan")

# Tile sizes of the reference's nndistance_indexed / nndistance_sums:
# resident rows (tn) and columns (tm), fine AABB sub-tiles (ft), band rows
# (tb), band window tiles (tbq) over q subsampled by ``STRIDE``.
TN, TM, FT, TB, TBQ, STRIDE = 512, 64, 64, 512, 128, 4
SENTINEL = 2**30  # index of a row that saw no candidate (reference value)
# The candidate test's factor as an f32 tensor op applies it: float32(1 -
# 1e-5), the reference's constant.
LB_SCALE = 1.0 - 1e-5
# Rows a warp of the CUDA scan decides and scans together (a row a lane):
# the unit of its tile-visit counter.
SCAN_WARP_ROWS = 32
# The band kernel's warps (a row a lane), the sub-tiles of its window (the
# unit of its skip test and of its (warp, sub-tile) fold counter) and the
# groups of sub-tiles it orders and tests first.
BAND_WARP_ROWS, BAND_SUB, BAND_GROUP = 32, 16, 4


_INVALID_CODE = 0xFFFFFFFF  # the reference's max uint32 key: invalid last


def _morton_codes_masked(xyz: torch.Tensor, valid: torch.Tensor,
                         bits: int = 10) -> torch.Tensor:
    """Morton codes over the VALID points' AABB; invalid points get the max
    key, so they sort last. Poison coordinates would otherwise stretch the
    AABB until every valid point falls in one cell. The cell is clipped to
    [0, 2^bits - 1] before the integer cast, as the reference does."""
    v = valid[..., None]
    lo = torch.where(v, xyz, float("inf")).amin(dim=1, keepdim=True)
    hi = torch.where(v, xyz, float("-inf")).amax(dim=1, keepdim=True)
    t = (xyz - lo) / torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp(t * (2**bits - 1), 0.0, float(2**bits - 1))
    code = _interleave(q.to(torch.int64))
    return torch.where(valid, code, _INVALID_CODE)


def _sort_by_codes(x: torch.Tensor, code: torch.Tensor):
    perm = torch.sort(code, dim=1, stable=True).indices
    return x.gather(1, perm[..., None].expand_as(x)), perm


def sort_by_morton(x: torch.Tensor):
    """[B,N,3] -> (sorted [B,N,3], perm [B,N] int32), sorted = x[perm]; a
    stable sort, as ``jax.lax.sort`` is."""
    x = x.to(torch.float32)
    xs, perm = _sort_by_codes(x, _morton_codes(x))
    return xs, perm.to(torch.int32)


def sort_by_morton_masked(x: torch.Tensor, valid: torch.Tensor):
    """Masked variant: valid points in Morton order of the valid AABB,
    invalid (poisoned) points moved to the end, stable within each group.
    Returns (sorted [B,N,3], perm [B,N] int32, sorted_valid [B,N] bool)."""
    x = x.to(torch.float32)
    xs, perm = _sort_by_codes(x, _morton_codes_masked(x, valid))
    return xs, perm.to(torch.int32), valid.gather(1, perm)


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


def _band_qsub(qs: torch.Tensor, tbq: int, stride: int) -> torch.Tensor:
    """q subsampled by ``stride`` and cut to whole ``tbq`` tiles, as the
    reference does before its band kernel."""
    qs = qs[:, ::stride, :3]
    return qs[:, : qs.shape[1] - qs.shape[1] % tbq]


def _live_rows(live, b: int, n: int, device) -> torch.Tensor:
    """[B, n] bool: row r of cloud i is live if r < ``live`` (an int, every
    cloud; None: all rows) or ``live[i]`` (an int tensor [B])."""
    rows = torch.arange(n, device=device)
    if live is None or isinstance(live, int):
        return (rows < (n if live is None else live)).expand(b, n)
    return rows[None] < live.to(device)[:, None]


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


def _gap2(lo, hi, a_lo, a_hi):
    """Squared gap between boxes [.., 3], per axis max(lo - a_hi, a_lo - hi,
    0), summed x, y, z, each operation rounded alone (the kernel's gap2)."""
    gap = torch.maximum(lo - a_hi, a_lo - hi).clamp_min(0.0)
    gap = gap * gap
    return (gap[..., 0] + gap[..., 1]) + gap[..., 2]


def band_visits_torch(ps: torch.Tensor, qsub: torch.Tensor, tb: int,
                      tbq: int, centers: torch.Tensor | None = None,
                      live=None):
    """Plain emulation of the band kernel's scan (``csrc/nn_sorted.cu``).
    The window's points fall in sub-tiles of :data:`BAND_SUB` and those in
    groups of :data:`BAND_GROUP`. Each warp of :data:`BAND_WARP_ROWS` rows
    takes the groups in key order (the squared gap from the warp's box of
    live rows to the group's box, its low bits replaced by the group index;
    ascending), the sub-tiles of a group in index order, and folds a
    sub-tile only when some live lane's own gap to it is below the lane's
    running min. Arguments as :func:`band_min_torch`, ``live`` as
    :func:`_live_rows`. Returns (out [B, n], -1 past the live rows; visits
    [B, ni] int32, the (warp, sub-tile) folds of each tile). The skips are
    exact: out equals band_min_torch on the live rows."""
    b, n, _ = ps.shape
    ni, njq = n // tb, qsub.shape[1] // tbq
    nw, w, sub = 3 * tbq, BAND_WARP_ROWS, BAND_SUB
    k = -(-nw // sub)
    kg = -(-k // BAND_GROUP)
    low = (1 << max(1, (kg - 1).bit_length())) - 1
    g = -(-tb // w)
    dev = ps.device
    inf = float("inf")
    win = _band_windows(centers, ni, njq, dev).expand(b, ni, 3)
    qw = torch.stack([qsub[i].reshape(njq, tbq, 3)[win[i]].reshape(ni, nw, 3)
                      for i in range(b)])
    pt_ok = (torch.arange(k * sub, device=dev) < nw).reshape(k, sub)
    qt = torch.nn.functional.pad(qw, (0, 0, 0, k * sub - nw)).reshape(
        b, ni, k, sub, 3)
    lo = torch.where(pt_ok[..., None], qt, inf).amin(dim=3)  # [B, ni, K, 3]
    hi = torch.where(pt_ok[..., None], qt, -inf).amax(dim=3)
    pad = (0, 0, 0, kg * BAND_GROUP - k)
    glo = torch.nn.functional.pad(lo, pad, value=inf).reshape(
        b, ni, kg, BAND_GROUP, 3).amin(dim=3)
    ghi = torch.nn.functional.pad(hi, pad, value=-inf).reshape(
        b, ni, kg, BAND_GROUP, 3).amax(dim=3)
    pr = torch.nn.functional.pad(ps.reshape(b, ni, tb, 3),
                                 (0, 0, 0, g * w - tb)).reshape(b, ni, g, w, 3)
    alive = torch.nn.functional.pad(_live_rows(live, b, n, dev).reshape(
        b, ni, tb), (0, g * w - tb)).reshape(b, ni, g, w)
    wlo = torch.where(alive[..., None], pr, inf).amin(dim=3)  # [B, ni, g, 3]
    whi = torch.where(alive[..., None], pr, -inf).amax(dim=3)
    lbw = _gap2(glo[:, :, None], ghi[:, :, None], wlo[:, :, :, None],
                whi[:, :, :, None])  # [B, ni, g, kg]
    key = ((lbw.view(torch.int32).long() & ~low)
           | torch.arange(kg, device=dev))
    sub_of = (key.argsort(dim=3)[..., None] * BAND_GROUP
              + torch.arange(BAND_GROUP, device=dev)).flatten(3)
    # the ragged last group's missing sub-tiles to the end, then cut
    past = (sub_of >= k).to(torch.uint8).argsort(dim=3, stable=True)
    order = sub_of.gather(3, past)[..., :k]  # [B, ni, g, K]
    lb = _gap2(lo[:, :, None, None], hi[:, :, None, None], pr[..., None, :],
               pr[..., None, :])  # [B, ni, g, w, K]
    acc = torch.where(alive, inf, -inf)
    visits = torch.zeros((b, ni, g), dtype=torch.int32, device=dev)
    for t in range(k):
        s = order[..., t]  # [B, ni, g]
        lb_t = lb.gather(4, s[..., None, None].expand(b, ni, g, w, 1))[..., 0]
        visit = (lb_t < acc).any(dim=3)
        pts = qt.gather(2, s[..., None, None].expand(b, ni, g, sub, 3))
        dx, dy, dz = (pts[:, :, :, None, :, c] - pr[..., None, c]
                      for c in range(3))
        d = torch.where(pt_ok[s][:, :, :, None], (dx * dx + dy * dy) + dz * dz,
                        inf).amin(dim=4)
        acc = torch.where(visit[..., None], torch.minimum(acc, d), acc)
        visits += visit
    out = torch.where(alive, acc, -1.0).reshape(b, ni, g * w)[..., :tb]
    return out.reshape(b, n), visits.sum(dim=2, dtype=torch.int32)


def _band_rows_torch(ps, qsub, tb, tbq, live, centers=None, counts=None):
    """Plain version of the band kernel on live rows: :func:`band_min_torch`,
    -1 past each cloud's live rows (``live`` as :func:`_live_rows`), and
    into ``counts`` ([B, ni] int32) the kernel's (warp, sub-tile) folds,
    from :func:`band_visits_torch`."""
    b, n, _ = ps.shape
    out = torch.where(_live_rows(live, b, n, ps.device),
                      band_min_torch(ps, qsub, tb, tbq, centers), -1.0)
    if counts is not None:
        counts.copy_(band_visits_torch(ps, qsub, tb, tbq, centers, live)[1])
    return out


def _launch_band(ps, qs, tb, tbq, stride, centers=None, live=None, vq=None,
                 counts=None) -> torch.Tensor:
    b, n, _ = ps.shape
    m = qs.shape[1]
    ni = n // tb
    _build.require(ps, "nn_band ps", torch.float32, (b, n, 3))
    _build.require(qs, "nn_band qs", torch.float32, (b, m, 3))
    if centers is not None:
        _build.require(centers, "nn_band centers", torch.int32, (b, ni))
    vp = live if isinstance(live, torch.Tensor) else None
    if vp is not None:
        _build.require(vp, "nn_band live", torch.int32, (b,))
    if vq is not None:
        _build.require(vq, "nn_band vq", torch.int32, (b,))
    if counts is not None:
        _build.require(counts, "nn_band counts", torch.int32, (b, ni))
    out = torch.empty((b, n), dtype=torch.float32, device=ps.device)
    err = _ppt_nn_band(
        ps.data_ptr(), qs.data_ptr(), _build.ptr(centers), _build.ptr(vp),
        _build.ptr(vq), b, ni, m, stride, -(-m // stride) // tbq * tbq, tb,
        tbq, n if live is None or vp is not None else live, out.data_ptr(),
        _build.ptr(counts), _build.stream(ps),
    )
    _build.check(err, "ppt_nn_band")
    return out


def band_min_cuda(ps: torch.Tensor, qs: torch.Tensor, tb: int, tbq: int,
                  stride: int = 1, live=None,
                  counts: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the band kernel (K6's band) on q read at ``stride`` (no
    subsampled copy): ``band_min_torch(ps, _band_qsub(qs, tbq, stride), tb,
    tbq)`` on the live rows (``live`` as :func:`_live_rows`), -1 past them;
    ``counts`` as :func:`_band_rows_torch`'s."""
    out = _launch_band(ps, qs, tb, tbq, stride, None, live, None, counts)
    band_min_cuda.launches += 1
    return out


band_min_cuda.launches = 0


def band_min_dynamic_cuda(ps: torch.Tensor, qs: torch.Tensor,
                          centers: torch.Tensor | None, tb: int, live=None,
                          vq: torch.Tensor | None = None,
                          counts: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the band kernel with window centres (K7): ``centers`` [B, nI],
    or None with ``live`` and ``vq`` (int32 [B]), for the centres
    ``_band_centers(live, vq, ...)``, which the kernel computes. Same
    contract as ``band_min_torch(ps, qs, tb, tb, centers)`` on the live
    rows, -1 past them; its own launch count."""
    out = _launch_band(ps, qs, tb, tb, 1, centers, live, vq, counts)
    band_min_dynamic_cuda.launches += 1
    return out


band_min_dynamic_cuda.launches = 0


def band_min(ps: torch.Tensor, qs: torch.Tensor, tb: int = TB,
             tbq: int | None = None, stride: int = 1, impl: str = "auto"):
    """Per-point min d^2 over a ~3-tile rank window of the (sorted) other
    cloud: an upper bound on each point's NN distance.

    ``ps`` [B,n,>=3] with n a multiple of ``tb``; ``qs`` [B,m,>=3] is
    subsampled by ``stride`` and cut to whole ``tbq`` tiles first, as the
    reference does. The window of p-tile i is q-tiles clamp(c + {-1,0,+1})
    with c = i * njq // ni (masked clouds: :func:`band_min_dynamic`).
    """
    tbq = tb if tbq is None else tbq
    ps = ps[..., :3]
    if ps.shape[1] % tb or -(-qs.shape[1] // stride) < tbq:
        raise ValueError(f"band_min: n={ps.shape[1]} must be a multiple of "
                         f"tb={tb} and q must hold a whole tbq={tbq} tile")
    if dispatch.resolve(impl, ps, "nn_band") == "cuda":
        return band_min_cuda(ps.contiguous(), qs[..., :3].contiguous(), tb,
                             tbq, stride)
    return band_min_torch(ps, _band_qsub(qs, tbq, stride), tb, tbq)


def _band_rows(ps, qs, live, tb=TB, tbq=TBQ, stride=STRIDE, counts=None,
               impl="auto"):
    """K6's band (:func:`band_min`) on sorted, padded [B, n, 3] / [B, m, 3]
    clouds, for the first ``live`` rows of each cloud (an int, or int32
    [B]) only: -1 past them, as the scan takes padding, and those rows are
    not computed. ``counts`` ([B, n / tb] int32) receives the kernel's
    (warp, sub-tile) folds, the plain version's emulated count."""
    if dispatch.resolve(impl, ps, "nn_band") == "cuda":
        return band_min_cuda(ps, qs, tb, tbq, stride, live, counts)
    return _band_rows_torch(ps, _band_qsub(qs, tbq, stride), tb, tbq, live,
                            None, counts)


def _band_rows_masked(ps, qs, vp, vq, tb=TB, counts=None, impl="auto"):
    """K7 (:func:`band_min_dynamic`) on masked-sorted, padded clouds whose
    first ``vp`` (int32 [B]) rows are valid, the other cloud's first ``vq``:
    windows centred by ``_band_centers(vp, vq, ...)`` (on the card the
    kernel computes them), -1 past the valid rows, which are not computed.
    ``counts`` as in :func:`_band_rows`."""
    if dispatch.resolve(impl, ps, "nn_band_dynamic") == "cuda":
        return band_min_dynamic_cuda(ps, qs, None, tb, vp, vq, counts)
    centers = _band_centers(vp, vq, ps.shape[1] // tb, qs.shape[1] // tb, tb)
    return _band_rows_torch(ps, qs, tb, tb, vp, centers, counts)


def _band_centers(vp: torch.Tensor, vq: torch.Tensor, ni: int, njq: int,
                  tb: int) -> torch.Tensor:
    """[B, nI] int32 q-tile centres aligning the clouds' VALID rank ranges:
    p-rank r maps to q-rank r * vq / vp, and p-tile i's window is the q-tile
    holding its centre rank, +/- 1 (clamped). In float32, in the reference's
    order of operations. Only the bound's tightness depends on it."""
    r = (torch.arange(ni, dtype=torch.float32, device=vp.device) + 0.5) * tb
    ratio = vq.to(torch.float32) / torch.clamp_min(vp.to(torch.float32), 1.0)
    qrank = r[None, :] * ratio[:, None]
    return torch.clamp((qrank / tb).to(torch.int32), 0, njq - 1)


def band_min_dynamic(ps: torch.Tensor, qs: torch.Tensor,
                     centers: torch.Tensor, tb: int = TB,
                     impl: str = "auto") -> torch.Tensor:
    """The band bound with per-(b, i) window centres ``centers`` [B, nI]
    (masked clouds, whose valid ranges fill different shares of the padded
    rank space): windows of ``tb`` q points, no subsampling. ``ps`` and
    ``qs`` [B, n|m, >=3] with n and m multiples of ``tb``."""
    ps, qs = ps[..., :3], qs[..., :3]
    if ps.shape[1] % tb or qs.shape[1] % tb:
        raise ValueError(f"band_min_dynamic: n={ps.shape[1]} and "
                         f"m={qs.shape[1]} must be multiples of tb={tb}")
    if dispatch.resolve(impl, ps, "nn_band_dynamic") == "cuda":
        return band_min_dynamic_cuda(ps.contiguous(), qs.contiguous(),
                                     centers.to(torch.int32).contiguous(),
                                     tb)
    return band_min_torch(ps, qs, tb, tb, centers)


# ---------------------------------------------------------------------------
# candidate mask
# ---------------------------------------------------------------------------


def sub_tile_boxes_torch(qs: torch.Tensor, ft: int):
    """(qlo, qhi) [B, m/ft, 3]: the AABB of each ft-point sub-tile of the
    sorted, padded cloud ``qs`` [B, m, >=3], pad and poison rows included.
    The CUDA scan's box launch computes the same table."""
    b, m = qs.shape[:2]
    qt = qs[..., :3].reshape(b, m // ft, ft, 3)
    return qt.amin(dim=2), qt.amax(dim=2)


def _cand_rows(ps: torch.Tensor, qs: torch.Tensor, d_ub: torch.Tensor,
               ft: int, ktn: int, ktm: int, rows: int) -> torch.Tensor:
    """[B, nI, ktn / rows, nJ] bool: q-tile J (ktm points) is needed by some
    point of each group of ``rows`` consecutive rows of p-tile I (ktn
    points). The exact AABB lower bound against fine ft-point q sub-tiles,
    OR-folded to kernel tiles; the (1 - 1e-5) factor absorbs the f32
    rounding of the bound, as in the reference. Materialises [B, nI, ktn,
    nJ*ktm/ft] float temporaries (about 0.5 GB each at B=32 N=M=16384)."""
    ps = ps[..., :3]
    b, n, _ = ps.shape
    m = qs.shape[1]
    ni, nj, fpk = n // ktn, m // ktm, ktm // ft
    qlo, qhi = sub_tile_boxes_torch(qs, ft)
    qlo, qhi = qlo[:, None, None], qhi[:, None, None]  # [B, 1, 1, nJf, 3]
    pr = ps.reshape(b, ni, ktn, 1, 3)
    lb = None
    for c in range(3):
        pc = pr[..., c]
        gap = torch.maximum(qlo[..., c] - pc, pc - qhi[..., c]).clamp_min_(0.0)
        gap = gap.mul_(gap)
        lb = gap if lb is None else lb.add_(gap)
    ok = lb.mul_(LB_SCALE) <= d_ub.reshape(b, ni, ktn, 1)
    g = ktn // rows
    return ok.reshape(b, ni, g, rows, nj, fpk).any(dim=5).any(dim=3)


def _cand_mask(ps: torch.Tensor, qs: torch.Tensor, d_ub: torch.Tensor,
               ft: int, ktn: int, ktm: int) -> torch.Tensor:
    """[B, nI, nJ] bool: q-tile J (ktm points) is needed by some point of
    p-tile I (ktn points); the reference's ``_cand_mask``."""
    return _cand_rows(ps, qs, d_ub, ft, ktn, ktm, ktn)[:, :, 0]


# ---------------------------------------------------------------------------
# NN scan over the candidate tile pairs
# ---------------------------------------------------------------------------


def nn_resident_torch(ps: torch.Tensor, qs: torch.Tensor, qid: torch.Tensor,
                      cand: torch.Tensor, tn: int, tm: int):
    """The scan over a given candidate mask: the lexicographic minimum of
    (d^2, qid) over the q points of each row's candidate tiles. [B,np,3],
    [B,mp,3], [B,mp] int32, [B,np/tn,mp/tm] bool -> (d [B,np], id [B,np]
    int32); a row with no candidate gives (inf, SENTINEL)."""
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


def nn_scan_torch(ps: torch.Tensor, qs: torch.Tensor, qid: torch.Tensor,
                  d_ub: torch.Tensor, tn: int = TN, tm: int = TM,
                  cand_out: torch.Tensor | None = None,
                  counts: torch.Tensor | None = None):
    """Plain version of the NN scan: the reference's candidate mask
    (:func:`_cand_mask`, fine sub-tiles of ``tm`` points), then the scan
    over it (:func:`nn_resident_torch`); rows whose bound is negative
    (padding, poison: they pass no tile of their own) give (inf, SENTINEL).
    (d [B,np], id [B,np] int32). ``cand_out`` ([B, nI, nJ] bool) receives
    the mask; ``counts`` ([B, nI, 2] int32) each block's candidate tiles and
    the tiles its warps of :data:`SCAN_WARP_ROWS` rows pass."""
    groups = _cand_rows(ps, qs, d_ub, tm, tn, tm, SCAN_WARP_ROWS)
    cand = groups.any(dim=2)
    dist, ids = nn_resident_torch(ps, qs, qid, cand, tn, tm)
    neg = d_ub < 0
    dist = dist.masked_fill_(neg, float("inf"))
    ids = ids.masked_fill_(neg, SENTINEL)
    if cand_out is not None:
        cand_out.copy_(cand)
    if counts is not None:
        counts[..., 0] = cand.sum(dim=2)
        counts[..., 1] = groups.sum(dim=(2, 3))
    return dist, ids


def nn_scan_cuda(ps: torch.Tensor, qs: torch.Tensor, qid: torch.Tensor,
                 d_ub: torch.Tensor, tn: int = TN, tm: int = TM,
                 cand_out: torch.Tensor | None = None,
                 counts: torch.Tensor | None = None):
    """Launch the NN scan (the box launch, then the scan): same contract as
    :func:`nn_scan_torch`."""
    b, np_, _ = ps.shape
    mp = qs.shape[1]
    ni, nj = np_ // tn, mp // tm
    _build.require(ps, "nn_scan ps", torch.float32, (b, np_, 3))
    _build.require(qs, "nn_scan qs", torch.float32, (b, mp, 3))
    _build.require(qid, "nn_scan qid", torch.int32, (b, mp))
    _build.require(d_ub, "nn_scan d_ub", torch.float32, (b, np_))
    if cand_out is not None:
        _build.require(cand_out, "nn_scan cand_out", torch.bool, (b, ni, nj))
    if counts is not None:
        _build.require(counts, "nn_scan counts", torch.int32, (b, ni, 2))
    if not (tn % SCAN_WARP_ROWS == 0 and tn <= 1024 and tm % 32 == 0
            and tm <= 256):
        raise ValueError(f"nn_scan: unsupported tiles tn={tn} tm={tm}")
    dist = torch.empty((b, np_), dtype=torch.float32, device=ps.device)
    ids = torch.empty((b, np_), dtype=torch.int32, device=ps.device)
    scratch = torch.empty((b * nj * (tm + 2), 4), dtype=torch.float32,
                          device=ps.device)
    err = _ppt_nn_scan(
        ps.data_ptr(), qs.data_ptr(), qid.data_ptr(), d_ub.data_ptr(), b, ni,
        nj, tn, tm, scratch.data_ptr(), dist.data_ptr(), ids.data_ptr(),
        _build.ptr(cand_out), _build.ptr(counts), _build.stream(ps),
    )
    _build.check(err, "ppt_nn_scan")
    nn_scan_cuda.launches += 1
    return dist, ids


nn_scan_cuda.launches = 0


def nn_scan(ps: torch.Tensor, qs: torch.Tensor, qid: torch.Tensor,
            d_ub: torch.Tensor, tn: int = TN, tm: int = TM,
            cand_out: torch.Tensor | None = None,
            counts: torch.Tensor | None = None, impl: str = "auto"):
    """NN of each ps row among the qs points of the candidate tiles its
    bound ``d_ub`` [B,np] implies, ties to the lowest ``qid``: (d [B,np],
    id [B,np] int32). Rows with a bound of at least their NN distance (the
    band pass gives one) get their dense NN; rows with a negative bound
    get (inf, SENTINEL). ``cand_out`` and ``counts`` as in
    :func:`nn_scan_torch`."""
    if ps.shape[1] % tn or qs.shape[1] % tm:
        raise ValueError(f"nn_scan: clouds must be whole tiles, got "
                         f"{ps.shape[1]} rows (tn={tn}), {qs.shape[1]} "
                         f"columns (tm={tm})")
    if dispatch.resolve(impl, ps, "nn_resident") == "cuda":
        return nn_scan_cuda(ps.contiguous(), qs.contiguous(),
                            qid.to(torch.int32).contiguous(),
                            d_ub.contiguous(), tn, tm, cand_out, counts)
    return nn_scan_torch(ps, qs, qid, d_ub, tn, tm, cand_out, counts)


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------


def _band_bounds(ps, qs, tn, tm, tb, impl, live=False):
    """Sorted clouds padded with poison rows to a multiple of max(tn, tm,
    tb), and each direction's band bound (:func:`band_min`'s, stride-4
    windows of TBQ points): (pp, qp, d_ub1, d_ub2). With ``live`` the
    padding rows get -1, uncomputed (the scan's input: they need no NN);
    without, every row its bound (the reference's telemetry)."""
    n, m = ps.shape[1], qs.shape[1]
    align = max(tn, tm, tb)
    pp = _pad_poison(ps, _round_up(n, align), 1.0)
    qp = _pad_poison(qs, _round_up(m, align), -1.0)
    d_ub1 = _band_rows(pp, qp, n if live else pp.shape[1], tb, impl=impl)
    d_ub2 = _band_rows(qp, pp, m if live else qp.shape[1], tb, impl=impl)
    return pp, qp, d_ub1, d_ub2


def _band_bounds_masked(p, q, pv, qv, tn, tm, tb, impl):
    """:func:`_band_bounds` for poisoned clouds with validity pv [B,N], qv
    [B,M] bool: valid points sorted over the valid AABB with the poison
    last (so the valid rows are a prefix), band windows centred by the
    valid counts (K7, :func:`_band_rows_masked`), bound -1 on poisoned and
    padding rows, which are not computed. (pp, qp, perm_p, perm_q, pvs,
    qvs, d_ub1, d_ub2), pvs and qvs the sorted validity padded with
    False."""
    n, m = p.shape[1], q.shape[1]
    ps, perm_p, pvs = sort_by_morton_masked(p, pv)
    qs, perm_q, qvs = sort_by_morton_masked(q, qv)
    align = max(tn, tm, tb)
    n_pad, m_pad = _round_up(n, align), _round_up(m, align)
    pp = _pad_poison(ps, n_pad, 1.0)
    qp = _pad_poison(qs, m_pad, -1.0)
    pvs = torch.nn.functional.pad(pvs, (0, n_pad - n))
    qvs = torch.nn.functional.pad(qvs, (0, m_pad - m))
    vp = pv.sum(dim=1, dtype=torch.int32)
    vq = qv.sum(dim=1, dtype=torch.int32)
    d_ub1 = _band_rows_masked(pp, qp, vp, vq, tb, impl=impl)
    d_ub2 = _band_rows_masked(qp, pp, vq, vp, tb, impl=impl)
    return pp, qp, perm_p, perm_q, pvs, qvs, d_ub1, d_ub2


def _masked_bounds(p, q, impl):
    """The band stage of :func:`nndistance_indexed_masked` on poisoned f32
    clouds: validity |x0| < BIG_COORD, then :func:`_band_bounds_masked` at
    the reference's tiles. The same tuple."""
    pv = p[..., 0].abs() < BIG_COORD
    qv = q[..., 0].abs() < BIG_COORD
    return _band_bounds_masked(p, q, pv, qv, TN, TM, TB, impl)


def _nn_sorted_space(ps, pid, qs, qid, impl):
    """Both directions on sorted clouds carrying ids [B,N] int32: rows in
    the given order, each the (distance, lowest id) of its NN."""
    n, m = ps.shape[1], qs.shape[1]
    pp, qp, d_ub1, d_ub2 = _band_bounds(ps, qs, TN, TM, TB, impl, live=True)
    d1, i1 = nn_scan(pp, qp, _pad_ids(qid, qp.shape[1]), d_ub1, impl=impl)
    d2, i2 = nn_scan(qp, pp, _pad_ids(pid, pp.shape[1]), d_ub2, impl=impl)
    return d1[:, :n], i1[:, :n], d2[:, :m], i2[:, :m]


def nndistance_presorted(ps: torch.Tensor, qs: torch.Tensor, tn: int = TN,
                         tm: int = TM, ft: int = FT, tb: int = TB,
                         impl: str = "auto"):
    """Both directions on clouds already Morton-sorted: (d1 [B,N], i1,
    d2 [B,M], i2) in the given order, indices into the given other cloud,
    ties to the lowest of them; equal to the dense kernel on these clouds.

    ``tn``, ``tm``, ``ft`` and ``tb`` are the reference's resident tiles,
    fine sub-tiles and band tile; the result does not depend on them (the
    scan here decides its candidates itself, in its own tiles), so they are
    accepted and change nothing."""
    del tn, tm, ft, tb  # every tiling gives the same bits
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


def nndistance_indexed(p: torch.Tensor, q: torch.Tensor, tn: int = TN,
                       tm: int = TM, ft: int = FT, tb: int = TB,
                       impl: str = "auto"):
    """Bidirectional NN in ORIGINAL order with the reference's tie-breaks:
    the dense ``nn_both_directions(p, q)`` contract, served by the pruned
    scan. (d1 [B,N], i1 int32, d2 [B,M], i2).

    ``tn``, ``tm``, ``ft`` and ``tb`` are the reference's resident tiles,
    fine sub-tiles and band tile; the result does not depend on them (the
    scan here decides its candidates itself, in its own tiles), so they are
    accepted and change nothing."""
    del tn, tm, ft, tb  # every tiling gives the same bits
    n, m = p.shape[1], q.shape[1]
    ps, perm_p = sort_by_morton(p)
    qs, perm_q = sort_by_morton(q)
    d1s, i1s, d2s, i2s = _nn_sorted_space(ps, perm_p, qs, perm_q, impl)
    d1, i1 = _unpermute_rows(perm_p, d1s, i1s, n, impl)
    d2, i2 = _unpermute_rows(perm_q, d2s, i2s, m, impl)
    return d1, i1, d2, i2


def nndistance_indexed_masked(p: torch.Tensor, q: torch.Tensor, tn: int = TN,
                              tm: int = TM, ft: int = FT, tb: int = TB,
                              impl: str = "auto"):
    """As :func:`nndistance_indexed` for POISONED clouds
    (``core.masking.poison_points``): validity is |x0| < BIG_COORD, valid
    points sort over the valid AABB with the poison last, and the band
    windows (``tb`` points, no subsampling) align the two valid rank ranges
    through per-tile centres (K7). Poisoned rows emit no candidates (their
    bound is -1) and come out as (0, 0); valid rows equal the dense kernel
    on the same poisoned clouds, ties included.

    The reference runs its resident scan over a compacted pair list of
    static size and, past that budget, falls back to the dense kernel with
    a ``lax.cond``. The port's scan visits its candidates directly and
    needs no budget, so that fallback has no counterpart.

    ``tn``, ``tm``, ``ft`` and ``tb`` are the reference's resident tiles,
    fine sub-tiles and band tile; the result does not depend on them (the
    scan here decides its candidates itself, in its own tiles), so they are
    accepted and change nothing."""
    del tn, tm, ft, tb  # every tiling gives the same bits
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    n, m = p.shape[1], q.shape[1]
    pp, qp, perm_p, perm_q, pvs, qvs, d_ub1, d_ub2 = _masked_bounds(p, q,
                                                                    impl)
    d1s, i1s = nn_scan(pp, qp, _pad_ids(perm_q, qp.shape[1]), d_ub1,
                       impl=impl)
    d2s, i2s = nn_scan(qp, pp, _pad_ids(perm_p, pp.shape[1]), d_ub2,
                       impl=impl)
    # Poisoned rows saw no candidate and hold (inf, SENTINEL): (0, 0) before
    # the un-permute, as the reference sets them, which is also the public
    # contract of a masked row.
    pvs, qvs = pvs[:, :n], qvs[:, :m]
    d1, i1 = _unpermute_rows(perm_p, torch.where(pvs, d1s[:, :n], 0.0),
                             torch.where(pvs, i1s[:, :n], 0), n, impl)
    d2, i2 = _unpermute_rows(perm_q, torch.where(qvs, d2s[:, :m], 0.0),
                             torch.where(qvs, i2s[:, :m], 0), m, impl)
    return d1, i1, d2, i2


def nndistance_sums(p: torch.Tensor, q: torch.Tensor, tn: int = TN,
                    tm: int = TM, ft: int = FT, tb: int = TB,
                    impl: str = "auto"):
    """Loss-only twin of :func:`nndistance_indexed`: per-cloud sums of the
    NN distances, with no row un-permute.

    Returns ``(s1 [B], s2 [B], i1o [B,N], i2o [B,M], rows_p, rows_q, tgt_p,
    tgt_q)``: row r of ``rows_p`` (the sorted p cloud) has its nearest
    ORIGINAL q index at ``i1o[b, r]`` and came from original row
    ``tgt_p[b, r]``; likewise for q.

    ``tn``, ``tm``, ``ft`` and ``tb`` are the reference's resident tiles,
    fine sub-tiles and band tile; the result does not depend on them (the
    scan here decides its candidates itself, in its own tiles), so they are
    accepted and change nothing.
    """
    del tn, tm, ft, tb  # every tiling gives the same bits
    ps, perm_p = sort_by_morton(p)
    qs, perm_q = sort_by_morton(q)
    d1s, i1s, d2s, i2s = _nn_sorted_space(ps, perm_p, qs, perm_q, impl)
    return (d1s.sum(dim=-1), d2s.sum(dim=-1), i1s, i2s, ps, qs, perm_p,
            perm_q)


def nndistance_sorted(p: torch.Tensor, q: torch.Tensor, tn: int = TN,
                      tm: int = TM, ft: int = FT, tb: int = TB,
                      impl: str = "auto"):
    """Bidirectional NN distances in Morton-sorted space, the reference's
    six outputs: (d1 [B,N], i1 [B,N], d2 [B,M], i2 [B,M], perm_p [B,N],
    perm_q [B,M]) where d1, i1 are per SORTED p point (p[perm_p]) with i1
    indexing the SORTED q cloud, and vice versa; equal to the dense kernel
    on the sorted clouds, ties included. ``tn``, ``tm``, ``ft`` and ``tb``
    as in :func:`nndistance_presorted`: accepted, and they change
    nothing."""
    ps, perm_p = sort_by_morton(p)
    qs, perm_q = sort_by_morton(q)
    d1, i1, d2, i2 = nndistance_presorted(ps, qs, tn, tm, ft, tb, impl=impl)
    return d1, i1, d2, i2, perm_p, perm_q


# ---------------------------------------------------------------------------
# worklist telemetry
# ---------------------------------------------------------------------------

# The reference's static worklist budget, a share of all tile pairs.
_BUDGET_FRAC = 0.62


def _worklist_summary(cand1: torch.Tensor, cand2: torch.Tensor) -> dict:
    """The reference's budget arithmetic over the two candidate masks
    [B, nI, nJ]: each direction's candidate pairs a cloud, the budget
    ``k_max``, the occupancy (the largest count over k_max) and whether
    some count exceeds the budget."""
    ni, nj = cand1.shape[1], cand1.shape[2]
    k_max = min(ni * nj, int(_BUDGET_FRAC * ni * nj) + ni)
    c1 = cand1.reshape(cand1.shape[0], -1).sum(dim=1, dtype=torch.int32)
    c2 = cand2.reshape(cand2.shape[0], -1).sum(dim=1, dtype=torch.int32)
    # count / k_max as the reference's compiled program rounds it: times
    # the f32 reciprocal of k_max
    inv = torch.tensor(1.0 / k_max, dtype=torch.float32, device=c1.device)
    return {
        "count1": c1,
        "count2": c2,
        "k_max": k_max,
        "occupancy": torch.maximum(c1.max(), c2.max()).to(torch.float32)
        * inv,
        "overflow": (c1 > k_max).any() | (c2 > k_max).any(),
    }


def worklist_stats(p: torch.Tensor, q: torch.Tensor, tn: int = TN,
                   tm: int = TM, ft: int = FT, tb: int = TB,
                   impl: str = "auto") -> dict:
    """Telemetry of the reference's worklist dispatch for
    :func:`nndistance_indexed` on (p, q), in its arithmetic at the tiles
    given: each direction's candidate tile pairs a cloud (``count1``,
    ``count2`` [B] int32), the budget ``k_max``, ``occupancy`` (the largest
    count over k_max) and ``overflow`` (some count above k_max). The port's
    scan needs no budget (it visits its candidates directly), so these
    numbers say what the reference would run and decide nothing here. The
    band bound (:func:`band_min`) runs on the card for a CUDA tensor; the
    candidate masks are the reference's (:func:`_cand_mask`, torch ops)."""
    ps, _ = sort_by_morton(p.to(torch.float32))
    qs, _ = sort_by_morton(q.to(torch.float32))
    pp, qp, d_ub1, d_ub2 = _band_bounds(ps, qs, tn, tm, tb, impl)
    return _worklist_summary(_cand_mask(pp, qp, d_ub1, ft, tn, tm),
                             _cand_mask(qp, pp, d_ub2, ft, tn, tm))


def worklist_stats_masked(p: torch.Tensor, q: torch.Tensor,
                          p_mask: torch.Tensor | None,
                          q_mask: torch.Tensor | None, tn: int = TN,
                          tm: int = TM, ft: int = FT, tb: int = TB,
                          impl: str = "auto") -> dict:
    """:func:`worklist_stats` for :func:`nndistance_indexed_masked`'s
    dispatch: valid points sorted over the valid AABB with the poison last,
    band windows centred by the valid counts (:func:`band_min_dynamic`).
    Takes the public mask form ([B,N] bool masks, None for all valid), as
    the reference does."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    b, n = p.shape[:2]
    m = q.shape[1]
    pv = (torch.ones((b, n), dtype=torch.bool, device=p.device)
          if p_mask is None else p_mask.to(torch.bool))
    qv = (torch.ones((b, m), dtype=torch.bool, device=q.device)
          if q_mask is None else q_mask.to(torch.bool))
    pp, qp, _, _, _, _, d_ub1, d_ub2 = _band_bounds_masked(
        poison_points(p, p_mask, sign=1.0),
        poison_points(q, q_mask, sign=-1.0), pv, qv, tn, tm, tb, impl)
    return _worklist_summary(_cand_mask(pp, qp, d_ub1, ft, tn, tm),
                             _cand_mask(qp, pp, d_ub2, ft, tn, tm))
