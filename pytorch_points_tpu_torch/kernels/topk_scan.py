"""Exact k nearest neighbours: the streaming scan (kernel K8) and the
Morton-ring scan (kernels K9 and K10, and the ring stats twin).

CUDA kernels: ``csrc/knn.cu`` replaces the TPU kernel
``pytorch_points_tpu/kernels/topk_scan.py::_knn_kernel`` (the streaming
scan); ``csrc/knn_ring.cu`` replaces ``::_knn_ring_kernel`` (K9),
``::_knn_ring_kernel_pf`` (K10: the same scan with a table of ring centres)
and ``::_knn_ring_stats_kernel`` (the same scan with per-tile counters). The
header notes there say what bounds them on the card. A ring call launches
twice: the chunk-box table (:func:`ring_boxes_torch` is its plain version),
then the scan, in which each warp of 32 sorted queries decides alone which
chunks, and which of their sub-chunks of SUB rows, to scan; the optional
``counts`` of the ring functions receives those decisions
(:func:`knn_ring_torch`).

:func:`knn` dispatches as the reference does: an xyz support of
``RING_MIN_NS`` points or more (and fewer than 2^24) takes the ring scan, or
its masked form when ``masked`` marks poisoned rows, whose raw coordinates
must not enter a Morton AABB; a smaller one, or ``sorted_ok=False``, the
streaming scan. A cloud of C != 3 channels always takes the streaming scan
over all C channels (the ring's Morton sort is defined on xyz), as the
reference's documented [B,N,C] contract and its XLA path have it; its
Pallas scan reads three channels. Every scan takes any 1 <= k <= Ns.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_points_tpu_torch.core.masking import BIG_COORD
from pytorch_points_tpu_torch.kernels import _build, dispatch, nn_sorted

_ppt_knn = _build.entry("ppt_knn")
_ppt_knn_scratch_keys = _build.entry("ppt_knn_scratch_keys")
_ppt_knn_ring = _build.entry("ppt_knn_ring")

# The ring scan serves supports of this size and up: below it the sort and
# un-permute cost more than the chunk skip saves (the reference's value).
RING_MIN_NS = 8192
# Ids ride a float32 channel: 2^24 is the pad rows' id and caps the support.
_IDX_RING = 2**24
TQ = TM = 512  # ring scan: queries per tile, support rows per chunk
WARP = 32  # ring scan: the queries that decide a chunk's skip together
SUB = 32  # ring scan: support rows of a sub-chunk box
# The ring kernel keeps lists of 8 or 16 entries in registers, of up to 384
# in a heap in shared memory, longer ones in a heap in global scratch.
_SHARED_LIST_MAX = 384
UNROLL = 2  # the reference's extractions per while-loop trip (counters only)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def knn_torch(query: torch.Tensor, support: torch.Tensor, k: int):
    """Plain version: [B,Nq,C], [B,Ns,C] -> (d [B,Nq,k] ascending, idx
    int32).

    d in the diff^2 form summed over the channels in index order, (((dx0^2
    + dx1^2) + dx2^2) + ...); a stable sort keeps the lowest index first
    among equal distances.
    """
    d = None
    for c in range(query.shape[-1]):
        dc = query[:, :, None, c] - support[:, None, :, c]
        d = dc * dc if d is None else d + dc * dc
    d, idx = torch.sort(d, dim=-1, stable=True)
    return d[..., :k], idx[..., :k].to(torch.int32)


def knn_cuda(query: torch.Tensor, support: torch.Tensor, k: int):
    """Launch the CUDA kernel: same contract as :func:`knn_torch`, any C,
    1 <= k <= Ns, one pass for every k."""
    b, nq, c = query.shape
    ns = support.shape[1]
    _build.require(query, "knn query", torch.float32, (b, nq, c))
    _build.require(support, "knn support", torch.float32, (b, ns, c))
    if not 1 <= k <= ns:
        raise ValueError(f"knn kernel needs 1 <= k <= Ns={ns}, got {k}")
    d = torch.empty((b, nq, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=query.device)
    # the kernel says how much global scratch its lists take at this k
    keys = ctypes.c_longlong(0)
    _build.check(_ppt_knn_scratch_keys(b, nq, k, ctypes.byref(keys)),
                 "ppt_knn_scratch_keys")
    lists = None
    if keys.value:
        lists = torch.empty(keys.value, dtype=torch.int64,
                            device=query.device)
    err = _ppt_knn(
        query.data_ptr(), support.data_ptr(), b, nq, ns, c, k,
        _build.ptr(lists), d.data_ptr(), idx.data_ptr(), _build.stream(query),
    )
    _build.check(err, "ppt_knn")
    knn_cuda.launches += 1
    return d, idx


knn_cuda.launches = 0


@torch.library.custom_op("ppt::knn", mutates_args=())
def _knn_op(query: torch.Tensor, support: torch.Tensor,
            k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 as one op for a traced program (kernels.dispatch.traced)."""
    if query.is_cuda:
        return knn_cuda(query, support, k)
    return knn_torch(query, support, k)


@_knn_op.register_fake
def _(query, support, k):
    b, nq = query.shape[:2]
    return (query.new_empty((b, nq, k)),
            query.new_empty((b, nq, k), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Morton-ring scan
# ---------------------------------------------------------------------------


def _ring_inputs(query: torch.Tensor, support: torch.Tensor, masked: bool):
    """Sort and pad both clouds as the reference does. Returns (qsp
    [B,q_pad,3] sorted queries padded by repeating the last row, sup4
    [B,m_pad,4] sorted support with its original index as f32 and far-away
    pad rows of id 2^24, centers [B,nI] int32 (masked) or None, perm_q
    [B,Nq] int32). Queries always take the unmasked sort; a masked support
    sorts over its valid AABB with the poison last, and its pad offsets
    start past ``ns`` so that no pad row equals a poisoned row."""
    b, nq, _ = query.shape
    ns = support.shape[1]
    if masked:
        valid = support[..., 0].abs() < BIG_COORD
        ss, perm_s, _ = nn_sorted.sort_by_morton_masked(support, valid)
    else:
        ss, perm_s = nn_sorted.sort_by_morton(support)
    qs, perm_q = nn_sorted.sort_by_morton(query)
    q_pad, m_pad = _round_up(nq, TQ), _round_up(ns, TM)
    qsp = torch.cat([qs, qs[:, -1:].expand(b, q_pad - nq, 3)], dim=1)
    sup4 = torch.cat([ss, perm_s[..., None].to(torch.float32)], dim=-1)
    if m_pad > ns:
        first = ns if masked else 0
        pad = sup4.new_zeros((b, m_pad - ns, 4))
        pad[..., 0] = -(BIG_COORD * 4.0 + 8.0 * (first + torch.arange(
            m_pad - ns, dtype=torch.float32, device=sup4.device)))
        pad[..., 3] = float(_IDX_RING)
        sup4 = torch.cat([sup4, pad], dim=1)
    centers = None
    if masked:
        # Query tile i's Morton-proportional rank, scaled into the support's
        # valid chunks (the first ceil(valid / TM) after the sort).
        ni, nj = q_pad // TQ, m_pad // TM
        nvc = torch.clamp_min((valid.sum(dim=1) + TM - 1) // TM, 1)
        i = torch.arange(ni, device=query.device)
        centers = torch.clamp(((i[None] * TQ + TQ // 2) * nvc[:, None])
                              // q_pad, 0, nj - 1).to(torch.int32)
    return qsp.contiguous(), sup4.contiguous(), centers, perm_q


def _pack(d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(d >= +0 f32, id < 2^26) -> int64 keys in (d, id) lexicographic
    order: the bits of a non-negative float order as the float does."""
    return (d.view(torch.int32).to(torch.int64) << 26) | ids


def _unpack(key: torch.Tensor):
    d = (key >> 26).to(torch.int32).view(torch.float32)
    return d, (key & (2**26 - 1)).to(torch.int32)


def _boxes(rows: torch.Tensor) -> torch.Tensor:
    """[..., n, 4] -> [..., 8]: (min x, min y, min z, 1.0 if a row has the
    pad id 2^24 else 0.0, max x, max y, max z, 0.0) over the n rows."""
    pad = (rows[..., 3] == _IDX_RING).any(dim=-1, keepdim=True).to(
        torch.float32)
    return torch.cat([rows[..., :3].amin(dim=-2), pad,
                      rows[..., :3].amax(dim=-2), torch.zeros_like(pad)], -1)


def ring_boxes_torch(sup4: torch.Tensor) -> torch.Tensor:
    """Plain version of the ring scan's chunk-box table: [B,m_pad,4] ->
    [B,m_pad/TM,1+TM/SUB,8]: each chunk's box over all its TM rows, then
    the box of each of its sub-chunks of SUB rows (:func:`_boxes`), pad and
    poison rows included."""
    b = sup4.shape[0]
    ch = sup4.reshape(b, -1, TM, 4)
    sub = _boxes(ch.reshape(b, ch.shape[1], TM // SUB, SUB, 4))
    return torch.cat([_boxes(ch)[:, :, None], sub], dim=2)


def knn_ring_torch(qsp: torch.Tensor, sup4: torch.Tensor, k: int,
                   centers: torch.Tensor | None = None, unroll: int = UNROLL,
                   stats: bool = False, counts: torch.Tensor | None = None):
    """Plain version of the ring scan on :func:`_ring_inputs`' tensors:
    (d [B,q_pad,k], id [B,q_pad,k] int32 in sorted-query order, counters
    [B,nI,2] int32 (visits, trips) or None).

    The kernel's algorithm batched over every (cloud, query tile) at once:
    per ring step each tile's chunk, its AABB skip test, the chunk's
    [B,nI,TQ,TM] distances (inf where the chunk is skipped; one pad row of
    a chunk, the nearest, as the reference's id knockout leaves), and a merge
    with the round_up(k, 8)-entry lists by one top-k of packed (d, id) keys.
    Memory: a few [B,nI,TQ,TM] temporaries a step (0.5 GB each at B=16
    N=16384), never the [B,Nq,Ns] distance matrix (17 GB there).

    ``counts`` (int32 [B, q_pad / WARP], or None) receives the kernel's work:
    the sub-chunks of SUB rows that each warp of WARP consecutive sorted
    queries scans. At each ring step a warp tests the chunk, and if some of
    its queries' AABB bound is <= its worst entry, each sub-chunk against
    the same worst entries; it scans the sub-chunks that pass. The lists do
    not depend on where the skip is decided (a skipped box holds nothing
    below a worst entry), so this is counted on the tile's lists.
    """
    b, q_pad, _ = qsp.shape
    ni, nj = q_pad // TQ, sup4.shape[1] // TM
    kp = _round_up(k, 8)
    dev = qsp.device
    q = qsp.reshape(b, ni, TQ, 1, 3)
    chunks = sup4.reshape(b, nj, TM, 4)
    if centers is None:
        centers = ((torch.arange(ni, device=dev) * TQ + TQ // 2) * nj
                   // q_pad).expand(b, ni)
    centers = centers.to(torch.int64)
    inf = torch.tensor(float("inf"), device=dev)
    key = _pack(inf, torch.tensor(_IDX_RING, device=dev)).expand(
        b, ni, TQ, kp)
    never = _IDX_RING + 1  # id of a candidate that must not enter
    visits = torch.zeros((b, ni), dtype=torch.int64, device=dev)
    trips = torch.zeros_like(visits)
    if counts is not None:
        counts.zero_()
    col = torch.arange(TM, device=dev)
    for j in range(nj):
        off = ((j + 1) // 2) * (2 * (j % 2) - 1)
        ch = chunks[torch.arange(b, device=dev)[:, None],
                    (centers + off + nj) % nj]  # [B, nI, TM, 4]
        pts = ch[:, :, None, :, :3]  # [B, nI, 1, TM, 3]
        ids = ch[..., 3].to(torch.int64)[:, :, None, :]  # [B, nI, 1, TM]
        worst = _unpack(key[..., -1])[0]  # [B, nI, TQ]
        lo, hi = pts.amin(dim=3), pts.amax(dim=3)  # [B, nI, 1, 3]
        g = torch.clamp_min(torch.maximum(lo - q[..., 0, :],
                                          q[..., 0, :] - hi), 0.0)
        lb = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + (
            g[..., 2] * g[..., 2])
        visit = (lb <= worst).any(dim=2)  # [B, nI]
        if counts is not None:
            counts += _warp_scans(q[..., 0, :], ch, worst)
        dx, dy, dz = (q[..., c] - pts[..., c] for c in range(3))
        d = (dx * dx + dy * dy) + dz * dz  # [B, nI, TQ, TM]
        if stats:
            enter = (d.amin(dim=3) <= worst).any(dim=2) & visit
        pad = ids == _IDX_RING
        nearest_pad = torch.where(pad, d, inf).argmin(dim=3, keepdim=True)
        drop = ((pad & (col != nearest_pad)) | ~visit[..., None, None]
                | (d == inf))
        cand = _pack(torch.where(drop, inf, d), torch.where(drop, never, ids))
        key, pos = torch.topk(torch.cat([key, cand], dim=3), kp, dim=3,
                              largest=False, sorted=True)
        if stats:
            r = (pos >= kp).sum(dim=3).amax(dim=2)  # [B, nI]
            visits += visit
            trips += torch.where(enter, r // unroll + 1, 0)
    d, ids = _unpack(key[..., :k])
    counters = torch.stack([visits, trips], -1).to(torch.int32) if stats \
        else None
    return d.reshape(b, q_pad, k), ids.reshape(b, q_pad, k), counters


def _warp_scans(q: torch.Tensor, ch: torch.Tensor, worst: torch.Tensor):
    """The sub-chunks of one ring step that each warp scans: q [B,nI,TQ,3],
    ch [B,nI,TM,4] the step's chunks, worst [B,nI,TQ] -> int32
    [B, nI*TQ/WARP]. A warp scans a sub-chunk when some of its queries has
    AABB bound <= worst for it, in the skip test's arithmetic. (The kernel
    tests the chunk first; a sub-chunk's bound is never below its chunk's,
    as rounding is monotone, so that test drops no sub-chunk.)"""
    b, ni = q.shape[:2]
    boxes = _boxes(ch.reshape(b, ni, 1, TM // SUB, SUB, 4))
    g = torch.clamp_min(torch.maximum(boxes[..., :3] - q[..., None, :],
                                      q[..., None, :] - boxes[..., 4:7]), 0.0)
    lb = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + (
        g[..., 2] * g[..., 2])  # [B, nI, TQ, TM/SUB]
    need = (lb <= worst[..., None]).reshape(b, ni, TQ // WARP, WARP, -1)
    return need.any(3).sum(-1).reshape(b, -1).to(torch.int32)


def _launch_ring(qsp, sup4, k, centers, unroll, stats, counts=None):
    b, q_pad, _ = qsp.shape
    m_pad = sup4.shape[1]
    _build.require(qsp, "knn_ring query", torch.float32, (b, q_pad, 3))
    _build.require(sup4, "knn_ring support", torch.float32, (b, m_pad, 4))
    if q_pad % TQ or m_pad % TM or not 1 <= k <= m_pad or unroll < 1:
        raise ValueError(f"knn_ring kernel: q_pad={q_pad} and m_pad={m_pad} "
                         f"must be multiples of {TQ}, 1 <= k={k} <= m_pad, "
                         f"unroll={unroll} >= 1")
    if centers is not None:
        _build.require(centers, "knn_ring centers", torch.int32,
                       (b, q_pad // TQ))
    if counts is not None:
        _build.require(counts, "knn_ring counts", torch.int32,
                       (b, q_pad // WARP))
    dev = qsp.device
    kp = _round_up(k, 8)
    ni, nj = q_pad // TQ, m_pad // TM
    d = torch.empty((b, q_pad, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, q_pad, k), dtype=torch.int32, device=dev)
    boxes = torch.empty((b, nj, 1 + TM // SUB, 8), dtype=torch.float32,
                        device=dev)
    counters = torch.empty((b, ni, 2), dtype=torch.int32,
                           device=dev) if stats else None
    # each tile's step codes and finished-warp count (zeroed by the kernel)
    codes = torch.empty(b * ni * (nj + 1), dtype=torch.int32,
                        device=dev) if stats else None
    lists = torch.empty(b * q_pad * kp, dtype=torch.int64,
                        device=dev) if kp > _SHARED_LIST_MAX else None
    err = _ppt_knn_ring(
        qsp.data_ptr(), sup4.data_ptr(), _build.ptr(centers), b, q_pad,
        m_pad, k, kp, unroll, boxes.data_ptr(), d.data_ptr(), ids.data_ptr(),
        _build.ptr(counts), _build.ptr(counters), _build.ptr(codes),
        _build.ptr(lists), _build.stream(qsp),
    )
    _build.check(err, "ppt_knn_ring")
    return d, ids, counters


def knn_ring_cuda(qsp: torch.Tensor, sup4: torch.Tensor, k: int,
                  counts: torch.Tensor | None = None):
    """Launch the ring kernel (K9): same contract as
    ``knn_ring_torch(qsp, sup4, k, counts=counts)``."""
    out = _launch_ring(qsp, sup4, k, None, UNROLL, False, counts)
    knn_ring_cuda.launches += 1
    return out


def knn_ring_masked_cuda(qsp: torch.Tensor, sup4: torch.Tensor, k: int,
                         centers: torch.Tensor,
                         counts: torch.Tensor | None = None):
    """Launch the ring kernel with a centre table (K10): same contract as
    ``knn_ring_torch(qsp, sup4, k, centers, counts=counts)``."""
    out = _launch_ring(qsp, sup4, k, centers, UNROLL, False, counts)
    knn_ring_masked_cuda.launches += 1
    return out


def knn_ring_stats_cuda(qsp: torch.Tensor, sup4: torch.Tensor, k: int,
                        unroll: int = UNROLL,
                        counts: torch.Tensor | None = None):
    """Launch the ring kernel with counters (the stats twin): same contract
    as ``knn_ring_torch(qsp, sup4, k, unroll=unroll, stats=True,
    counts=counts)``."""
    out = _launch_ring(qsp, sup4, k, None, unroll, True, counts)
    knn_ring_stats_cuda.launches += 1
    return out


knn_ring_cuda.launches = 0
knn_ring_masked_cuda.launches = 0
knn_ring_stats_cuda.launches = 0


def _ring(query, support, k, masked, impl, unroll=UNROLL, stats=False):
    """Sort, scan (kernel or plain version), un-permute the query rows."""
    query = query.to(torch.float32)
    support = support.to(torch.float32)
    b, nq, _ = query.shape
    ns = support.shape[1]
    if k > ns:
        raise ValueError(f"k={k} > support size {ns}")
    if ns >= _IDX_RING:
        raise ValueError(f"the ring scan requires Ns < 2^24, got {ns}")
    qsp, sup4, centers, perm_q = _ring_inputs(query, support, masked)
    op = ("knn_ring_stats" if stats else
          "knn_ring_masked" if masked else "knn_ring")
    if dispatch.resolve(impl, qsp, op) == "cuda":
        if stats:
            d, ids, counters = knn_ring_stats_cuda(qsp, sup4, k, unroll)
        elif masked:
            d, ids, counters = knn_ring_masked_cuda(qsp, sup4, k, centers)
        else:
            d, ids, counters = knn_ring_cuda(qsp, sup4, k)
    else:
        d, ids, counters = knn_ring_torch(qsp, sup4, k, centers, unroll,
                                          stats)
    # Query rows back to the input order: row perm_q[r] gets sorted row r.
    inv = torch.empty_like(perm_q, dtype=torch.int64)
    inv.scatter_(1, perm_q.to(torch.int64),
                 torch.arange(nq, device=inv.device).expand(b, nq))
    inv = inv[..., None].expand(b, nq, k)
    return d.gather(1, inv), ids.gather(1, inv), counters


def knn_ring(query: torch.Tensor, support: torch.Tensor, k: int,
             tq: int = TQ, tm: int = TM, unroll: int = UNROLL,
             impl: str = "auto"):
    """Morton-ring kNN: [B,Nq,3], [B,Ns,3] -> (dist [B,Nq,k], idx int32),
    equal to :func:`knn`'s streaming scan on the same clouds. The support
    must be clean (no poison rows) and below 2^24 points.

    ``tq``, ``tm`` and ``unroll`` are the reference's query tile, support
    chunk and extraction unroll; the result does not depend on them (the
    kernel works in tiles of TQ = TM = 512), so they are accepted and
    change nothing."""
    del tq, tm, unroll  # the exact kNN is the same for every tiling
    return _ring(query, support, k, False, impl)[:2]


def knn_ring_masked(query: torch.Tensor, support: torch.Tensor, k: int,
                    tq: int = TQ, tm: int = TM, unroll: int = UNROLL,
                    impl: str = "auto"):
    """Morton-ring kNN for a POISONED support (validity |x0| < BIG_COORD):
    valid rows sort over the valid AABB with the poison last, and each
    query tile's ring starts at a centre scaled into the valid chunks.
    Equal to the streaming scan on the same poisoned cloud. ``tq``, ``tm``
    and ``unroll`` as in :func:`knn_ring`: accepted, and they change
    nothing."""
    del tq, tm, unroll  # the exact kNN is the same for every tiling
    return _ring(query, support, k, True, impl)[:2]


def _stats_tiles(tq: int, tm: int) -> None:
    """The stats' counters are per query tile of TQ rows and support chunk
    of TM rows: other tiles would count other things."""
    if (tq, tm) != (TQ, TM):
        raise ValueError(f"the ring stats count tiles of tq={TQ} and tm={TM}"
                         f" (the kernel's); got tq={tq}, tm={tm}")


def _knn_ring_stats_call(query: torch.Tensor, support: torch.Tensor, k: int,
                         tq: int = TQ, tm: int = TM, unroll: int = UNROLL,
                         impl: str = "auto"):
    """The stats twin: (dist, idx, counters [B,nI,2] int32), counters[...,
    0] the chunks each query tile visited (of nJ), counters[..., 1] the
    reference's extraction while-loop trips (times ``unroll`` = steps).
    ``tq`` and ``tm`` must be 512, the tiles the counters count."""
    _stats_tiles(tq, tm)
    return _ring(query, support, k, False, impl, unroll, True)


def knn_ring_stats(query: torch.Tensor, support: torch.Tensor, k: int,
                   tq: int = TQ, tm: int = TM, unroll: int = UNROLL,
                   impl: str = "auto"):
    """Telemetry of the ring scan: (dist, idx, dict) with visit_rate (the
    share of (query tile, chunk) pairs scanned after the AABB skip),
    visits_per_tile, chunks, trips_per_visit and steps_per_visit, the
    reference's keys. Reads the counters on the host. ``tq`` and ``tm``
    must be 512: the counters count the kernel's tiles."""
    d, ids, counters = _knn_ring_stats_call(query, support, k, tq, tm,
                                            unroll, impl)
    s = counters.to(torch.float64).cpu()
    nj = _round_up(support.shape[1], TM) // TM
    visits = float(s[..., 0].sum())
    trips = float(s[..., 1].sum())
    tiles = float(s.shape[0] * s.shape[1])
    return d, ids, {
        "visit_rate": visits / (tiles * nj),
        "visits_per_tile": visits / tiles,
        "chunks": nj,
        "trips_per_visit": trips / max(visits, 1.0),
        "steps_per_visit": trips * unroll / max(visits, 1.0),
    }


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def takes_ring(support: torch.Tensor, sorted_ok: bool = True) -> bool:
    """Whether :func:`knn` serves this support with the ring scan: an xyz
    cloud of ``RING_MIN_NS`` to 2^24 points, unless ``sorted_ok=False``."""
    ns = support.shape[1]
    return (sorted_ok and support.shape[-1] == 3
            and RING_MIN_NS <= ns < _IDX_RING)


def knn(query: torch.Tensor, support: torch.Tensor, k: int,
        tq: int | None = None, tm: int | None = None, sorted_ok: bool = True,
        masked: bool = False, impl: str = "auto"):
    """[B,Nq,C], [B,Ns,C] -> (dist [B,Nq,k] squared ascending, idx int32).

    Exact, lowest-index ties, any 1 <= k <= Ns. Clouds of another float
    dtype (bfloat16 features under the mixed-precision policy) are cast to
    float32 at entry, as the reference's Pallas scans cast them: the cast is
    exact, so the indices are those of a float32 call on the cast values
    (the reference's CPU XLA fallback computes bfloat16 distances instead).
    Masked supports arrive
    poisoned (``ops.grouping.knn``) with ``masked=True``. xyz supports of
    ``RING_MIN_NS`` to 2^24 points take the ring scan; ``sorted_ok=False``
    forces the streaming scan (the ring scan's cross-check), which every
    C != 3 cloud takes. ``tq`` and ``tm`` are the reference's streaming
    tiles: given, they force the streaming scan, as the reference's
    dispatch does, and otherwise change nothing (the kernel chooses its own
    split of the work, and the result does not depend on it).
    """
    ns = support.shape[1]
    if k > ns:
        raise ValueError(f"k={k} > support size {ns}")
    if tq is None and tm is None and takes_ring(support, sorted_ok):
        ring = knn_ring_masked if masked else knn_ring
        return ring(query, support, k, impl=impl)
    query = query.to(torch.float32)
    support = support.to(torch.float32)
    route = dispatch.resolve(impl, query, "knn")
    if dispatch.traced(impl):
        return _knn_op(query.contiguous(), support.contiguous(), k)
    if route == "cuda":
        return knn_cuda(query.contiguous(), support.contiguous(), k)
    return knn_torch(query, support, k)
