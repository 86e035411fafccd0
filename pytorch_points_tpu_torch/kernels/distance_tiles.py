"""Dense nearest neighbour, both directions (kernel K5) or one (K13), and
the Morton-pruned worklist form of the bidirectional NN.

CUDA kernels: ``csrc/nn_dense.cu``, which replaces the TPU kernels
``pytorch_points_tpu/kernels/distance_tiles.py::_nn_both_kernel``
(``nn_both_directions``) and ``::_nn_kernel`` (``nn_one_direction``);
``csrc/nn_worklist.cu``, which replaces ``::_nn_worklist_kernel``
(``_run_worklist``, via ``nn_both_directions_pruned``). Both sources share
one pairs kernel (``csrc/nn_pairs.cuh``): a block a (p-tile, q-tile) pair,
each distance computed once and folded into both directions, blocks
merged through 64-bit (d, position) keys; the dense NN runs it over every
tile pair, the worklist over its list. The header notes there say what
bounds them on the card.

The Morton helpers shared with ``nn_sorted`` (codes, poison padding) live
here, as in the JAX package.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.core.masking import BIG_COORD
from pytorch_points_tpu_torch.kernels import _build, dispatch

_ppt_nn_dense = _build.entry("ppt_nn_dense")
_ppt_nn_worklist = _build.entry("ppt_nn_worklist")

# Query rows per block of the plain version: at most this many (p, q) pairs
# are materialised at once, so it runs at B=32 N=M=16384 (a dense
# [32, 16384, 16384] distance tensor would be 34 GB).
_PLAIN_PAIRS = 1 << 24


def sqdist_rows(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[R,3], [M,3] -> [R,M] squared distances, ((dx*dx + dy*dy) + dz*dz)
    with each operation rounded on its own, as the kernels compute them."""
    dx, dy, dz = (q[None, :, c] - p[:, None, c] for c in range(3))
    return (dx * dx + dy * dy) + dz * dz


def nn_one_direction_torch(p: torch.Tensor, q: torch.Tensor):
    """Plain version: [B,N,3], [B,M,3] -> (dist [B,N], idx [B,N] int32),
    the nearest q point of each p point, ties to the lowest index. Loops
    over clouds and query blocks to bound memory."""
    b, n, _ = p.shape
    m = q.shape[1]
    dist = torch.full((b, n), float("inf"), dtype=torch.float32,
                      device=p.device)
    idx = torch.zeros((b, n), dtype=torch.int32, device=p.device)
    rows = max(1, _PLAIN_PAIRS // m)
    iota = torch.arange(m, dtype=torch.int32, device=p.device)
    for bi in range(b):
        for s in range(0, n, rows):
            d = sqdist_rows(p[bi, s : s + rows], q[bi])
            mn = d.amin(dim=1, keepdim=True)
            dist[bi, s : s + rows] = mn[:, 0]
            idx[bi, s : s + rows] = torch.where(d == mn, iota, m).amin(dim=1)
    return dist, idx


def _launch_dense(p: torch.Tensor, q: torch.Tensor, both: bool):
    b, n, _ = p.shape
    m = q.shape[1]
    _build.require(p, "nn_dense p", torch.float32, (b, n, 3))
    _build.require(q, "nn_dense q", torch.float32, (b, m, 3))
    if m < 1 or (both and n < 1):
        raise ValueError(f"nn_dense: clouds of {n} and {m} points; the "
                         "other cloud of each direction must be non-empty")
    dev = p.device
    # the keys of the directions the kernel computes: p's, and q's with both
    keys = torch.empty(b * (n + m if both else n), dtype=torch.int64,
                       device=dev)
    d1 = torch.empty((b, n), dtype=torch.float32, device=dev)
    i1 = torch.empty((b, n), dtype=torch.int32, device=dev)
    d2 = i2 = None
    if both:
        d2 = torch.empty((b, m), dtype=torch.float32, device=dev)
        i2 = torch.empty((b, m), dtype=torch.int32, device=dev)
    err = _ppt_nn_dense(
        p.data_ptr(), q.data_ptr(), b, n, m, int(both), keys.data_ptr(),
        d1.data_ptr(), i1.data_ptr(), _build.ptr(d2), _build.ptr(i2),
        _build.stream(p),
    )
    _build.check(err, "ppt_nn_dense")
    return (d1, i1, d2, i2) if both else (d1, i1)


def nn_one_direction_cuda(p: torch.Tensor, q: torch.Tensor):
    """Launch the CUDA kernel with direction 2 off (K13): same contract as
    :func:`nn_one_direction_torch`."""
    out = _launch_dense(p, q, False)
    nn_one_direction_cuda.launches += 1
    return out


def nn_both_directions_cuda(p: torch.Tensor, q: torch.Tensor):
    """Launch the CUDA kernel, both directions in one pass (K5): the same
    bits as ``nn_one_direction_torch(p, q)`` and ``(q, p)``."""
    out = _launch_dense(p, q, True)
    nn_both_directions_cuda.launches += 1
    return out


nn_one_direction_cuda.launches = 0
nn_both_directions_cuda.launches = 0


@torch.library.custom_op("ppt::nn_both_directions", mutates_args=())
def _nn_both_op(p: torch.Tensor, q: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """K5 as one op for a traced program (kernels.dispatch.traced)."""
    if p.is_cuda:
        return nn_both_directions_cuda(p, q)
    return (*nn_one_direction_torch(p, q), *nn_one_direction_torch(q, p))


@_nn_both_op.register_fake
def _(p, q):
    (b, n), m = p.shape[:2], q.shape[1]
    return (p.new_empty((b, n)), p.new_empty((b, n), dtype=torch.int32),
            p.new_empty((b, m)), p.new_empty((b, m), dtype=torch.int32))


def nn_one_direction(p: torch.Tensor, q: torch.Tensor, tn: int | None = None,
                     tm: int | None = None, impl: str = "auto"):
    """For each p point, (min squared distance over q, argmin index):
    [B,N,3], [B,M,3] -> (dist [B,N] f32, idx [B,N] int32), lowest-index
    ties. Masked points arrive poisoned (``ops.chamfer.nndistance``).

    ``tn`` and ``tm`` are the reference's tile sizes; the result does not
    depend on them, and the kernel chooses its own tiles, so they are
    accepted and change nothing."""
    del tn, tm  # every tiling gives the same bits
    if q.shape[1] < 1:
        raise ValueError("nn_one_direction needs a non-empty q cloud")
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    if dispatch.resolve(impl, p, "nn_dense") == "cuda":
        return nn_one_direction_cuda(p.contiguous(), q.contiguous())
    return nn_one_direction_torch(p, q)


def nn_both_directions(p: torch.Tensor, q: torch.Tensor,
                       tn: int | None = None, tm: int | None = None,
                       impl: str = "auto"):
    """Bidirectional NN: (dist1 [B,N], idx1, dist2 [B,M], idx2), the
    reference nmdistance contract. On the card one pass computes each
    distance once and folds it into both directions; the plain version is
    two one-direction passes, p -> q and q -> p. ``tn`` and ``tm`` as in
    :func:`nn_one_direction`."""
    del tn, tm  # every tiling gives the same bits
    if p.shape[1] < 1 or q.shape[1] < 1:
        raise ValueError("nn_both_directions needs two non-empty clouds")
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    route = dispatch.resolve(impl, p, "nn_dense")
    if dispatch.traced(impl):
        return _nn_both_op(p.contiguous(), q.contiguous())
    if route == "cuda":
        return nn_both_directions_cuda(p.contiguous(), q.contiguous())
    return (*nn_one_direction_torch(p, q), *nn_one_direction_torch(q, p))


# ---------------------------------------------------------------------------
# Morton helpers (shared with nn_sorted)
# ---------------------------------------------------------------------------


def _interleave(q: torch.Tensor) -> torch.Tensor:
    """[B,N,3] int64 cells of 10 bits -> [B,N] Morton codes."""

    def spread(v):  # spread 10 bits to every 3rd bit
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (
        spread(q[..., 2]) << 2)


def _morton_codes(xyz: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """[B,N,3] -> [B,N] int64 Morton codes over each cloud's AABB, in the
    reference's operation order (its uint32 codes, held in int64)."""
    lo = xyz.amin(dim=1, keepdim=True)
    hi = xyz.amax(dim=1, keepdim=True)
    t = (xyz - lo) / torch.clamp_min(hi - lo, 1e-12)
    return _interleave((t * (2**bits - 1)).to(torch.int64).clamp_(
        0, 2**bits - 1))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pad_poison(x: torch.Tensor, target_n: int, sign: float) -> torch.Tensor:
    """Pad [B,N,3] to [B,target_n,3] with the reference's far-away,
    mutually distant rows, sign * (4 BIG_COORD + 8 i) along x: sign +1 is
    its ``_pad_points_poison`` (p clouds), -1 its
    ``_pad_points_poison_neg`` (q clouds)."""
    b, n, c = x.shape
    if n == target_n:
        return x
    pad = x.new_zeros((b, target_n - n, c))
    pad[..., 0] = sign * (BIG_COORD * 4.0 + 8.0 * torch.arange(
        target_n - n, dtype=x.dtype, device=x.device))
    return torch.cat([x, pad], dim=1)


def _tile_bounds(x: torch.Tensor, tile: int):
    """Sorted [B,N',3] -> (lo [B,nT,3], hi [B,nT,3]) of each tile."""
    b, n, _ = x.shape
    xr = x.reshape(b, n // tile, tile, 3)
    return xr.amin(dim=2), xr.amax(dim=2)


# ---------------------------------------------------------------------------
# worklist NN over candidate tile pairs
# ---------------------------------------------------------------------------


def _worklist_codes(cand: torch.Tensor, k_max: int):
    """The reference's compacted worklist of a [B,nI,nJ] candidate mask.

    Returns (codes1 [B,k_max] int32, codes2 [B,k_max] int32, count [B]
    int32): ``codes1`` the first k_max candidate pairs in i-major order as
    i*nJ + j, ascending; ``codes2`` the same pairs as j*nI + i, ascending
    (j-major), which only the plain version reads; entries past min(count,
    k_max) are padding that nothing reads. Only the first k_max pairs in
    i-major order run, as in the reference; count is the number of
    candidates before that cut."""
    b, ni, nj = cand.shape
    if not 1 <= k_max <= ni * nj:
        raise ValueError(f"k_max={k_max} must lie in [1, {ni * nj}]")
    flat = cand.reshape(b, ni * nj).to(torch.int32)
    count = flat.sum(dim=1, dtype=torch.int32)
    # stable sort, candidates first: i-major order kept
    order = torch.sort(1 - flat, dim=1, stable=True).indices[:, :k_max]
    real = torch.arange(k_max, device=cand.device)[None] < count[:, None]
    codes1 = torch.where(real, order, ni * nj)
    jmajor = torch.where(real, (order % nj) * ni + order // nj, ni * nj)
    codes2 = torch.sort(jmajor, dim=1).values
    return codes1.to(torch.int32), codes2.to(torch.int32), count


def _worklist_one_way(rows, cols, codes, count, t_row, t_col):
    """Plain version of one direction: each row's lexicographic minimum of
    (d^2, column position) over the column tiles its row tile is paired
    with in the first min(count, k_max) ``codes`` (row_tile * nC +
    col_tile); (inf, 0) where its tile has none."""
    b, nr, _ = rows.shape
    nc = cols.shape[1]
    n_rt, n_ct = nr // t_row, nc // t_col
    k_max = codes.shape[1]
    live = torch.arange(k_max, device=rows.device)[None] < count[:, None]
    pairs = torch.zeros((b, n_rt * n_ct + 1), dtype=torch.bool,
                        device=rows.device)
    pairs.scatter_(1, torch.where(live, codes, n_rt * n_ct).long(), True)
    pairs = pairs[:, :-1].reshape(b, n_rt, n_ct)
    dist = torch.empty((b, nr), dtype=torch.float32, device=rows.device)
    ids = torch.empty((b, nr), dtype=torch.int32, device=rows.device)
    iota = torch.arange(nc, dtype=torch.int32, device=rows.device)
    block = t_row * max(1, _PLAIN_PAIRS // (t_row * nc))
    for bi in range(b):
        for s in range(0, nr, block):
            e = min(s + block, nr)
            ok = pairs[bi, s // t_row : e // t_row]
            ok = ok.repeat_interleave(t_row, 0).repeat_interleave(t_col, 1)
            d = torch.where(ok, sqdist_rows(rows[bi, s:e], cols[bi]),
                            float("inf"))
            mn = d.amin(dim=1, keepdim=True)
            first = torch.where(ok & (d == mn), iota, nc).amin(dim=1)
            dist[bi, s:e] = mn[:, 0]
            ids[bi, s:e] = torch.where(first == nc, 0, first)
    return dist, ids


def run_worklist_torch(pp: torch.Tensor, qp: torch.Tensor,
                       codes1: torch.Tensor, codes2: torch.Tensor,
                       count: torch.Tensor, tn: int, tm: int):
    """Plain version of the worklist NN on padded, sorted clouds pp
    [B,N',3] (tiles of ``tn``) and qp [B,M',3] (tiles of ``tm``), over the
    pairs of :func:`_worklist_codes`: (d1s [B,N'], i1s, d2s [B,M'], i2s),
    each row's lexicographic minimum of (d^2, position in the other
    cloud) over its candidate pairs, (inf, 0) for a row with none."""
    return (*_worklist_one_way(pp, qp, codes1, count, tn, tm),
            *_worklist_one_way(qp, pp, codes2, count, tm, tn))


def run_worklist_cuda(pp: torch.Tensor, qp: torch.Tensor,
                      codes1: torch.Tensor, codes2: torch.Tensor,
                      count: torch.Tensor, tn: int, tm: int):
    """Launch the worklist kernel, both directions in one pass over the
    i-major list ``codes1`` (``codes2`` is not read): same contract as
    :func:`run_worklist_torch`."""
    del codes2  # the pass folds each pair into both directions
    b, n_pad, _ = pp.shape
    m_pad = qp.shape[1]
    k_max = codes1.shape[1]
    _build.require(pp, "nn_worklist pp", torch.float32, (b, n_pad, 3))
    _build.require(qp, "nn_worklist qp", torch.float32, (b, m_pad, 3))
    _build.require(codes1, "nn_worklist codes1", torch.int32, (b, k_max))
    _build.require(count, "nn_worklist count", torch.int32, (b,))
    if n_pad % tn or m_pad % tm:
        raise ValueError(f"nn_worklist: clouds of {n_pad} and {m_pad} rows "
                         f"are not whole tiles of {tn} and {tm}")
    dev = pp.device
    keys = torch.empty(b * (n_pad + m_pad), dtype=torch.int64, device=dev)
    d1 = torch.empty((b, n_pad), dtype=torch.float32, device=dev)
    i1 = torch.empty((b, n_pad), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, m_pad), dtype=torch.float32, device=dev)
    i2 = torch.empty((b, m_pad), dtype=torch.int32, device=dev)
    err = _ppt_nn_worklist(
        pp.data_ptr(), qp.data_ptr(), codes1.data_ptr(), count.data_ptr(), b,
        n_pad, m_pad, tn, tm, k_max, keys.data_ptr(), d1.data_ptr(),
        i1.data_ptr(), d2.data_ptr(), i2.data_ptr(), _build.stream(pp),
    )
    _build.check(err, "ppt_nn_worklist")
    run_worklist_cuda.launches += 1
    return d1, i1, d2, i2


run_worklist_cuda.launches = 0


def _run_worklist(cand, pp, qp, b, ni, nj, tn, tm, n_pad, k_max,
                  impl: str = "auto"):
    """Counterpart of the reference's ``_run_worklist``: compact the
    candidate pairs into an i-major worklist of ``k_max`` entries and run
    the NN over exactly those pairs. ``pp`` [B,n_pad,3] and ``qp``
    [B,M',3] are the padded sorted clouds (point-major here; the reference
    passes them coordinate-major). Returns ((d1s [B,n_pad], i1s, d2s
    [B,M'], i2s), count [B] int32), indices into the sorted clouds."""
    if cand.shape != (b, ni, nj) or pp.shape[1] != n_pad \
            or n_pad != ni * tn or qp.shape[1] != nj * tm:
        raise ValueError(f"_run_worklist: cand {tuple(cand.shape)} and "
                         f"clouds {tuple(pp.shape)}, {tuple(qp.shape)} do "
                         f"not make {ni} x {nj} tiles of {tn} x {tm}")
    codes1, codes2, count = _worklist_codes(cand, k_max)
    args = (pp.contiguous(), qp.contiguous(), codes1, codes2, count, tn, tm)
    if dispatch.resolve(impl, pp, "nn_worklist") == "cuda":
        return run_worklist_cuda(*args), count
    return run_worklist_torch(*args), count


def pruned_plan(p: torch.Tensor, q: torch.Tensor, tn: int | None = None,
                tm: int | None = None) -> dict:
    """Everything ``nn_both_directions_pruned`` computes before its
    worklist: the stable Morton permutations, the poison-padded sorted
    clouds, the AABB lower bound and the rank-aligned upper bounds, the
    candidate mask, the budget ``k_max`` and each cloud's candidate count,
    in the reference's arithmetic (``distance_tiles.py:567-621``). The
    default tiles are the reference's: they fix the budget."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    b, n, _ = p.shape
    m = q.shape[1]
    if tn is None:
        tn = min(1024, _round_up(n, 128))
    if tm is None:
        tm = min(256 if m >= 8192 else 512, _round_up(m, 8))
    n_pad, m_pad = _round_up(n, tn), _round_up(m, tm)
    ni, nj = n_pad // tn, m_pad // tm
    perm_p = torch.sort(_morton_codes(p), dim=1, stable=True).indices
    perm_q = torch.sort(_morton_codes(q), dim=1, stable=True).indices
    ps = p.gather(1, perm_p[..., None].expand(b, n, 3))
    qs = q.gather(1, perm_q[..., None].expand(b, m, 3))
    # poisoned before the bounds: the last tile's box holds its poison
    pp = _pad_poison(ps, n_pad, 1.0)
    qp = _pad_poison(qs, m_pad, -1.0)
    plo, phi = _tile_bounds(pp, tn)
    qlo, qhi = _tile_bounds(qp, tm)
    gap = torch.maximum(qlo[:, None] - phi[:, :, None],
                        plo[:, :, None] - qhi[:, None]).clamp_min(0.0)
    gap = gap * gap
    lb = (gap[..., 0] + gap[..., 1]) + gap[..., 2]  # [B, nI, nJ]

    def aligned(a, other, na, no, pad_to, tile):
        """Max over each tile of a's distance to the rank-aligned point of
        ``other``; inf for a tile with padding (it keeps every pair)."""
        diff = a - other[:, torch.arange(na, device=a.device) * no // na]
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        d = torch.nn.functional.pad(d, (0, pad_to - na), value=float("inf"))
        return d.reshape(b, pad_to // tile, tile).amax(dim=2)

    ub1 = aligned(ps, qs, n, m, n_pad, tn)  # [B, nI]
    ub2 = aligned(qs, ps, m, n, m_pad, tm)  # [B, nJ]
    safe = 1.0 + 1e-5
    cand = (lb <= ub1[:, :, None] * safe) | (lb <= ub2[:, None, :] * safe)
    k_max = max(ni, min(ni * nj, int(0.45 * ni * nj) + ni))
    return dict(perm_p=perm_p, perm_q=perm_q, pp=pp, qp=qp, cand=cand,
                count=cand.reshape(b, -1).sum(dim=1), k_max=k_max, tn=tn,
                tm=tm, ni=ni, nj=nj, n_pad=n_pad, m_pad=m_pad)


def nn_both_directions_pruned(p: torch.Tensor, q: torch.Tensor,
                              tn: int | None = None, tm: int | None = None,
                              impl: str = "auto"):
    """Bidirectional NN with Morton-sorted AABB tile pruning, the
    reference's ``nn_both_directions_pruned``: (dist1 [B,N], idx1 int32,
    dist2 [B,M], idx2 int32) in original order.

    Both clouds are sorted along a Morton curve (stable), padded with
    poison and cut into tiles (the reference's default ``tn``, ``tm``);
    a tile pair is a candidate when its AABB lower bound does not exceed
    the rank-aligned upper bound of either tile (:func:`pruned_plan`). The
    i-major list of candidate pairs has a static budget ``k_max``.

    Two branches, by the data, as the reference's ``lax.cond`` chooses:

    * every cloud has at most ``k_max`` candidate pairs: the worklist
      kernel (``csrc/nn_worklist.cu``) scans exactly those pairs, and the
      result is un-permuted. Ties resolve to the lowest SORTED position,
      so an index may differ from the dense kernel's on exact ties;
    * some cloud has more: the dense kernel (K5, :func:`nn_both_directions`)
      answers for the whole batch, ties to the lowest original index.

    The second branch is the reference's semantics, not a fallback for a
    kernel that failed: a failed build or launch raises. The count is read
    on the host once per call (this op lies on no train step), and only
    the branch that answers runs. In practice the worklist answers only
    when q is p up to a permutation; on independent clouds nearly every
    tile pair is a candidate."""
    plan = pruned_plan(p, q, tn, tm)
    if bool((plan["count"] > plan["k_max"]).any()):
        return nn_both_directions(p, q, impl=impl)
    b, n = plan["perm_p"].shape
    m = plan["perm_q"].shape[1]
    (d1s, i1s, d2s, i2s), _ = _run_worklist(
        plan["cand"], plan["pp"], plan["qp"], b, plan["ni"], plan["nj"],
        plan["tn"], plan["tm"], plan["n_pad"], plan["k_max"], impl)
    perm_p, perm_q = plan["perm_p"], plan["perm_q"]

    def unpermute(perm, d, i, other_perm, k):
        """out[perm[r]] = (d[r], other_perm[i[r]]) for the k real rows."""
        ids = other_perm.gather(1, i[:, :k].long()).to(torch.int32)
        return (torch.empty_like(d[:, :k]).scatter_(1, perm, d[:, :k]),
                torch.empty_like(ids).scatter_(1, perm, ids))

    return (*unpermute(perm_p, d1s, i1s, perm_q, n),
            *unpermute(perm_q, d2s, i2s, perm_p, m))
