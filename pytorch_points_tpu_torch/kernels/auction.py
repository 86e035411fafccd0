"""Auction EMD assignment: the eps-scaled Gauss-Seidel auction (kernel K11)
and the JV shortest-augmenting-path endgame for its stragglers (kernel K12).

CUDA kernels: ``csrc/auction.cu``, which replaces the TPU kernel
``pytorch_points_tpu/kernels/auction.py::_auction_kernel`` (called by
``_auction_owner``), and ``csrc/augment.cu``, which replaces
``::_augment_kernel`` (called by ``_residual_rounds``). The header notes
there say what bounds each on the card: K11 the auction's own work (bidder
scans x N' pair evaluations) and its chunks' latency, on a cluster of up
to 8 SMs a cloud; K12 the latency of its chain of Dijkstra pops, one block
barrier each, on one SM a cloud.

Both kernels and both plain versions can report the work they did, through
an optional ``counts`` tensor: K11 its bidder scans and sweeps a phase, K12
its pops and capped stragglers a cloud. The kernel's counts equal the plain
version's, as its owners and prices do; a bound on each kernel's time
follows from them (PERF.md).

Semantics are the Pallas kernels', to the bit where both round alike:

* K11: persons bid in chunks of ``ti``; inside a chunk every bid uses the
  prices as they stood at the chunk's start (Jacobi), and the chunk is
  resolved (max bid per object, ties to the lowest person) before the next
  chunk bids (Gauss-Seidel). Benefits are -(((dx*dx) + dy*dy) + dz*dz) with
  every operation rounded alone; a person who owns an object does not bid;
  ``owner`` resets at each eps phase and prices carry over.
* K12: the stragglers, in ascending person index, each augmented by one
  Dijkstra pass over net costs in the reference's dot form, with a cap on
  the pops (``pop_cap``). The reference runs rounds of at most 256
  stragglers, at most 16 rounds; augmenting never unassigns anyone, so
  this is one pass over the first ``16 * min(256, N')`` of them.

The hardness hint that picks the phase budgets is one decision for the
whole batch and stays on the device: the kernel reads it and picks the
ladder itself, so a train step pays no host sync for it. The greedy
backstop after the endgame is a host loop; it can have work only when a
cloud has more stragglers than the endgame's cap (4096 a cloud), so below
N' = 4096 it is skipped and a call makes no host sync at all.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pytorch_points_tpu_torch.core.masking import BIG_COORD
from pytorch_points_tpu_torch.kernels import _build, dispatch

_ppt_auction = _build.entry("ppt_auction")
_ppt_auction_state_bytes = _build.entry("ppt_auction_state_bytes")
_ppt_auction_cluster = _build.entry("ppt_auction_cluster")
_ppt_augment = _build.entry("ppt_augment")
_ppt_augment_state_bytes = _build.entry("ppt_augment_state_bytes")
_ppt_augment_pop_floor = _build.entry("ppt_augment_pop_floor")

_IDX_BIG = 2**30
_NEG = -1.0e30
_INF = 1.0e30
S_MAX, MAX_ROUNDS = 256, 16  # the reference's endgame rounds
# Largest per-cloud state (bytes) kept in shared memory; the H100 gives a
# block up to 227 KB. Larger clouds keep it in a global scratch buffer.
_SMEM_MAX_BYTES = 224 * 1024


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _sqdist_rows(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[B,R,3], [B,N,3] -> [B,R,N], ((dx*dx + dy*dy) + dz*dz) with dx = p - q,
    each operation rounded on its own."""
    dx, dy, dz = (p[:, :, None, c] - q[:, None, :, c] for c in range(3))
    return (dx * dx + dy * dy) + dz * dz


def pad_twins(p: torch.Tensor, q: torch.Tensor, n_pad: int):
    """Pad both clouds to ``n_pad`` points with IDENTICAL far-away twins at
    x = BIG_COORD*8 + 16k: pad k of p is at distance 0 from pad k of q and
    astronomically far from everything else, so the auction matches pads to
    pads."""
    b, n, _ = p.shape
    if n_pad == n:
        return p, q
    offs = BIG_COORD * 8.0 + 16.0 * torch.arange(n_pad - n, dtype=torch.float32,
                                                 device=p.device)
    pad = torch.zeros((b, n_pad - n, 3), dtype=torch.float32, device=p.device)
    pad[:, :, 0] = offs
    return torch.cat([p, pad], 1), torch.cat([q, pad], 1)


def phase_schedule(eps: float, phases: int, scale: float) -> list[float]:
    """Per-phase bid increments: eps*scale^(phases-1), divided by ``scale``
    each phase, in double as the reference computes them; each is rounded
    to float32 when its phase starts."""
    out, eps_k = [], float(eps * scale ** (phases - 1))
    for _ in range(phases):
        out.append(float(np.float32(eps_k)))
        eps_k = eps_k / scale
    return out


def auction_torch(p: torch.Tensor, q: torch.Tensor, eps_k: list[float],
                  ladders: tuple[list[int], list[int]],
                  hint: torch.Tensor | None, ti: int, warm_start: bool,
                  counts: torch.Tensor | None = None):
    """Plain version of K11 on padded clouds [B,N',3]: (owner [B,N'] int32,
    object -> person, -1 = unowned; price [B,N'] f32).

    Chunk by chunk in torch ops, all clouds in lock-step: a cloud whose
    objects are all owned places no more bids, so its extra sweeps change
    nothing. ``ladders`` holds the per-phase iteration budgets, the second
    taken when ``hint`` (a bool tensor) is true.

    ``counts`` (int32 [B, 2, phases], or None) receives the work each cloud
    did: [:, 0, ph] its bidder scans in phase ph (a person who bids scans
    every object once), [:, 1, ph] its sweeps there (a cloud stops sweeping
    once it owns every object).
    """
    b, n, _ = p.shape
    dev = p.device
    f32 = torch.float32
    neg = torch.tensor(_NEG, dtype=f32, device=dev)
    iota = torch.arange(n, device=dev)
    price = torch.full((b, n), _NEG if warm_start else 0.0, dtype=f32,
                       device=dev)
    owner = torch.full((b, n), -1, dtype=torch.long, device=dev)
    chunks = range(0, (n // ti) * ti, ti)

    def benefit(c0):
        return -_sqdist_rows(p[:, c0 : c0 + ti], q)  # [B,ti,N]

    if warm_start:
        for c0 in chunks:
            price = torch.maximum(price, benefit(c0).amax(1))
    ladder = ladders[1 if hint is not None and bool(hint) else 0]
    if counts is not None:
        counts.zero_()
    for ph, eps in enumerate(eps_k):
        eps_t = torch.tensor(eps, dtype=f32, device=dev)
        owner.fill_(-1)
        for _ in range(ladder[ph]):
            if counts is not None:
                counts[:, 1, ph] += (owner < 0).any(1).int()
            for c0 in chunks:
                ben = benefit(c0)
                net = ben - price[:, None, :]
                v1 = net.amax(2, keepdim=True)
                a1 = torch.where(net == v1, iota, n).amin(2, keepdim=True)
                sel = iota == a1
                b1 = ben.gather(2, a1)
                v2 = torch.where(sel, neg, net).amax(2, keepdim=True)
                bid = (b1 - v2) + eps_t
                pidx = torch.arange(c0, c0 + ti, device=dev)
                assigned = (owner[:, None, :] == pidx[:, None]).any(
                    2, keepdim=True)
                bid = torch.where(assigned, neg, bid)
                if counts is not None:
                    counts[:, 0, ph] += (~assigned).sum((1, 2)).int()
                contrib = torch.where(sel, bid, neg)  # [B,ti,N]
                cbest = contrib.amax(1)
                cwin = torch.where(contrib == cbest[:, None], pidx[:, None],
                                   _IDX_BIG).amin(1)
                has = cbest > neg
                price = torch.where(has, cbest, price)
                owner = torch.where(has, cwin, owner)
            if bool((owner >= 0).all()):
                break
    return owner.to(torch.int32), price


def _budget_args(eps_k, ladders):
    phases = len(eps_k)
    eps_arr = (ctypes.c_float * phases)(*eps_k)
    bud_arr = (ctypes.c_int * (2 * phases))(*ladders[0], *ladders[1])
    return phases, eps_arr, bud_arr


def auction_cuda(p: torch.Tensor, q: torch.Tensor, eps_k: list[float],
                 ladders: tuple[list[int], list[int]],
                 hint: torch.Tensor | None, ti: int, warm_start: bool,
                 counts: torch.Tensor | None = None, cluster: int = 0):
    """Launch K11: same contract as :func:`auction_torch`, ``counts`` an
    int32 [B, 2, phases] tensor on the card. ``hint`` stays on the card;
    the kernel reads it and picks the ladder. ``cluster``: blocks a cloud
    (0: the most, up to 8, that fit on the card at once; 1: one block)."""
    b, n, _ = p.shape
    _build.require(p, "auction p", torch.float32, (b, n, 3))
    _build.require(q, "auction q", torch.float32, (b, n, 3))
    if hint is not None:
        _build.require(hint, "auction hint", torch.bool, ())
    if counts is not None:
        _build.require(counts, "auction counts", torch.int32,
                       (b, 2, len(eps_k)))
    if not eps_k:
        raise ValueError("auction: needs at least one phase")
    if not 1 <= ti <= n:
        raise ValueError(f"auction: need 1 <= ti <= N', got ti={ti} N'={n}")
    owner = torch.empty((b, n), dtype=torch.int32, device=p.device)
    price = torch.empty((b, n), dtype=torch.float32, device=p.device)
    state = _ppt_auction_state_bytes(n, ti)
    scratch = None
    if state > _SMEM_MAX_BYTES:
        scratch = torch.empty(b * state, dtype=torch.uint8, device=p.device)
    phases, eps_arr, bud_arr = _budget_args(eps_k, ladders)
    err = _ppt_auction(
        p.data_ptr(), q.data_ptr(), b, n, ti, phases, eps_arr, bud_arr,
        _build.ptr(hint), int(warm_start), owner.data_ptr(), price.data_ptr(),
        _build.ptr(counts), cluster, _build.ptr(scratch),
        state if scratch is not None else 0,
        _build.stream(p),
    )
    _build.check(err, "ppt_auction")
    auction_cuda.launches += 1
    return owner, price


auction_cuda.launches = 0


def auction_cluster_size(b: int, n: int, ti: int) -> int:
    """Blocks a cloud takes in K11 for ``b`` clouds of ``n`` points (a
    cluster of up to 8, the most whose clusters fit on the card at once;
    1: one block a cloud)."""
    return _ppt_auction_cluster(b, n, ti)


def augment_torch(owner: torch.Tensor, price: torch.Tensor, p: torch.Tensor,
                  q: torch.Tensor, eps: float, pop_cap: int, cap: int,
                  counts: torch.Tensor | None = None):
    """Plain version of K12 on padded clouds: (owner, price) after the JV
    endgame. Works on [B,N'] planes with every cloud in lock-step, as the
    reference's kernel does: straggler slot s of every cloud at once, a
    cloud with fewer stragglers masked out. A cloud that stopped popping is
    frozen, so extra pop steps change nothing; the loop checks for that
    every 16 pops.

    ``counts`` (int32 [B, 2], or None) receives each cloud's pops (the
    columns its Dijkstra searches took off the heap, the free column that
    ends a search included) and its capped stragglers (those whose search
    reached ``pop_cap`` pops without a free column)."""
    b, n = owner.shape
    dev = owner.device
    f32 = torch.float32
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    eps_t = torch.tensor(float(np.float32(eps)), dtype=f32, device=dev)
    lane = torch.arange(n, device=dev)
    owner = owner.long()
    px, py, pz = p.unbind(-1)
    qx, qy, qz = q.unbind(-1)
    qsq = (qx * qx + qy * qy) + qz * qz

    present = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    present.scatter_(1, torch.where(owner >= 0, owner, n), True)
    un = ~present[:, :n]
    count = un.sum(1, keepdim=True).clamp_max(cap)
    ids = torch.where(un, lane, _IDX_BIG).sort(1).values

    def row(i, qn):
        """Net cost row of person i [B,1]: c[i,:] + price, in the dot form."""
        pix, piy, piz = px.gather(1, i), py.gather(1, i), pz.gather(1, i)
        psq = (pix * pix + piy * piy) + piz * piz
        dot = (pix * qx + piy * qy) + piz * qz
        return (qn - 2.0 * dot) + psq

    if counts is not None:
        counts.zero_()
    for s in range(int(count.max()) if b else 0):
        valid = s < count  # [B,1]
        i0 = ids[:, s : s + 1].clamp_max(n - 1)
        qn = qsq + price
        dist = torch.where(valid, row(i0, qn), inf)
        pred = torch.full((b, n), -1, dtype=torch.long, device=dev)
        scan = torch.zeros((b, n), dtype=torch.bool, device=dev)
        active = valid.clone()
        jstar = torch.zeros((b, 1), dtype=torch.long, device=dev)
        dstar = torch.zeros((b, 1), dtype=f32, device=dev)
        for it in range(pop_cap):
            if it % 16 == 0 and not bool(active.any()):
                break
            if counts is not None:
                counts[:, 0] += active[:, 0].int()
            m = torch.where(scan, inf, dist)
            d = m.amin(1, keepdim=True)
            j = torch.where(m == d, lane, _IDX_BIG).amin(
                1, keepdim=True).clamp_max(n - 1)
            jstar = torch.where(active, j, jstar)
            dstar = torch.where(active, d, dstar)
            own_at = owner.gather(1, jstar)
            still = active & (own_at >= 0)
            scan = scan | ((lane == jstar) & still)
            ci = row(own_at.clamp_min(0), qn)
            base = (dstar - ci.gather(1, jstar)) + eps_t
            cand = base + ci
            improve = still & ~scan & (cand < dist)
            dist = torch.where(improve, cand, dist)
            pred = torch.where(improve, jstar, pred)
            active = still
        # pop cap reached before a free object: the nearest reachable free one
        if counts is not None:
            counts[:, 1] += active[:, 0].int()
        free_dist = torch.where(owner < 0, dist, inf)
        dfree = free_dist.amin(1, keepdim=True)
        jfree = torch.where(free_dist == dfree, lane, _IDX_BIG).amin(
            1, keepdim=True).clamp_max(n - 1)
        jstar = torch.where(active, jfree, jstar)
        dstar = torch.where(active, dfree, dstar)
        x = dstar - dist  # the rise is x where x > 0, else +0 (as the kernel)
        price = torch.where(scan & valid, price + torch.where(x > 0, x, 0.0),
                            price)
        walking, jcur = valid, jstar
        while bool(walking.any()):
            pj = pred.gather(1, jcur)
            newval = torch.where(pj < 0, i0,
                                 owner.gather(1, pj.clamp_min(0)))
            owner = torch.where((lane == jcur) & walking, newval, owner)
            walking = walking & (pj >= 0)
            jcur = pj.clamp_min(0)
    return owner.to(torch.int32), price


def augment_cuda(owner: torch.Tensor, price: torch.Tensor, p: torch.Tensor,
                 q: torch.Tensor, eps: float, pop_cap: int, cap: int,
                 counts: torch.Tensor | None = None):
    """Launch K12: same contract as :func:`augment_torch`, ``counts`` an
    int32 [B, 2] tensor on the card; one block per cloud, 4 columns a
    thread up to N' = 4096 (1024 threads over the state arrays past it)."""
    b, n = owner.shape
    _build.require(owner, "augment owner", torch.int32, (b, n))
    _build.require(price, "augment price", torch.float32, (b, n))
    _build.require(p, "augment p", torch.float32, (b, n, 3))
    _build.require(q, "augment q", torch.float32, (b, n, 3))
    if counts is not None:
        _build.require(counts, "augment counts", torch.int32, (b, 2))
    owner_out = torch.empty_like(owner)
    price_out = torch.empty_like(price)
    state = _ppt_augment_state_bytes(n)
    scratch = None
    if state > _SMEM_MAX_BYTES:
        scratch = torch.empty(b * state, dtype=torch.uint8, device=p.device)
    err = _ppt_augment(
        p.data_ptr(), q.data_ptr(), owner.data_ptr(), price.data_ptr(), b, n,
        float(np.float32(eps)), pop_cap, cap, owner_out.data_ptr(),
        price_out.data_ptr(), _build.ptr(counts), _build.ptr(scratch),
        state if scratch is not None else 0, _build.stream(p),
    )
    _build.check(err, "ppt_augment")
    augment_cuda.launches += 1
    return owner_out, price_out


augment_cuda.launches = 0


def augment_pop_floor(n: int, iters: int = 4096,
                      device: str | torch.device = "cuda"):
    """(cycles, ns) of one block argmin with its barrier on the block K12
    takes for N' = ``n`` columns, each depending on the one before, as
    K12's pops do: the least time of one pop, from clock64 and
    %globaltimer around ``iters`` of them on the card. A measurement aid
    for K12's latency bound, not a kernel of any path."""
    out = torch.zeros(3, dtype=torch.int64, device=device)
    err = _ppt_augment_pop_floor(n, iters, out.data_ptr(), _build.stream(out))
    _build.check(err, "ppt_augment_pop_floor")
    cycles, ns, _ = out.tolist()
    return cycles / iters, ns / iters


def _hardness_hint(p: torch.Tensor, q: torch.Tensor, thresh: float = 0.04):
    """Pre-auction difficulty signal, one bool for the whole batch (a
    tensor on the clouds' device): mean NN distance over mean pairwise
    distance on ~512-point subsamples, above ``thresh`` for any cloud. It
    only picks the phase budgets; completion and the eps-CS bound come from
    the endgame either way."""
    from pytorch_points_tpu_torch.ops.pairwise import pairwise_sqdist

    s = max(1, p.shape[1] // 512)
    d = pairwise_sqdist(p[:, ::s], q[:, ::s])
    nn = d.amin(2).mean(1)
    return (nn > thresh * d.mean((1, 2))).any()


def _auction_owner(p, q, eps, max_iters, ti, phases, scale, budgets=(),
                   warm_start=False, hint=None, hard_budgets=None,
                   impl="auto"):
    """Pad, then run K11: (owner [B,N'], price [B,N'], padded p, padded q).
    ``hard_budgets`` is the ladder taken when ``hint`` is true."""
    b, n, _ = p.shape
    n_pad = _round_up(n, max(ti, 128))
    p, q = pad_twins(p, q, n_pad)
    ladder = [int(budgets[ph]) if ph < len(budgets) else int(max_iters)
              for ph in range(phases)]
    ladders = (ladder, list(hard_budgets) if hard_budgets else ladder)
    eps_k = phase_schedule(eps, phases, scale)
    if dispatch.resolve(impl, p, "auction") == "cuda":
        owner, price = auction_cuda(p.contiguous(), q.contiguous(), eps_k,
                                    ladders, hint, ti, warm_start)
    else:
        owner, price = auction_torch(p, q, eps_k, ladders, hint, ti,
                                     warm_start)
    return owner, price, p, q


def _residual_rounds(owner, price, p, q, eps, pop_cap=768, s_max=S_MAX,
                     max_rounds=MAX_ROUNDS, impl="auto"):
    """Complete the assignment with JV augmenting paths (K12): (owner,
    price). At most ``max_rounds * min(s_max, N')`` stragglers per cloud
    are augmented, as the reference's round loop allows; any left over fall
    to the greedy backstop."""
    cap = max_rounds * min(s_max, owner.shape[1])
    if dispatch.resolve(impl, p, "augment") == "cuda":
        return augment_cuda(owner, price, p, q, eps, pop_cap, cap)
    return augment_torch(owner, price, p, q, eps, pop_cap, cap)


def _invert_and_complete(owner, p, q, n, complete: bool = True):
    """Object -> person owners [B,N'] to the person -> object assignment
    [B,n]; persons left without a real object take their nearest free one
    greedily, the first such person of each cloud per step (ties to the
    lowest index). ``complete=False`` says that every person owns an object
    already and skips that backstop, and with it a host sync."""
    b, n_pad = owner.shape
    dev = owner.device
    owner = owner.long()
    full = torch.full((b, n_pad + 1), _IDX_BIG, dtype=torch.long, device=dev)
    slot = torch.where(owner >= 0, owner, n_pad)
    objs = torch.arange(n_pad, device=dev).expand(b, n_pad)
    # unowned objects all land in the dropped column n_pad
    full.scatter_(1, slot, objs)
    assign = full[:, :n]
    if not complete or not bool((assign >= n).any()):
        return assign.to(torch.int32)
    p, q = p[:, :n], q[:, :n]
    barange = torch.arange(b, device=dev)
    owned = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    owned.scatter_(1, torch.where(assign < n, assign, n), True)
    owned = owned[:, :n]
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    while True:
        un = assign >= n
        do = un.any(1)
        if not bool(do.any()):
            break
        pi = un.int().argmax(1)  # first unassigned (0 if none)
        row = -_sqdist_rows(p[barange, pi][:, None], q)[:, 0]
        oj = torch.where(owned, neg, row).argmax(1)
        assign[barange[do], pi[do]] = oj[do]
        owned[barange[do], oj[do]] = True
    return assign.to(torch.int32)


def auction_assignment(p, q, eps: float, max_iters: int, ti: int = 256,
                       phases: int = 1, scale: float = 6.0,
                       pop_cap: int = 768, budgets: tuple = (),
                       auto_budget: bool = True, warm_start: bool = True,
                       counts_equal: bool = True, impl: str = "auto"):
    """[B,N,3] x2 -> person -> object assignment [B,N] int32 (a
    permutation): K11 with eps-scaling over ``phases`` (``max_iters`` per
    phase unless ``budgets`` says otherwise), K12 for its stragglers at the
    final eps, then the greedy backstop.

    ``counts_equal`` says that no person can be left holding an alignment
    pad past N: the clouds carry no poison pads, or as many in each. The
    endgame then gives every person a real object while its cap cannot
    bind, and the backstop (with its host sync) is skipped. ``False`` (the
    masked EMD with unequal valid counts) always runs it, as the
    reference does.

    With ``auto_budget`` (and no ``budgets``, ``phases >= 2``) the hardness
    hint picks between the default ladder and the generous one (40, 25,
    ..., max_iters), one decision for the batch, on the device.
    ``warm_start`` starts prices at the column maxima of the benefit
    (LAPJV column reduction) instead of 0."""
    p = p.detach().to(torch.float32)
    q = q.detach().to(torch.float32)
    b, n, _ = p.shape
    hint = hard = None
    if auto_budget and not budgets and phases >= 2:
        hard = ((40, 25) + (max_iters,) * phases)[: phases - 1] + (max_iters,)
        hint = _hardness_hint(p, q)
    owner, price, pp, qp = _auction_owner(p, q, eps, max_iters, ti, phases,
                                          scale, budgets, warm_start, hint,
                                          hard, impl)
    owner, _ = _residual_rounds(owner, price, pp, qp, eps, pop_cap,
                                impl=impl)
    # The endgame gives every straggler it takes an object (a free one is
    # always reachable), so with equal counts persons are left over only
    # past its cap; unpaired poison pads may end on alignment pads.
    n_pad = owner.shape[1]
    return _invert_and_complete(
        owner, pp, qp, n,
        not counts_equal or n_pad > MAX_ROUNDS * min(S_MAX, n_pad))


def auction_unassigned_count(p, q, eps: float, max_iters: int, ti: int = 256,
                             phases: int = 1, scale: float = 6.0,
                             impl: str = "auto"):
    """Diagnostic: per-cloud count [B] of objects K11 alone leaves unowned
    at its budget (cold start, default ladder)."""
    p = p.detach().to(torch.float32)
    q = q.detach().to(torch.float32)
    owner, _, _, _ = _auction_owner(p, q, eps, max_iters, ti, phases, scale,
                                    impl=impl)
    return (owner < 0).sum(1)
