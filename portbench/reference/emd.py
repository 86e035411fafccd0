"""The auction EMD in plain float32 PyTorch: the reference's copy of the
assignment that the port's EMD defines (``ops/emd.py`` and
``kernels/auction.py`` of the port, whose semantics are these).

An eps-scaled auction in chunks of ``ti`` persons (Jacobi inside a chunk,
Gauss-Seidel between chunks, ties to the lowest index, benefits
``-(((dx*dx) + dy*dy) + dz*dz)`` rounded an operation at a time), started
from the column maxima of the benefit; its stragglers finished in ascending
person order by one capped Dijkstra pass each (JV augmenting paths over net
costs in the dot form, ``endgame.py``, a cloud a worker process); any
person still without a real object takes the
nearest free one. The loss is the squared distance along the matched
pairs; autograd's gradient flows along them, the assignment held constant.
Imports nothing of the port.
"""

from __future__ import annotations

import multiprocessing as mp
import os

import numpy as np
import torch

from portbench.reference import endgame

BIG_COORD = 2.0e4
_IDX_BIG = 2**30
_NEG = -1.0e30
_INF = 1.0e30
S_MAX, MAX_ROUNDS = 256, 16


def _sqdist_rows(p, q):
    dx, dy, dz = (p[:, :, None, c] - q[:, None, :, c] for c in range(3))
    return (dx * dx + dy * dy) + dz * dz


def _pad_twins(p, q, n_pad):
    b, n, _ = p.shape
    if n_pad == n:
        return p, q
    offs = BIG_COORD * 8.0 + 16.0 * torch.arange(
        n_pad - n, dtype=torch.float32, device=p.device)
    pad = torch.zeros((b, n_pad - n, 3), dtype=torch.float32, device=p.device)
    pad[:, :, 0] = offs
    return torch.cat([p, pad], 1), torch.cat([q, pad], 1)


def _phase_schedule(eps, phases, scale):
    out, eps_k = [], float(eps * scale ** (phases - 1))
    for _ in range(phases):
        out.append(float(np.float32(eps_k)))
        eps_k = eps_k / scale
    return out


def _hardness_hint(p, q, thresh=0.04):
    """Whether any cloud is hard: mean NN distance over mean pairwise
    distance on ~512-point subsamples above ``thresh`` (a float32 matmul
    for the cross term, as the definition has it)."""
    s = max(1, p.shape[1] // 512)
    a, b = p[:, ::s], q[:, ::s]
    cross = torch.matmul(a, b.transpose(-1, -2))
    d = torch.clamp_min((a * a).sum(-1)[..., :, None]
                        + (b * b).sum(-1)[..., None, :] - 2.0 * cross, 0.0)
    nn = d.amin(2).mean(1)
    return bool((nn > thresh * d.mean((1, 2))).any())


def _auction(p, q, eps_k, ladder, ti):
    b, n, _ = p.shape
    dev = p.device
    f32 = torch.float32
    neg = torch.tensor(_NEG, dtype=f32, device=dev)
    iota = torch.arange(n, device=dev)
    price = torch.full((b, n), _NEG, dtype=f32, device=dev)
    owner = torch.full((b, n), -1, dtype=torch.long, device=dev)
    chunks = range(0, (n // ti) * ti, ti)

    def benefit(c0):
        return -_sqdist_rows(p[:, c0 : c0 + ti], q)

    for c0 in chunks:
        price = torch.maximum(price, benefit(c0).amax(1))
    for ph, eps in enumerate(eps_k):
        eps_t = torch.tensor(eps, dtype=f32, device=dev)
        owner.fill_(-1)
        for _ in range(ladder[ph]):
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
                contrib = torch.where(sel, bid, neg)
                cbest = contrib.amax(1)
                cwin = torch.where(contrib == cbest[:, None], pidx[:, None],
                                   _IDX_BIG).amin(1)
                has = cbest > neg
                price = torch.where(has, cbest, price)
                owner = torch.where(has, cwin, owner)
            if bool((owner >= 0).all()):
                break
    return owner, price


def _augment(owner, price, p, q, eps, pop_cap, cap):
    """The endgame of every cloud (``endgame.augment_cloud``), on the host;
    clouds in parallel worker processes when there are several."""
    args = [(o, pr, a, b, float(np.float32(eps)), pop_cap, cap)
            for o, pr, a, b in zip(owner.cpu().numpy(), price.cpu().numpy(),
                                   p.cpu().numpy(), q.cpu().numpy())]
    workers = min(len(args), os.cpu_count() or 1, 8)
    if workers < 2:
        outs = [endgame.augment_job(a) for a in args]
    else:
        pool = mp.get_context("spawn").Pool(workers)
        try:
            outs = pool.map(endgame.augment_job, args, chunksize=1)
        finally:
            pool.close()
            pool.join()
    return torch.from_numpy(np.stack(outs)).to(owner.device)


def _invert_and_complete(owner, p, q, n, complete):
    b, n_pad = owner.shape
    dev = owner.device
    full = torch.full((b, n_pad + 1), _IDX_BIG, dtype=torch.long, device=dev)
    slot = torch.where(owner >= 0, owner, n_pad)
    objs = torch.arange(n_pad, device=dev).expand(b, n_pad)
    full.scatter_(1, slot, objs)
    assign = full[:, :n]
    if not complete or not bool((assign >= n).any()):
        return assign
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
        pi = un.int().argmax(1)
        row = -_sqdist_rows(p[barange, pi][:, None], q)[:, 0]
        oj = torch.where(owned, neg, row).argmax(1)
        assign[barange[do], pi[do]] = oj[do]
        owned[barange[do], oj[do]] = True
    return assign


def assignment(p, q, eps=0.005, max_iters=15, phases=3, pop_cap=768,
               ti=256, scale=6.0):
    """Person -> object assignment [B,N] long between equal-size clouds."""
    p = p.detach().to(torch.float32)
    q = q.detach().to(torch.float32)
    b, n, _ = p.shape
    hard = ((40, 25) + (max_iters,) * phases)[: phases - 1] + (max_iters,)
    ladder = list(hard) if _hardness_hint(p, q) else [max_iters] * phases
    n_pad = -(-n // max(ti, 128)) * max(ti, 128)
    pp, qp = _pad_twins(p, q, n_pad)
    eps_k = _phase_schedule(eps, phases, scale)
    owner, price = _auction(pp, qp, eps_k, ladder, ti)
    cap = MAX_ROUNDS * min(S_MAX, n_pad)
    owner = _augment(owner, price, pp, qp, eps, pop_cap, cap)
    return _invert_and_complete(owner, pp, qp, n, n_pad > cap)


def emd(p, q, **kw):
    """[B,N] squared distances along the matched pairs."""
    a = assignment(p, q, **kw)
    diff = p - q.gather(1, a[..., None].expand(-1, -1, 3))
    dx, dy, dz = diff.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz
