"""The EMD endgame of one cloud in NumPy: its stragglers, in ascending
person order, each finished by one Dijkstra pass (JV augmenting path) over
net costs in the dot form, with at most ``pop_cap`` pops.

Every operation is float32 and rounded alone, in the order that
``emd._augment`` writes for all clouds in lock-step; a cloud's result
depends on that cloud alone, so one cloud at a time gives the same
owners. Kept apart (NumPy only) so that worker processes load no torch.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
INF = F32(1.0e30)


def augment_cloud(owner, price, p, q, eps, pop_cap: int, cap: int):
    """(owner [n] int64, object -> person or -1) after the endgame; ``p``
    and ``q`` [n,3] float32, ``price`` [n] float32."""
    owner = owner.astype(np.int64).copy()
    price = price.astype(F32).copy()
    n = owner.shape[0]
    eps = F32(eps)
    px, py, pz = (np.ascontiguousarray(p[:, c], dtype=F32) for c in range(3))
    qx, qy, qz = (np.ascontiguousarray(q[:, c], dtype=F32) for c in range(3))
    qsq = (qx * qx + qy * qy) + qz * qz
    present = np.zeros(n + 1, dtype=bool)
    present[np.where(owner >= 0, owner, n)] = True
    ids = np.flatnonzero(~present[:n])[:cap]
    dot = np.empty(n, dtype=F32)
    tmp = np.empty(n, dtype=F32)

    def row(i, qn):
        pix, piy, piz = px[i], py[i], pz[i]
        psq = (pix * pix + piy * piy) + piz * piz
        np.multiply(qx, pix, out=dot)
        np.multiply(qy, piy, out=tmp)
        np.add(dot, tmp, out=dot)
        np.multiply(qz, piz, out=tmp)
        np.add(dot, tmp, out=dot)
        return (qn - F32(2.0) * dot) + psq

    for i0 in ids:
        qn = qsq + price
        dist = row(i0, qn)
        pred = np.full(n, -1, dtype=np.int64)
        scan = np.zeros(n, dtype=bool)
        active = True
        jstar, dstar = 0, F32(0.0)
        for _ in range(pop_cap):
            m = np.where(scan, INF, dist)
            jstar = int(np.argmin(m))  # the lowest index of the minimum
            dstar = m[jstar]
            own = int(owner[jstar])
            if own < 0:
                active = False
                break
            scan[jstar] = True
            ci = row(own, qn)
            cand = ((dstar - ci[jstar]) + eps) + ci
            improve = ~scan & (cand < dist)
            dist = np.where(improve, cand, dist)
            pred[improve] = jstar
        if active:  # capped: the nearest reachable free object
            free = np.where(owner < 0, dist, INF)
            jstar = int(np.argmin(free))
            dstar = free[jstar]
        x = dstar - dist
        price = np.where(scan, price + np.where(x > 0, x, F32(0.0)), price)
        jcur = jstar
        while True:
            pj = int(pred[jcur])
            owner[jcur] = i0 if pj < 0 else owner[pj]
            if pj < 0:
                break
            jcur = pj
    return owner


def augment_job(args):
    """:func:`augment_cloud` on a tuple of its arguments (for a pool)."""
    return augment_cloud(*args)
