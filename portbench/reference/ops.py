"""Plain float32 PyTorch point-cloud operations: the reference that the
benchmark holds the port against.

A frozen copy of the arithmetic that the port's semantics fix (each squared
distance as ``(dx*dx + dy*dy) + dz*dz`` with every operation rounded alone,
ties to the lowest index), written in plain torch ops and imported from
nothing of the port. Gradients come from autograd over these ops.

``tf32=True`` computes every matmul with TF32 operands: on the card with
``torch.backends.cuda.matmul.allow_tf32`` switched on, on the CPU by
rounding both operands to TF32's 10-bit mantissa (the CPU has no TF32). It
is the correctness control, never the reference itself.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

LAYER_NORM_EPS = 1e-6


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Within the context, card matmuls use TF32 when ``tf32`` (and full
    float32 otherwise)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _LinearTF32(torch.autograd.Function):
    """x @ w.T + b with every product's operands rounded to TF32, in the
    backward too, as the card's TF32 matmuls compute."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return F.linear(xr, wr, b)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_tf32(g)
        gx = gr @ wr
        gw = gr.reshape(-1, gr.shape[-1]).T @ xr.reshape(-1, xr.shape[-1])
        return gx, gw, g.reshape(-1, g.shape[-1]).sum(0)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           tf32: bool = False) -> torch.Tensor:
    """x @ w.T + b; with ``tf32`` on the CPU, the products' operands
    rounded to TF32 (on the card :func:`matmul_precision` decides)."""
    if tf32 and not x.is_cuda:
        return _LinearTF32.apply(x, w, b)
    return F.linear(x, w, b)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    return F.layer_norm(x, (x.shape[-1],), w, b, LAYER_NORM_EPS)


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B,R,3], [B,N,3] -> [B,R,N] squared distances in the diff form."""
    dx, dy, dz = (a[:, :, None, c] - b[:, None, :, c] for c in range(3))
    return (dx * dx + dy * dy) + dz * dz


def gather_rows(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B,N,C], [B,...] int -> [B,...,C]."""
    b = f.shape[0]
    flat = idx.reshape(b, -1).long()
    out = f.gather(1, flat[..., None].expand(-1, -1, f.shape[-1]))
    return out.reshape(*idx.shape, f.shape[-1])


def fps(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """Furthest point sampling from index 0: [B,N,3] -> [B,k] long; the
    next point is the lowest index attaining the largest distance to the
    chosen set; no fold at step 0."""
    b, n, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    mind = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    iota = torch.arange(n, device=xyz.device)
    idx = torch.empty((b, k), dtype=torch.long, device=xyz.device)
    sel = None
    for j in range(k):
        if j > 0:
            sx, sy, sz = (c.gather(1, sel) for c in (x, y, z))
            dx, dy, dz = x - sx, y - sy, z - sz
            mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        m = mind.amax(dim=1, keepdim=True)
        sel = torch.where(mind == m, iota, n).amin(dim=1, keepdim=True)
        idx[:, j : j + 1] = sel
    return idx


def ball_query(xyz: torch.Tensor, centroids: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """The first ``nsample`` points strictly within ``radius`` (d^2 < r^2,
    r^2 rounded to float32) of each centroid, in index order; a short row
    repeats its first hit, an empty row is all 0. [B,P,nsample] long. One
    cloud at a time, to bound memory."""
    r2 = float(np.float32(float(radius) ** 2))
    n = xyz.shape[1]
    iota = torch.arange(n, device=xyz.device)
    rows = []
    for i in range(xyz.shape[0]):
        hit = sqdist(centroids[i : i + 1], xyz[i : i + 1]) < r2
        key = torch.where(hit, iota, n)
        first_hits = torch.topk(key, nsample, dim=-1, largest=False).values
        first = first_hits[..., :1]
        first = torch.where(first == n, 0, first)
        rows.append(torch.where(first_hits == n, first, first_hits))
    return torch.cat(rows)


def knn(query: torch.Tensor, support: torch.Tensor, k: int):
    """(d [B,Nq,k] ascending, idx [B,Nq,k] long) over xyz clouds, ties to
    the lowest index (a stable sort); one cloud at a time."""
    ds, ids = [], []
    for i in range(query.shape[0]):
        d = sqdist(query[i : i + 1], support[i : i + 1])
        d, idx = torch.sort(d, dim=-1, stable=True)
        ds.append(d[..., :k])
        ids.append(idx[..., :k])
    return torch.cat(ds), torch.cat(ids)


def nearest(p: torch.Tensor, q: torch.Tensor, rows: int = 4096):
    """Index [B,N] long of each p point's nearest q point, ties to the
    lowest index; in blocks of ``rows`` query points."""
    b, n, _ = p.shape
    m = q.shape[1]
    iota = torch.arange(m, device=p.device)
    out = torch.empty((b, n), dtype=torch.long, device=p.device)
    for i in range(b):
        for s in range(0, n, rows):
            d = sqdist(p[i : i + 1, s : s + rows], q[i : i + 1])[0]
            mn = d.amin(dim=1, keepdim=True)
            out[i, s : s + rows] = torch.where(d == mn, iota, m).amin(dim=1)
    return out


def matched_sqdist(p: torch.Tensor, q: torch.Tensor, idx: torch.Tensor):
    """[B,N] squared distances from p to q's rows at idx (differentiable in
    both clouds)."""
    diff = p - gather_rows(q, idx)
    dx, dy, dz = diff.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def chamfer(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Mean squared nearest distance each way, the two summed, averaged
    over the batch."""
    with torch.no_grad():
        i1 = nearest(p.detach(), q.detach())
        i2 = nearest(q.detach(), p.detach())
    d1 = matched_sqdist(p, q, i1)
    d2 = matched_sqdist(q, p, i2)
    return (d1.mean(dim=-1) + d2.mean(dim=-1)).mean()


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8):
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(dim=-1, keepdim=True)


def three_interpolate(features, idx, weight):
    return (gather_rows(features, idx) * weight[..., None]).sum(dim=2)
