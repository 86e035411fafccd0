"""Ball query (kernel K2).

CUDA kernel: ``csrc/ballquery.cu``, which replaces both TPU forms,
``pytorch_points_tpu/kernels/ballquery.py::_bq_while_kernel`` and
``::_bq_kernel`` (bitwise equal to each other). The header note there says
what bounds it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_points_tpu_torch.core.masking import poison_points
from pytorch_points_tpu_torch.kernels import _build, dispatch


def squared_radius(radius: float) -> float:
    """r^2 squared in double and rounded once to float32, as the Pallas
    path does (the JAX XLA fallback squares in float32 instead)."""
    return float(np.float32(float(radius) ** 2))


def ball_query_torch(xyz: torch.Tensor, centroids: torch.Tensor,
                     radius: float, nsample: int):
    """Plain version on an already-poisoned support.

    [B,N,3] support, [B,P,3] centroids -> (idx [B,P,nsample] int32,
    cnt [B,P] int32): the first ``nsample`` hits (d^2 < r^2, diff^2 form)
    in index order, padded with the first hit; zero-hit rows are all 0.
    Runs one cloud at a time above 2^26 (centroid, point) pairs, so it fits
    the headline's B=32 P=2048 N=16384 on the card.
    """
    b, p, n = xyz.shape[0], centroids.shape[1], xyz.shape[1]
    if b > 1 and b * p * n > 1 << 26:
        outs = [ball_query_torch(xyz[i : i + 1], centroids[i : i + 1],
                                 radius, nsample) for i in range(b)]
        return tuple(torch.cat(t) for t in zip(*outs))
    dx, dy, dz = (centroids[:, :, None, c] - xyz[:, None, :, c]
                  for c in range(3))
    hit = ((dx * dx + dy * dy) + dz * dz) < squared_radius(radius)
    iota = torch.arange(n, dtype=torch.int32, device=xyz.device)
    key = torch.where(hit, iota, n)
    if nsample > n:
        key = torch.nn.functional.pad(key, (0, nsample - n), value=n)
    first_hits = torch.topk(key, nsample, dim=-1, largest=False).values
    first = first_hits[..., :1]
    first = torch.where(first == n, 0, first)
    idx = torch.where(first_hits == n, first, first_hits)
    cnt = hit.sum(dim=-1).clamp(max=nsample)
    return idx.to(torch.int32), cnt.to(torch.int32)


def ball_query_cuda(xyz: torch.Tensor, centroids: torch.Tensor,
                    radius: float, nsample: int):
    """Launch the CUDA kernel: same contract as :func:`ball_query_torch`."""
    b, n, _ = xyz.shape
    p = centroids.shape[1]
    _build.require(xyz, "ball_query xyz", torch.float32, (b, n, 3))
    _build.require(centroids, "ball_query centroids", torch.float32,
                   (b, p, 3))
    if n < 1 or nsample < 1:
        raise ValueError(f"ball_query needs N >= 1 and nsample >= 1, got "
                         f"N={n} nsample={nsample}")
    idx = torch.empty((b, p, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, p), dtype=torch.int32, device=xyz.device)
    err = _build.library().ppt_ball_query(
        xyz.data_ptr(), centroids.data_ptr(), b, n, p, nsample,
        squared_radius(radius), idx.data_ptr(), cnt.data_ptr(),
        _build.stream(xyz),
    )
    _build.check(err, "ppt_ball_query")
    ball_query_cuda.launches += 1
    return idx, cnt


ball_query_cuda.launches = 0


def ball_query(xyz: torch.Tensor, centroids: torch.Tensor, radius: float,
               nsample: int, mask: torch.Tensor | None = None,
               impl: str = "auto"):
    """[B,N,3] support, [B,P,3] centroids -> (idx [B,P,nsample], cnt [B,P]).

    ``mask`` ([B,N] bool) marks valid support points; invalid ones are
    poisoned far away (sign -1) before the scan, as the reference does.
    """
    xyz = poison_points(xyz.to(torch.float32), mask, sign=-1.0)
    centroids = centroids.to(torch.float32)
    if dispatch.resolve(impl, xyz, "ball_query") == "cuda":
        return ball_query_cuda(xyz.contiguous(), centroids.contiguous(),
                               radius, nsample)
    return ball_query_torch(xyz, centroids, radius, nsample)
