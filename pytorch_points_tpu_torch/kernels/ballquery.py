"""Ball query (kernel K2), and the ball query that also emits the centred
grouped coordinates.

CUDA kernel: ``csrc/ballquery.cu``, which replaces both TPU forms,
``pytorch_points_tpu/kernels/ballquery.py::_bq_while_kernel`` and
``::_bq_kernel`` (bitwise equal to each other), run with
``with_coords=False`` (:func:`ball_query`) and ``with_coords=True``
(:func:`ball_query_and_group_coords`, the template instance
``WITH_COORDS``). The header note there says what bounds it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_points_tpu_torch.core.masking import poison_points
from pytorch_points_tpu_torch.kernels import _build, dispatch

_ppt_ball_query = _build.entry("ppt_ball_query")
_ppt_ball_query_coords = _build.entry("ppt_ball_query_coords")

# Support points a warp of the kernel tests in one step (csrc/ballquery.cu
# kStep): the grain of its work counter and of its packed support.
SCAN_STEP = 128


def squared_radius(radius: float) -> float:
    """r^2 squared in double and rounded once to float32, as the Pallas
    path does (the JAX XLA fallback squares in float32 instead)."""
    return float(np.float32(float(radius) ** 2))


def ball_query_torch(xyz: torch.Tensor, centroids: torch.Tensor,
                     radius: float, nsample: int,
                     counts: torch.Tensor | None = None):
    """Plain version on an already-poisoned support.

    [B,N,3] support, [B,P,3] centroids -> (idx [B,P,nsample] int32,
    cnt [B,P] int32): the first ``nsample`` hits (d^2 < r^2, diff^2 form)
    in index order, padded with the first hit; zero-hit rows are all 0.
    ``counts`` ([B,P] int32) receives the support points the kernel's scan
    tests for each centroid (:func:`scan_counts`). Runs one cloud at a time
    above 2^26 (centroid, point) pairs, so it fits the headline's B=32
    P=2048 N=16384 on the card.
    """
    b, p, n = xyz.shape[0], centroids.shape[1], xyz.shape[1]
    if b > 1 and b * p * n > 1 << 26:
        outs = [ball_query_torch(
            xyz[i : i + 1], centroids[i : i + 1], radius, nsample,
            None if counts is None else counts[i : i + 1]) for i in range(b)]
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
    if counts is not None:
        counts.copy_(scan_counts(hit, nsample))
    return idx.to(torch.int32), cnt.to(torch.int32)


def scan_counts(hit: torch.Tensor, nsample: int) -> torch.Tensor:
    """The kernel's work counter from the hits [B,P,N] bool: the support
    points each centroid's scan tests, in whole steps of :data:`SCAN_STEP`
    up to the step that holds its ``nsample``-th hit, capped at N (all N
    when it has fewer hits). [B,P] int32."""
    n = hit.shape[-1]
    before = (hit.cumsum(dim=-1) < nsample).sum(dim=-1)  # N if never full
    return ((before // SCAN_STEP + 1) * SCAN_STEP).clamp(max=n).to(
        torch.int32)


def _launch_args(xyz, centroids, nsample, counts, name):
    """Check the kernel's arguments; return (B, N, P) and the scratch the
    kernel packs the support into (step-major: for each step of SCAN_STEP
    points their x, y and z rows, and one step more than N needs)."""
    b, n, _ = xyz.shape
    p = centroids.shape[1]
    _build.require(xyz, f"{name} xyz", torch.float32, (b, n, 3))
    _build.require(centroids, f"{name} centroids", torch.float32, (b, p, 3))
    if counts is not None:
        _build.require(counts, f"{name} counts", torch.int32, (b, p))
    if n < 1 or nsample < 1:
        raise ValueError(f"{name} needs N >= 1 and nsample >= 1, got N={n} "
                         f"nsample={nsample}")
    steps = -(-n // SCAN_STEP) + 1
    scratch = torch.empty(3 * b * steps * SCAN_STEP, dtype=torch.float32,
                          device=xyz.device)
    return b, n, p, scratch


def ball_query_cuda(xyz: torch.Tensor, centroids: torch.Tensor,
                    radius: float, nsample: int,
                    counts: torch.Tensor | None = None):
    """Launch the CUDA kernel: same contract as :func:`ball_query_torch`."""
    b, n, p, scratch = _launch_args(xyz, centroids, nsample, counts,
                                   "ball_query")
    idx = torch.empty((b, p, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, p), dtype=torch.int32, device=xyz.device)
    err = _ppt_ball_query(
        xyz.data_ptr(), centroids.data_ptr(), b, n, p, nsample,
        squared_radius(radius), scratch.data_ptr(), idx.data_ptr(),
        cnt.data_ptr(), _build.ptr(counts), _build.stream(xyz),
    )
    _build.check(err, "ppt_ball_query")
    ball_query_cuda.launches += 1
    return idx, cnt


ball_query_cuda.launches = 0


@torch.library.custom_op("ppt::ball_query", mutates_args=())
def _ball_query_op(xyz: torch.Tensor, centroids: torch.Tensor, radius: float,
                   nsample: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 as one op for a traced program (kernels.dispatch.traced)."""
    if xyz.is_cuda:
        return ball_query_cuda(xyz, centroids, radius, nsample)
    return ball_query_torch(xyz, centroids, radius, nsample)


@_ball_query_op.register_fake
def _(xyz, centroids, radius, nsample):
    b, p = centroids.shape[:2]
    return (xyz.new_empty((b, p, nsample), dtype=torch.int32),
            xyz.new_empty((b, p), dtype=torch.int32))


def ball_query(xyz: torch.Tensor, centroids: torch.Tensor, radius: float,
               nsample: int, mask: torch.Tensor | None = None,
               tp: int | None = None, tm: int | None = None,
               counts: torch.Tensor | None = None, impl: str = "auto"):
    """[B,N,3] support, [B,P,3] centroids -> (idx [B,P,nsample], cnt [B,P]).

    ``mask`` ([B,N] bool) marks valid support points; invalid ones are
    poisoned far away (sign -1) before the scan, as the reference does.
    ``tp`` and ``tm`` choose the reference's grid or resident form and its
    tiles; the forms are bitwise equal, and the one CUDA kernel gives those
    bits for any of them, so they are accepted and change nothing.
    ``counts`` ([B,P] int32) receives the kernel's work counter
    (:func:`scan_counts`).
    """
    del tp, tm  # every form and tiling gives the same bits
    xyz = poison_points(xyz.to(torch.float32), mask, sign=-1.0)
    centroids = centroids.to(torch.float32)
    route = dispatch.resolve(impl, xyz, "ball_query")
    if dispatch.traced(impl) and counts is None:
        return _ball_query_op(xyz.contiguous(), centroids.contiguous(),
                              radius, nsample)
    if route == "cuda":
        return ball_query_cuda(xyz.contiguous(), centroids.contiguous(),
                               radius, nsample, counts)
    return ball_query_torch(xyz, centroids, radius, nsample, counts)


def ball_query_coords_torch(xyz: torch.Tensor, centroids: torch.Tensor,
                            radius: float, nsample: int, p0: torch.Tensor,
                            counts: torch.Tensor | None = None):
    """Plain version of the coordinate-emitting query on an
    already-poisoned support, given each cloud's unpoisoned point 0 ``p0``
    [B,3]: (idx, cnt) and ``counts`` as :func:`ball_query_torch`, and g
    [B,P,nsample,3] = xyz[idx] - centroid, one rounding. Slots past cnt
    repeat the first hit's; a zero-hit row gets p0 - centroid."""
    idx, cnt = ball_query_torch(xyz, centroids, radius, nsample, counts)
    b, p, ns = idx.shape
    hit = xyz.gather(1, idx.long().reshape(b, p * ns, 1).expand(-1, -1, 3))
    g = torch.where((cnt == 0)[..., None, None], p0[:, None, None, :],
                    hit.reshape(b, p, ns, 3)) - centroids[:, :, None, :]
    return idx, cnt, g


def ball_query_coords_cuda(xyz: torch.Tensor, centroids: torch.Tensor,
                           radius: float, nsample: int, p0: torch.Tensor,
                           counts: torch.Tensor | None = None):
    """Launch the CUDA kernel's ``WITH_COORDS`` instance: same contract as
    :func:`ball_query_coords_torch`."""
    b, n, p, scratch = _launch_args(xyz, centroids, nsample, counts,
                                   "ball_query_coords")
    _build.require(p0, "ball_query_coords p0", torch.float32, (b, 3))
    idx = torch.empty((b, p, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, p), dtype=torch.int32, device=xyz.device)
    g = torch.empty((b, p, nsample, 3), dtype=torch.float32,
                    device=xyz.device)
    err = _ppt_ball_query_coords(
        xyz.data_ptr(), centroids.data_ptr(), p0.data_ptr(), b, n, p,
        nsample, squared_radius(radius), scratch.data_ptr(), idx.data_ptr(),
        cnt.data_ptr(), g.data_ptr(), _build.ptr(counts), _build.stream(xyz),
    )
    _build.check(err, "ppt_ball_query_coords")
    ball_query_coords_cuda.launches += 1
    return idx, cnt, g


ball_query_coords_cuda.launches = 0


@torch.library.custom_op("ppt::ball_query_coords", mutates_args=())
def _ball_query_coords_op(xyz: torch.Tensor, centroids: torch.Tensor,
                          radius: float, nsample: int, p0: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K2's coordinate instance as one op for a traced program
    (kernels.dispatch.traced)."""
    if xyz.is_cuda:
        return ball_query_coords_cuda(xyz, centroids, radius, nsample, p0)
    return ball_query_coords_torch(xyz, centroids, radius, nsample, p0)


@_ball_query_coords_op.register_fake
def _(xyz, centroids, radius, nsample, p0):
    b, p = centroids.shape[:2]
    return (xyz.new_empty((b, p, nsample), dtype=torch.int32),
            xyz.new_empty((b, p), dtype=torch.int32),
            xyz.new_empty((b, p, nsample, 3)))


def ball_query_and_group_coords(xyz: torch.Tensor, centroids: torch.Tensor,
                                radius: float, nsample: int,
                                mask: torch.Tensor | None = None,
                                tp: int | None = None, tm: int | None = None,
                                counts: torch.Tensor | None = None,
                                impl: str = "auto"):
    """Fused SA front half: ball query and the CENTRED grouped coordinates.

    [B,N,3] support, [B,P,3] centres -> (idx [B,P,nsample] int32, cnt [B,P]
    int32, g [B,P,nsample,3] f32 = xyz[idx] - centroid, rounded once), the
    coordinates emitted by the scan with no separate gather. Slots at or
    beyond cnt repeat the first hit's coordinates; a zero-hit row gets
    xyz[b, 0] - centroid from the UNPOISONED cloud, even where point 0 is
    masked out, as the reference fills it. ``mask`` ([B,N] bool) marks
    valid support points (poisoned, sign -1, before the scan).
    ``counts`` ([B,P] int32) receives the kernel's work counter
    (:func:`scan_counts`).

    ``tp`` and ``tm`` choose the reference's grid or resident form and its
    tiles; the forms are bitwise equal, and the one CUDA kernel gives those
    bits for any of them, so they are accepted and change nothing. The
    outputs are detached: use ``group_points`` on ``idx``, or
    ``ops.grouping._bq_group_centered``, for gradients.
    """
    del tp, tm  # every form and tiling gives the same bits
    raw = xyz.detach().to(torch.float32)
    centroids = centroids.detach().to(torch.float32).contiguous()
    sup = poison_points(raw, mask, sign=-1.0)
    p0 = raw[:, 0, :].contiguous()
    route = dispatch.resolve(impl, sup, "ball_query_coords")
    if dispatch.traced(impl) and counts is None:
        return _ball_query_coords_op(sup.contiguous(), centroids, radius,
                                     nsample, p0)
    if route == "cuda":
        return ball_query_coords_cuda(sup.contiguous(), centroids, radius,
                                      nsample, p0, counts)
    return ball_query_coords_torch(sup, centroids, radius, nsample, p0,
                                   counts)
