"""Dense nearest neighbour, both directions (kernel K5) or one (K13).

CUDA kernel: ``csrc/nn_dense.cu``, which replaces the TPU kernels
``pytorch_points_tpu/kernels/distance_tiles.py::_nn_both_kernel``
(``nn_both_directions``) and ``::_nn_kernel`` (``nn_one_direction``). The
header note there says what bounds it on the card.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.kernels import _build, dispatch

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


def nn_one_direction_cuda(p: torch.Tensor, q: torch.Tensor):
    """Launch the CUDA kernel: same contract as
    :func:`nn_one_direction_torch`."""
    b, n, _ = p.shape
    m = q.shape[1]
    _build.require(p, "nn_dense p", torch.float32, (b, n, 3))
    _build.require(q, "nn_dense q", torch.float32, (b, m, 3))
    dist = torch.empty((b, n), dtype=torch.float32, device=p.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=p.device)
    err = _build.library().ppt_nn_dense(
        p.data_ptr(), q.data_ptr(), b, n, m, dist.data_ptr(), idx.data_ptr(),
        _build.stream(p),
    )
    _build.check(err, "ppt_nn_dense")
    nn_one_direction_cuda.launches += 1
    return dist, idx


nn_one_direction_cuda.launches = 0


def nn_one_direction(p: torch.Tensor, q: torch.Tensor, impl: str = "auto"):
    """For each p point, (min squared distance over q, argmin index):
    [B,N,3], [B,M,3] -> (dist [B,N] f32, idx [B,N] int32), lowest-index
    ties. Masked points arrive poisoned (``ops.chamfer.nndistance``)."""
    if q.shape[1] < 1:
        raise ValueError("nn_one_direction needs a non-empty q cloud")
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    if dispatch.resolve(impl, p, "nn_dense") == "cuda":
        return nn_one_direction_cuda(p.contiguous(), q.contiguous())
    return nn_one_direction_torch(p, q)


def nn_both_directions(p: torch.Tensor, q: torch.Tensor, impl: str = "auto"):
    """Bidirectional NN: (dist1 [B,N], idx1, dist2 [B,M], idx2), the
    reference nmdistance contract. Two one-direction passes (p -> q,
    q -> p) in place of the TPU's fused tile reduction."""
    return (*nn_one_direction(p, q, impl), *nn_one_direction(q, p, impl))
