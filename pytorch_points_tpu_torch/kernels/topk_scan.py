"""Exact k nearest neighbours (kernel K8).

CUDA kernel: ``csrc/knn.cu``, which replaces the TPU kernel
``pytorch_points_tpu/kernels/topk_scan.py::_knn_kernel`` (the streaming
scan). The header note there says what bounds it on the card. The
reference's Morton-ring kernels for Ns >= 8192 are not ported yet.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.kernels import _build, dispatch

MAX_K = 64


def knn_torch(query: torch.Tensor, support: torch.Tensor, k: int):
    """Plain version: [B,Nq,3], [B,Ns,3] -> (d [B,Nq,k] ascending, idx int32).

    d in the diff^2 form; a stable sort keeps the lowest index first among
    equal distances.
    """
    dx, dy, dz = (query[:, :, None, c] - support[:, None, :, c]
                  for c in range(3))
    d = (dx * dx + dy * dy) + dz * dz
    d, idx = torch.sort(d, dim=-1, stable=True)
    return d[..., :k], idx[..., :k].to(torch.int32)


def knn_cuda(query: torch.Tensor, support: torch.Tensor, k: int):
    """Launch the CUDA kernel: same contract as :func:`knn_torch`, k <= 64."""
    b, nq, _ = query.shape
    ns = support.shape[1]
    _build.require(query, "knn query", torch.float32, (b, nq, 3))
    _build.require(support, "knn support", torch.float32, (b, ns, 3))
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn kernel supports 1 <= k <= {MAX_K}, got {k}")
    d = torch.empty((b, nq, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=query.device)
    err = _build.library().ppt_knn(
        query.data_ptr(), support.data_ptr(), b, nq, ns, k, d.data_ptr(),
        idx.data_ptr(), _build.stream(query),
    )
    _build.check(err, "ppt_knn")
    knn_cuda.launches += 1
    return d, idx


knn_cuda.launches = 0


def knn(query: torch.Tensor, support: torch.Tensor, k: int,
        impl: str = "auto"):
    """[B,Nq,3], [B,Ns,3] -> (dist [B,Nq,k] squared ascending, idx int32).

    Exact, lowest-index ties. Masked supports arrive poisoned
    (``ops.grouping.knn``).
    """
    if k > support.shape[1]:
        raise ValueError(f"k={k} > support size {support.shape[1]}")
    query = query.to(torch.float32)
    support = support.to(torch.float32)
    if dispatch.resolve(impl, query, "knn") == "cuda":
        return knn_cuda(query.contiguous(), support.contiguous(), k)
    return knn_torch(query, support, k)
