"""Deterministic row scatter-add (kernel K4), the backward of every gather.

CUDA kernel: ``csrc/scatter.cu``, which replaces both TPU forms,
``pytorch_points_tpu/kernels/scatter.py::_scatter_kernel_t``
(``scatter_add_csum_t``) and ``::_scatter_kernel`` (``scatter_add_csum``).
The header note there says what bounds it on the card.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.kernels import _build, dispatch


def _row_keys(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[B,K] row indices -> [B*K] flat output rows b*n + idx; an index out
    of [0, n) maps to row B*n, which no output holds (the TPU kernel drops
    it the same way: its one-hot matches no output row)."""
    b = idx.shape[0]
    idx = idx.long()
    base = torch.arange(b, device=idx.device)[:, None] * n
    inside = (idx >= 0) & (idx < n)
    return torch.where(inside, base + idx, b * n).reshape(-1)


def scatter_add_torch(idx: torch.Tensor, updates: torch.Tensor, n: int):
    """Plain version: out[b, idx[b,k], :] += updates[b,k,:], out [B,n,C] of
    zeros. On a CPU tensor ``index_add_`` adds in ascending k, as the
    kernel does; on a CUDA tensor it uses atomics, so sums may round in
    another order."""
    b, k, c = updates.shape
    out = updates.new_zeros((b * n + 1, c))
    out.index_add_(0, _row_keys(idx, n), updates.reshape(b * k, c))
    return out[: b * n].reshape(b, n, c)


def scatter_add_cuda(idx: torch.Tensor, updates: torch.Tensor, n: int):
    """Launch the CUDA kernel: same contract as :func:`scatter_add_torch`
    for float32 updates, summed in ascending k in every run."""
    b, k, c = updates.shape
    _build.require(idx, "scatter idx", torch.int32, (b, k))
    _build.require(updates, "scatter updates", torch.float32, (b, k, c))
    if b * k >= 2**31 or b * n >= 2**31:
        raise ValueError(f"scatter: B*K={b * k} and B*n={b * n} must be "
                         "below 2^31")
    keys = _row_keys(idx, n)
    order = torch.sort(keys, stable=True).indices.to(torch.int32)
    counts = torch.bincount(keys, minlength=b * n + 1)[: b * n]
    offsets = torch.zeros(b * n + 1, dtype=torch.int32, device=idx.device)
    offsets[1:] = counts.cumsum(0)
    out = torch.empty((b, n, c), dtype=torch.float32, device=idx.device)
    err = _build.library().ppt_scatter_rows(
        updates.data_ptr(), order.data_ptr(), offsets.data_ptr(), b * n, c,
        out.data_ptr(), _build.stream(updates),
    )
    _build.check(err, "ppt_scatter_rows")
    scatter_add_cuda.launches += 1
    return out


scatter_add_cuda.launches = 0


def scatter_add(idx: torch.Tensor, updates: torch.Tensor, n: int,
                impl: str = "auto"):
    """idx [B,K] int, updates [B,K,C] f32 -> [B,n,C]: each row the sum of
    its updates in ascending k; indices outside [0, n) are dropped."""
    if dispatch.resolve(impl, updates, "scatter") == "cuda":
        return scatter_add_cuda(idx.to(torch.int32).contiguous(),
                                updates.contiguous(), n)
    return scatter_add_torch(idx, updates, n)
