"""Deterministic row scatter-add (kernel K4), the backward of every gather.

CUDA kernel: ``csrc/scatter.cu``, which replaces both TPU forms,
``pytorch_points_tpu/kernels/scatter.py::_scatter_kernel_t``
(``scatter_add_csum_t``) and ``::_scatter_kernel`` (``scatter_add_csum``).
Two launches a call and no torch glue: the first builds each cloud's run
table on the card (a stable radix sort of the target rows by a cluster of
blocks per cloud), the second sums each row's run in ascending k. The header
note there says what bounds it.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.kernels import _build, dispatch

_ppt_scatter_add = _build.entry("ppt_scatter_add")


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
    out = torch.empty((b, n, c), dtype=torch.float32, device=idx.device)
    scratch = torch.empty(4 * b * k + b * (n + 1), dtype=torch.int32,
                          device=idx.device)
    err = _ppt_scatter_add(idx.data_ptr(), updates.data_ptr(), b, k, n, c,
                           scratch.data_ptr(), out.data_ptr(),
                           _build.stream(idx))
    _build.check(err, "ppt_scatter_add")
    scatter_add_cuda.launches += 1
    return out


scatter_add_cuda.launches = 0


def scatter_add(idx: torch.Tensor, updates: torch.Tensor, n: int,
                impl: str = "auto"):
    """idx [B,K] int, updates [B,K,C] f32 -> [B,n,C]: each row the sum of
    its updates in ascending k; indices outside [0, n) are dropped."""
    if dispatch.resolve(impl, updates, "scatter") == "cuda":
        return scatter_add_cuda(_build.int32(idx), updates.contiguous(), n)
    return scatter_add_torch(idx, updates, n)


def scatter_add_csum(idx: torch.Tensor, updates: torch.Tensor, n: int,
                     tk: int = 2048, impl: str = "auto"):
    """The reference's name for the deterministic scatter-add:
    out[b, idx[b,k], :] += updates[b,k,:], idx [B,K] int, updates [B,K,C]
    f32 -> [B,n,C] (:func:`scatter_add`, kernel K4). ``tk`` is the
    reference's tile of updates; the sums do not depend on it here (each
    row sums in ascending k), so it is accepted and changes nothing."""
    del tk  # every tiling gives the same sums
    return scatter_add(idx, updates, n, impl=impl)


def scatter_add_csum_t(idx: torch.Tensor, updates: torch.Tensor, n: int,
                       tk: int = 2048, parts: int = 2, impl: str = "auto"):
    """The reference's lane-major twin of :func:`scatter_add_csum`, the same
    function. ``parts`` sets how many bf16 parts the reference's MXU form
    splits each update into (2: about 2^-16 relative, 3: f32-exact); K4
    adds f32 updates exactly in ascending k, which is at least as accurate
    as either, so ``parts`` and ``tk`` are accepted and change nothing."""
    del tk, parts  # K4's f32 sums are exact to one rounding an add
    return scatter_add(idx, updates, n, impl=impl)
