"""Row gather (kernel K3).

CUDA kernel: ``csrc/gather.cu``, which replaces both TPU kernels,
``pytorch_points_tpu/kernels/gather.py::_gather_kernel_t`` (``gather_rows_t``)
and ``::_gather_kernel`` (``gather_rows``, the older layout). The two
compute the same function, out[b,k,:] = f[b,idx[b,k],:] as [B,K,C], and
differ only in their layout inside the TPU kernel, so one CUDA kernel serves
both names. It has two instances: float32 rows, and bfloat16 rows for the
mixed-precision feature paths (``dtype=torch.bfloat16``), which the
reference gathers exactly with XLA's ``take_along_axis``; a gather is a
copy, so both are bitwise equal to the plain version. The header note there
says what bounds it on the card. A call is one launch; its host path is
``_build``'s (the argument checks, ``torch.empty``, the raw stream handle
and the ctypes call).
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.kernels import _build, dispatch

_ppt_gather_rows = _build.entry("ppt_gather_rows")
_ppt_gather_rows_bf16 = _build.entry("ppt_gather_rows_bf16")


def gather_rows_torch(features: torch.Tensor, idx: torch.Tensor):
    """Plain version: [B,N,C], [B,K] -> [B,K,C], out[b,k] = f[b,idx[b,k]]."""
    b, k = idx.shape
    return features.gather(
        1, idx.long()[..., None].expand(b, k, features.shape[-1])
    )


def _launch(entry, features: torch.Tensor, idx: torch.Tensor, dtype):
    b, n, c = features.shape
    k = idx.shape[1]
    _build.require(features, "gather features", dtype, (b, n, c))
    _build.require(idx, "gather idx", torch.int32, (b, k))
    out = torch.empty((b, k, c), dtype=dtype, device=features.device)
    err = entry(features.data_ptr(), idx.data_ptr(), b, n, k, c,
                out.data_ptr(), _build.stream(features))
    _build.check(err, entry.name)
    return out


def gather_rows_bf16_cuda(features: torch.Tensor, idx: torch.Tensor):
    """Launch the kernel's bfloat16 instance: same contract as
    :func:`gather_rows_torch` for bfloat16 features, bitwise. Indices must
    lie in [0, N)."""
    out = _launch(_ppt_gather_rows_bf16, features, idx, torch.bfloat16)
    gather_rows_bf16_cuda.launches += 1
    return out


def gather_rows_cuda(features: torch.Tensor, idx: torch.Tensor):
    """Launch the CUDA kernel: same contract as :func:`gather_rows_torch`
    for float32 features; bfloat16 features go to
    :func:`gather_rows_bf16_cuda`, and any other dtype raises. Indices must
    lie in [0, N)."""
    if features.dtype == torch.bfloat16:
        return gather_rows_bf16_cuda(features, idx)
    out = _launch(_ppt_gather_rows, features, idx, torch.float32)
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0
gather_rows_bf16_cuda.launches = 0


@torch.library.custom_op("ppt::gather_rows", mutates_args=())
def _gather_rows_op(features: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """K3 as one op for a traced program (kernels.dispatch.traced)."""
    if features.is_cuda:
        return gather_rows_cuda(features, idx)
    return gather_rows_torch(features, idx)


@_gather_rows_op.register_fake
def _(features, idx):
    return features.new_empty((*idx.shape, features.shape[-1]))


def gather_rows(features: torch.Tensor, idx: torch.Tensor, tk: int = 2048,
                impl: str = "auto"):
    """[B,N,C] features, [B,K] indices -> [B,K,C], exact.

    ``tk`` is the reference's tile of rows; the result does not depend on
    it, so it is accepted and changes nothing."""
    del tk  # every tiling gives the same rows
    route = dispatch.resolve(impl, features, "gather")
    if dispatch.traced(impl):
        return _gather_rows_op(features.contiguous(), _build.int32(idx))
    if route == "cuda":
        return gather_rows_cuda(features.contiguous(), _build.int32(idx))
    return gather_rows_torch(features, idx)


# The reference's lane-major twin computes the same [B,K,C] result.
gather_rows_t = gather_rows
