"""Shared scatter-add for every autograd backward (counterpart of the JAX
``ops/scatter_impl.py``).

Every backward of a gather funnels through this one primitive: the
deterministic row scatter (kernel K4, ``kernels/scatter.py``) for every
CUDA tensor, its plain version for a CPU tensor. The JAX package's
one-hot and size thresholds are TPU tuning and have no counterpart.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.kernels.scatter import scatter_add


def scatter_add_auto(idx: torch.Tensor, updates: torch.Tensor, n: int,
                     impl: str = "auto") -> torch.Tensor:
    """out[b, idx[b,k], c] += updates[b,k,c]; out is [B, n, C] of zeros,
    in the updates' dtype (summed in float32).

    Extra leading batch dims are flattened in and restored."""
    if idx.ndim > 2:
        lead = idx.shape[:-1]
        out = scatter_add_auto(
            idx.reshape(-1, idx.shape[-1]),
            updates.reshape(-1, updates.shape[-2], updates.shape[-1]),
            n, impl,
        )
        return out.reshape(*lead, n, updates.shape[-1])
    out = scatter_add(idx, updates.to(torch.float32), n, impl)
    return out.to(updates.dtype)
