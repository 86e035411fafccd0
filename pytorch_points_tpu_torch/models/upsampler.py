"""3PU-style point-cloud upsampler (counterpart of the JAX
``models/upsampler.py``).

DenseEdgeConv features on the input's coordinate kNN graph, point-shuffle
expansion by ``ratio`` (each point spawns ``ratio`` children, each with its
own grid code), a residual coordinate head.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pytorch_points_tpu_torch.layers import DenseEdgeConv, SharedMLP
from pytorch_points_tpu_torch.layers.blocks import _linear


def grid_codes(ratio: int, device=None) -> torch.Tensor:
    """[ratio, 2] float32: (cos, sin) of 2 pi j / ratio, computed in float32
    as the reference computes them; they tell a parent's children apart."""
    a = 2 * math.pi * torch.arange(ratio, dtype=torch.float32,
                                   device=device) / ratio
    return torch.stack([torch.cos(a), torch.sin(a)], dim=-1)


def child_features(f: torch.Tensor, ratio: int) -> torch.Tensor:
    """[B,N,C] -> [B,N*ratio,C+2]: row i*ratio + j is parent i's features
    with grid code j (``jnp.repeat`` of the features, ``jnp.tile`` of the
    codes)."""
    b, n, _ = f.shape
    codes = grid_codes(ratio, f.device).to(f.dtype).repeat(n, 1)
    return torch.cat([f.repeat_interleave(ratio, dim=1),
                      codes[None].expand(b, -1, -1)], dim=-1)


class PointUpsampler(nn.Module):
    """3PU-style upsampler: [B,N,3] -> [B,N*ratio,3].

    Modules ``lift``, ``edge1``, ``edge2``, ``expand`` and ``head``, named
    as in the JAX model so ``compat.load_jax_params`` maps them. Weights are
    drawn from ``generator`` (seed 0 when None) on the CPU, then moved to
    ``device``, the card unless the caller names another device.

    dtype: the computation dtype of every layer (None: float32; the bf16
    policy, ``core/dtypes.py``); parameters stay float32, and the residual
    add promotes the offsets back to the coordinates' float32, so the loss
    kernels see float32.
    """

    def __init__(self, ratio: int = 4, channels: int = 24,
                 growth_rate: int = 24, dense_n: int = 3, k: int = 16, *,
                 dtype: torch.dtype | None = None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.ratio = ratio
        self.lift = _linear(3, channels, generator, dtype)
        self.edge1 = DenseEdgeConv(channels, growth_rate, dense_n, k, **kw)
        c1 = channels + dense_n * growth_rate
        self.edge2 = DenseEdgeConv(c1, growth_rate, dense_n, k, **kw)
        c2 = c1 + dense_n * growth_rate
        self.expand = SharedMLP([c2 + 2, 128, 128], **kw)
        self.head = SharedMLP([128, 64, 3], act_last=False, **kw)
        self.to(device)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
        """[B,N,3] (+ [B,N] bool mask for the kNN graphs) -> [B,N*ratio,3].
        ``impl`` selects the kernels' route (kernels.dispatch)."""
        f = self.lift(xyz)
        f = self.edge1(f, xyz=xyz, mask=mask, impl=impl)
        f = self.edge2(f, xyz=xyz, mask=mask, impl=impl)
        offsets = self.head(self.expand(child_features(f, self.ratio)))
        return xyz.repeat_interleave(self.ratio, dim=1) + offsets
