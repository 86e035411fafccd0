"""PointNet++ models (counterpart of the JAX ``models/pointnet2.py``).

``PointCloudAutoencoder`` is the flagship: FPS + grouping through SA layers
down to a global code, FP layers (three_nn + three_interpolate) back up, and
a coordinate head. It serves (forward) and trains: every op on its path is
a ``torch.autograd.Function`` with the reference's backward rule
(``parallel/data_parallel.py`` builds the train step).
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_points_tpu_torch.layers import (
    PointNetFPModule,
    PointNetSAModule,
    SharedMLP,
)


class PointNet2Encoder(nn.Module):
    """3-level SA hierarchy -> per-level features + global code."""

    def __init__(self, npoint1: int = 512, npoint2: int = 128,
                 radius1: float = 0.2, radius2: float = 0.4,
                 nsample: int = 32, *, norm: str | None = "layer",
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(norm=norm, device=device, generator=generator)
        self.sa1 = PointNetSAModule(0, [64, 64, 128], npoint=npoint1,
                                    radius=radius1, nsample=nsample, **kw)
        self.sa2 = PointNetSAModule(128, [128, 128, 256], npoint=npoint2,
                                    radius=radius2, nsample=nsample, **kw)
        self.sa3 = PointNetSAModule(256, [256, 512, 1024], group_all=True,
                                    **kw)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                impl: str = "auto"):
        xyz1, f1 = self.sa1(xyz, None, mask, impl=impl)
        xyz2, f2 = self.sa2(xyz1, f1, impl=impl)
        xyz3, f3 = self.sa3(xyz2, f2, impl=impl)
        return (xyz, xyz1, xyz2, xyz3), (None, f1, f2, f3)


class PointCloudAutoencoder(nn.Module):
    """SA encoder -> FP decoder -> per-point coordinate head.

    Reconstructs the input cloud as ``xyz + offsets``. Weights are drawn
    from ``generator`` (seed 0 when None) on the CPU, then moved to
    ``device``; ``compat.load_jax_params`` loads the JAX model's instead.
    """

    def __init__(self, npoint1: int = 512, npoint2: int = 128, *,
                 norm: str | None = "layer", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(norm=norm, device=device, generator=generator)
        self.encoder = PointNet2Encoder(npoint1, npoint2, **kw)
        self.fp3 = PointNetFPModule(1024 + 256, [256, 256], **kw)
        self.fp2 = PointNetFPModule(256 + 128, [256, 128], **kw)
        self.fp1 = PointNetFPModule(128, [128, 128], **kw)
        self.head = SharedMLP([128, 64, 3], act_last=False, **kw)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
        """[B,N,3] (+ [B,N] bool mask) -> reconstruction [B,N,3]; masked
        rows are 0. ``impl`` selects the kernels' route (kernels.dispatch)."""
        (x0, x1, x2, x3), (_, f1, f2, f3) = self.encoder(xyz, mask, impl)
        g2 = self.fp3(x2, x3, f2, f3, impl=impl)  # x3 is [B,1,3]: broadcast
        g1 = self.fp2(x1, x2, f1, g2, impl=impl)
        g0 = self.fp1(x0, x1, None, g1, impl=impl)
        pred = xyz + self.head(g0)
        if mask is not None:
            pred = torch.where(mask[..., None], pred, 0.0)
        return pred
