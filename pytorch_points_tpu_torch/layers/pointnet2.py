"""PointNet++ set-abstraction / feature-propagation modules (counterpart of
the JAX ``layers/pointnet2.py``).

SA = sample_and_group -> shared MLP -> max-pool over neighbours;
FP = three_nn -> inverse-distance three_interpolate -> concat skip ->
shared MLP.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from pytorch_points_tpu_torch.layers.blocks import SharedMLP
from pytorch_points_tpu_torch.ops import (
    group_all,
    interpolation_weights,
    sample_and_group,
    three_interpolate,
    three_nn,
)


class PointNetSAModule(nn.Module):
    """Set abstraction: FPS -> (ball query | kNN) group -> MLP -> max-pool.

    Args:
      in_channels: feature channels of the input (0 if xyz only).
      mlp: output widths of the shared MLP.
      npoint: centroids to sample (None with group_all=True).
      radius: ball radius (None -> kNN grouping).
      nsample: neighbours per centroid.
      use_xyz: concat centred coords to grouped features.
    """

    def __init__(self, in_channels: int, mlp: Sequence[int], *,
                 npoint: int | None = None, radius: float | None = None,
                 nsample: int = 32, use_xyz: bool = True,
                 normalize_radius: bool = False, group_all: bool = False,
                 norm: str | None = "layer", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.use_xyz = use_xyz
        self.normalize_radius = normalize_radius
        self.group_all = group_all
        cin = in_channels + (3 if use_xyz or in_channels == 0 else 0)
        self.mlp = SharedMLP([cin, *mlp], norm=norm, device=device,
                             generator=generator)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None = None,
                mask: torch.Tensor | None = None, impl: str = "auto"):
        """[B,N,3], [B,N,C] -> (new_xyz [B,P,3], new_features [B,P,mlp[-1]])."""
        if self.group_all:
            new_xyz, grouped, _, _ = group_all(xyz, features,
                                               use_xyz=self.use_xyz)
        else:
            new_xyz, grouped, _, _ = sample_and_group(
                xyz, features, self.npoint, self.nsample, self.radius,
                use_xyz=self.use_xyz, normalize_radius=self.normalize_radius,
                mask=mask, impl=impl,
            )
        h = self.mlp(grouped)  # [B, P, S, C']
        return new_xyz, h.amax(dim=2)


class PointNetFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance upsampling + skip + MLP."""

    def __init__(self, in_channels: int, mlp: Sequence[int], *,
                 norm: str | None = "layer", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mlp = SharedMLP([in_channels, *mlp], norm=norm, device=device,
                             generator=generator)

    def forward(self, xyz_hi: torch.Tensor, xyz_lo: torch.Tensor,
                feat_hi: torch.Tensor | None, feat_lo: torch.Tensor,
                lo_mask: torch.Tensor | None = None, impl: str = "auto"):
        """Upsample feat_lo [B,m,C] onto xyz_hi [B,n,3]; concat feat_hi."""
        if xyz_lo.shape[1] == 1:
            # Degenerate global feature: broadcast.
            interp = feat_lo.expand(feat_lo.shape[0], xyz_hi.shape[1],
                                    feat_lo.shape[-1])
        else:
            dist, idx = three_nn(xyz_hi, xyz_lo, known_mask=lo_mask,
                                 impl=impl)
            interp = three_interpolate(feat_lo, idx,
                                       interpolation_weights(dist), impl)
        if feat_hi is not None:
            interp = torch.cat([feat_hi, interp], dim=-1)
        return self.mlp(interp)
