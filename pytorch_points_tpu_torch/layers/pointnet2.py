"""PointNet++ set-abstraction / feature-propagation modules (counterpart of
the JAX ``layers/pointnet2.py``).

SA = sample_and_group -> shared MLP -> max-pool over neighbours; the
multi-scale SA runs one FPS, then for each radius the shared group step,
its own MLP and max-pool, and concatenates the scales' features;
FP = three_nn -> inverse-distance three_interpolate -> concat skip ->
shared MLP.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from pytorch_points_tpu_torch.layers.blocks import SharedMLP
from pytorch_points_tpu_torch.ops import (
    furthest_point_sample_and_gather,
    group_all,
    group_around,
    interpolation_weights,
    sample_and_group,
    sample_and_group_sorted,
    three_interpolate,
    three_nn,
)
from pytorch_points_tpu_torch.utils.profiling import annotate


class PointNetSAModule(nn.Module):
    """Set abstraction: FPS -> (ball query | kNN) group -> MLP -> max-pool.

    Args:
      in_channels: feature channels of the input (0 if xyz only).
      mlp: output widths of the shared MLP.
      npoint: centroids to sample (None with group_all=True).
      radius: ball radius (None -> kNN grouping).
      nsample: neighbours per centroid.
      use_xyz: concat centred coords to grouped features.
      sorted_pipeline: group with :func:`ops.sample_and_group_sorted` (the
        Morton-consistent front half: the pooled output is the same
        function of the same neighbourhood sets, centroids in Morton
        order, a saturated ball an equivalent sampling); used with radius
        grouping and no mask, else the call takes ``sample_and_group``.
      norm, dtype: the shared MLP's (:class:`SharedMLP`).
    """

    def __init__(self, in_channels: int, mlp: Sequence[int], *,
                 npoint: int | None = None, radius: float | None = None,
                 nsample: int = 32, use_xyz: bool = True,
                 normalize_radius: bool = False, group_all: bool = False,
                 sorted_pipeline: bool = False, norm: str | None = "layer",
                 dtype: torch.dtype | None = None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.use_xyz = use_xyz
        self.normalize_radius = normalize_radius
        self.group_all = group_all
        self.sorted_pipeline = sorted_pipeline
        cin = in_channels + (3 if use_xyz or in_channels == 0 else 0)
        self.mlp = SharedMLP([cin, *mlp], norm=norm, dtype=dtype,
                             device=device, generator=generator)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None = None,
                mask: torch.Tensor | None = None, impl: str = "auto"):
        """[B,N,3], [B,N,C] -> (new_xyz [B,P,3], new_features [B,P,mlp[-1]])."""
        with annotate("layers.sa"):
            if self.group_all:
                new_xyz, grouped, _, _ = group_all(xyz, features,
                                                   use_xyz=self.use_xyz)
            elif (self.sorted_pipeline and self.radius is not None
                  and mask is None):
                new_xyz, grouped, _, _, _ = sample_and_group_sorted(
                    xyz, features, self.npoint, self.nsample, self.radius,
                    use_xyz=self.use_xyz,
                    normalize_radius=self.normalize_radius, impl=impl,
                )
            else:
                new_xyz, grouped, _, _ = sample_and_group(
                    xyz, features, self.npoint, self.nsample, self.radius,
                    use_xyz=self.use_xyz,
                    normalize_radius=self.normalize_radius, mask=mask,
                    impl=impl,
                )
            h = self.mlp(grouped)  # [B, P, S, C']
            return new_xyz, h.amax(dim=2)


class PointNetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (Qi et al. 2017, section 3.3):
    one FPS, then for each (radius, nsample, mlp) a ball query around the
    same centroids, the grouped centred coordinates before the grouped
    features, a shared MLP and a max over the group; the scales' outputs
    concatenated in the order given: [B,N,3], [B,N,C] -> (new_xyz
    [B,npoint,3], [B,npoint,sum of the MLPs' last widths]).

    Args:
      in_channels: feature channels of the input (0 if xyz only).
      mlps: one list of output widths a scale.
      npoint: centroids to sample.
      radii, nsamples: each scale's ball radius and group size.
      norm, dtype: the shared MLPs' (:class:`SharedMLP`).
    """

    def __init__(self, in_channels: int, mlps: Sequence[Sequence[int]], *,
                 npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], norm: str | None = "layer",
                 dtype: torch.dtype | None = None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if not len(mlps) == len(radii) == len(nsamples):
            raise ValueError("mlps, radii and nsamples need one entry a "
                             "scale")
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.mlps = nn.ModuleList(
            SharedMLP([in_channels + 3, *mlp], norm=norm, dtype=dtype,
                      device=device, generator=generator) for mlp in mlps)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None = None,
                impl: str = "auto"):
        with annotate("layers.sa"):
            new_xyz, _ = furthest_point_sample_and_gather(xyz, self.npoint,
                                                          impl=impl)
            pooled = []
            for radius, nsample, mlp in zip(self.radii, self.nsamples,
                                            self.mlps):
                grouped, _, _ = group_around(xyz, features, new_xyz, nsample,
                                             radius, impl=impl)
                pooled.append(mlp(grouped).amax(dim=2))
            return new_xyz, torch.cat(pooled, dim=-1)


class PointNetFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance upsampling + skip + MLP."""

    def __init__(self, in_channels: int, mlp: Sequence[int], *,
                 norm: str | None = "layer", dtype: torch.dtype | None = None,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.mlp = SharedMLP([in_channels, *mlp], norm=norm, dtype=dtype,
                             device=device, generator=generator)

    def forward(self, xyz_hi: torch.Tensor, xyz_lo: torch.Tensor,
                feat_hi: torch.Tensor | None, feat_lo: torch.Tensor,
                lo_mask: torch.Tensor | None = None, impl: str = "auto"):
        """Upsample feat_lo [B,m,C] onto xyz_hi [B,n,3]; concat feat_hi."""
        with annotate("layers.fp"):
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
