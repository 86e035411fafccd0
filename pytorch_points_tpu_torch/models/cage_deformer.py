"""Neural-Cages-style deformation model (counterpart of the JAX
``models/cage_deformer.py``).

Source and target clouds are each encoded by a PointNet++ encoder; a head
on the joint code predicts cage-vertex offsets (tanh-scaled); the source
is deformed through its mean value coordinates (``geo/cage.py``), one
float32 product of the weights and the new cage.
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_points_tpu_torch.geo.cage import (
    deform_with_cage,
    mean_value_coordinates,
)
from pytorch_points_tpu_torch.layers import SharedMLP
from pytorch_points_tpu_torch.models.pointnet2 import PointNet2Encoder


class CageDeformer(nn.Module):
    """Predicts target-driven cage offsets and deforms the source by MVC.

    ``encoder_src``, ``encoder_tgt`` (PointNet2Encoder at npoint1/npoint2)
    and ``head`` ([2048, 512, 256, 3 Vc]), named as in the JAX model so
    ``compat.load_jax_params`` maps them. ``dtype`` is the encoders' and
    head's computation dtype (parameters stay float32); the offsets are
    promoted to float32 where they meet the cage, so the deformation runs
    at full precision.
    Weights are drawn from ``generator`` (seed 0 when None) on the CPU,
    then moved to ``device``, the card unless the caller names another.
    """

    def __init__(self, n_cage_verts: int, *, npoint1: int = 256,
                 npoint2: int = 64, offset_scale: float = 0.1,
                 dtype: torch.dtype | None = None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.encoder_src = PointNet2Encoder(npoint1, npoint2, **kw)
        self.encoder_tgt = PointNet2Encoder(npoint1, npoint2, **kw)
        self.head = SharedMLP([2048, 512, 256, n_cage_verts * 3],
                              act_last=False, **kw)
        self.n_cage_verts = n_cage_verts
        self.offset_scale = offset_scale

    def predict_offsets(self, source: torch.Tensor, target: torch.Tensor,
                        impl: str = "auto") -> torch.Tensor:
        """[B,N,3] x2 -> cage-vertex offsets [B,Vc,3] (in ``dtype``)."""
        _, fs = self.encoder_src(source, impl=impl)
        _, ft = self.encoder_tgt(target, impl=impl)
        code = torch.cat([fs[3][:, 0, :], ft[3][:, 0, :]], dim=-1)
        off = self.head(code).reshape(-1, self.n_cage_verts, 3)
        return self.offset_scale * torch.tanh(off)

    def forward(self, source: torch.Tensor, target: torch.Tensor,
                cage_verts, cage_faces, weights: torch.Tensor | None = None,
                impl: str = "auto"):
        """Deform ``source`` toward ``target``.

        source/target [B,N,3]; cage_verts [Vc,3], the source cage shared by
        the batch; cage_faces [F,3]; weights: the MVC weights [B,N,Vc],
        computed here when None (pass them when the source is fixed across
        steps: they depend on its geometry alone).

        Returns (deformed [B,N,3], new_cage [B,Vc,3], weights).
        """
        if weights is None:
            weights = mean_value_coordinates(source, cage_verts, cage_faces,
                                             impl=impl)
        offsets = self.predict_offsets(source, target, impl)
        cage = torch.as_tensor(cage_verts, dtype=torch.float32,
                               device=source.device)
        new_cage = cage[None] + offsets
        return deform_with_cage(weights, new_cage), new_cage, weights
