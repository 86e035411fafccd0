"""PointNet++ models (counterpart of the JAX ``models/pointnet2.py``).

``PointCloudAutoencoder`` is the flagship: FPS + grouping through SA layers
down to a global code, FP layers (three_nn + three_interpolate) back up, and
a coordinate head. ``PointNet2SemSeg`` is the same SA + FP stack with a
per-point logits head, ``PointNet2Classifier`` the SA encoder with a head
on the global code, ``PointNet2PartSegMSG`` the multi-scale-grouping part
segmenter. They serve (forward) and train: every op on their paths
is a ``torch.autograd.Function`` with the reference's backward rule
(``parallel/data_parallel.py`` builds the train step).

Every model takes the reference's ``norm`` ("layer", "batch" or None),
``dtype`` (None or ``torch.bfloat16``, the bf16 policy of
``core/dtypes.py``) and, where the reference has it, ``remat``: each SA and
FP stage is then checkpointed (``torch.utils.checkpoint``, non-reentrant)
while grad is enabled, its activations recomputed in the backward instead
of kept, as ``nnx.remat`` does. The recompute leaves BatchNorm's running
statistics alone, so they are updated once a step, as under nnx.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_points_tpu_torch.layers import (
    PointNetFPModule,
    PointNetSAModule,
    PointNetSAModuleMSG,
    SharedMLP,
)
from pytorch_points_tpu_torch.layers.blocks import remat_call


def _build_fp_stack(model: nn.Module, kw: dict) -> None:
    """The fp3/fp2/fp1 decoder stack for the SSG encoder's (128, 256, 1024)
    feature hierarchy, as attributes of ``model``."""
    model.fp3 = PointNetFPModule(1024 + 256, [256, 256], **kw)
    model.fp2 = PointNetFPModule(256 + 128, [256, 128], **kw)
    model.fp1 = PointNetFPModule(128, [128, 128], **kw)


def _fp_decode(model: nn.Module, xyzs, feats, impl: str) -> torch.Tensor:
    """The FP stack's wiring back up the SA hierarchy: the encoder's
    (xyz, xyz1, xyz2, xyz3), (None, f1, f2, f3) -> per-point features
    [B,N,128]."""
    (x0, x1, x2, x3), (_, f1, f2, f3) = xyzs, feats
    r = model.remat
    g2 = remat_call(model.fp3, r, x2, x3, f2, f3, impl=impl)  # x3 [B,1,3]
    g1 = remat_call(model.fp2, r, x1, x2, f1, g2, impl=impl)
    return remat_call(model.fp1, r, x0, x1, None, g1, impl=impl)


class PointNet2Encoder(nn.Module):
    """3-level SA hierarchy -> per-level features + global code.

    ``remat`` checkpoints each SA stage: its grouped [B,P,nsample,C]
    activations are the forward's memory peak, so one recompute trades
    for the dominant activation storage at large N."""

    def __init__(self, npoint1: int = 512, npoint2: int = 128,
                 radius1: float = 0.2, radius2: float = 0.4,
                 nsample: int = 32, *, norm: str | None = "layer",
                 dtype: torch.dtype | None = None, remat: bool = False,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.remat = remat
        kw = dict(norm=norm, dtype=dtype, device=device, generator=generator)
        self.sa1 = PointNetSAModule(0, [64, 64, 128], npoint=npoint1,
                                    radius=radius1, nsample=nsample, **kw)
        self.sa2 = PointNetSAModule(128, [128, 128, 256], npoint=npoint2,
                                    radius=radius2, nsample=nsample, **kw)
        self.sa3 = PointNetSAModule(256, [256, 512, 1024], group_all=True,
                                    **kw)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                impl: str = "auto"):
        r = self.remat
        xyz1, f1 = remat_call(self.sa1, r, xyz, None, mask, impl=impl)
        xyz2, f2 = remat_call(self.sa2, r, xyz1, f1, impl=impl)
        xyz3, f3 = remat_call(self.sa3, r, xyz2, f2, impl=impl)
        return (xyz, xyz1, xyz2, xyz3), (None, f1, f2, f3)


class PointCloudAutoencoder(nn.Module):
    """SA encoder -> FP decoder -> per-point coordinate head.

    Reconstructs the input cloud as ``xyz + offsets``; under a bf16
    ``dtype`` the add promotes the offsets back to the coordinates'
    float32, so the loss kernels see float32. ``remat`` checkpoints each SA
    and FP stage. Weights are drawn from ``generator`` (seed 0 when None)
    on the CPU, then moved to ``device``, "cuda" unless the caller asks for
    another (``"cpu"``); ``compat.load_jax_params`` loads the JAX model's
    instead.
    """

    def __init__(self, npoint1: int = 512, npoint2: int = 128, *,
                 norm: str | None = "layer", dtype: torch.dtype | None = None,
                 remat: bool = False, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.remat = remat
        kw = dict(norm=norm, dtype=dtype, device=device, generator=generator)
        self.encoder = PointNet2Encoder(npoint1, npoint2, remat=remat, **kw)
        _build_fp_stack(self, kw)
        self.head = SharedMLP([128, 64, 3], act_last=False, **kw)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
        """[B,N,3] (+ [B,N] bool mask) -> reconstruction [B,N,3]; masked
        rows are 0. ``impl`` selects the kernels' route (kernels.dispatch)."""
        g0 = _fp_decode(self, *self.encoder(xyz, mask, impl), impl)
        pred = xyz + self.head(g0)
        if mask is not None:
            pred = torch.where(mask[..., None], pred, 0.0)
        return pred


class PointNet2Classifier(nn.Module):
    """The PointNet++ SSG classifier: the SA encoder at its defaults, then
    a head on the global code: [B,N,3] -> logits [B,num_classes]."""

    def __init__(self, num_classes: int = 40, *,
                 dtype: torch.dtype | None = None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.encoder = PointNet2Encoder(**kw)
        self.head = SharedMLP([1024, 512, 256, num_classes], act_last=False,
                              **kw)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
        _, feats = self.encoder(xyz, mask, impl)
        return self.head(feats[3][:, 0, :])


class PointNet2SemSeg(nn.Module):
    """PointNet++ SSG semantic segmentation: the autoencoder's SA encoder
    and FP decoder with a per-point class head: [B,N,3] -> logits
    [B,N,num_classes]; masked rows are 0."""

    def __init__(self, num_classes: int, *, npoint1: int = 512,
                 npoint2: int = 128, norm: str | None = "layer",
                 dtype: torch.dtype | None = None, remat: bool = False,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.remat = remat
        kw = dict(norm=norm, dtype=dtype, device=device, generator=generator)
        self.encoder = PointNet2Encoder(npoint1, npoint2, remat=remat, **kw)
        _build_fp_stack(self, kw)
        self.head = SharedMLP([128, 128, num_classes], act_last=False, **kw)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
        logits = self.head(_fp_decode(self, *self.encoder(xyz, mask, impl),
                                      impl))
        if mask is not None:
            logits = torch.where(mask[..., None], logits, 0.0)
        return logits


class PointNet2PartSegMSG(nn.Module):
    """PointNet++ MSG part segmentation at its published widths (Qi et al.
    2017, arXiv:1706.02413; the authors' ``pointnet2_part_seg_msg_one_hot``
    for ShapeNet-Part): points with their normals and a shape category ->
    per-point part logits [B,N,num_classes].

    SA1 groups around 512 centroids at radii 0.1, 0.2, 0.4 (32, 64, 128
    neighbours; MLPs [32,32,64], [64,64,128], [64,96,128]; the normals are
    its input features), SA2 around 128 at 0.4, 0.8 (64, 128; [128,128,256],
    [128,196,256]), SA3 groups all ([256,512,1024]); FP3 [256,256], FP2
    [256,128], FP1 [128,128] with the one-hot category, xyz and normals as
    its skip features; then ``fc1`` (128, norm and ReLU), dropout and
    ``fc2`` (the logits). ``norm`` "layer" stands in for the paper's
    BatchNorm, as in the package's other models. Concatenations keep the
    package's order: centred xyz before grouped features, the skip before
    the interpolated features.

    Dropout runs in ``.train()`` mode only: a channel is kept where
    ``torch.rand(..., generator=dropout_generator) >= dropout`` (torch's
    default generator when None) and scaled by 1 / (1 - dropout), so a
    caller that passes generators seeded alike gets the same mask.
    """

    def __init__(self, num_classes: int = 50, num_categories: int = 16, *,
                 npoint1: int = 512, npoint2: int = 128,
                 norm: str | None = "layer", dropout: float = 0.5,
                 dtype: torch.dtype | None = None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_categories = num_categories
        self.dropout = dropout
        kw = dict(norm=norm, dtype=dtype, device=device, generator=generator)
        self.sa1 = PointNetSAModuleMSG(
            3, [[32, 32, 64], [64, 64, 128], [64, 96, 128]], npoint=npoint1,
            radii=(0.1, 0.2, 0.4), nsamples=(32, 64, 128), **kw)
        self.sa2 = PointNetSAModuleMSG(
            64 + 128 + 128, [[128, 128, 256], [128, 196, 256]],
            npoint=npoint2, radii=(0.4, 0.8), nsamples=(64, 128), **kw)
        self.sa3 = PointNetSAModule(256 + 256, [256, 512, 1024],
                                    group_all=True, **kw)
        self.fp3 = PointNetFPModule(1024 + 512, [256, 256], **kw)
        self.fp2 = PointNetFPModule(256 + 320, [256, 128], **kw)
        self.fp1 = PointNetFPModule(num_categories + 3 + 3 + 128, [128, 128],
                                    **kw)
        self.fc1 = SharedMLP([128, 128], **kw)
        self.fc2 = SharedMLP([128, num_classes], act_last=False, **kw)

    def forward(self, xyz: torch.Tensor, normals: torch.Tensor,
                category: torch.Tensor,
                dropout_generator: torch.Generator | None = None,
                impl: str = "auto") -> torch.Tensor:
        """[B,N,3] points, [B,N,3] normals, [B] int categories -> logits
        [B,N,num_classes]."""
        xyz1, f1 = self.sa1(xyz, normals, impl=impl)
        xyz2, f2 = self.sa2(xyz1, f1, impl=impl)
        xyz3, f3 = self.sa3(xyz2, f2, impl=impl)
        g2 = self.fp3(xyz2, xyz3, f2, f3, impl=impl)
        g1 = self.fp2(xyz1, xyz2, f1, g2, impl=impl)
        onehot = F.one_hot(category.long(), self.num_categories).to(xyz.dtype)
        skip = torch.cat([onehot[:, None, :].expand(-1, xyz.shape[1], -1),
                          xyz, normals], dim=-1)
        h = self.fc1(self.fp1(xyz, xyz1, skip, g1, impl=impl))
        if self.training and self.dropout > 0:
            keep = torch.rand(h.shape, generator=dropout_generator,
                              device=h.device) >= self.dropout
            h = torch.where(keep, h * (1.0 / (1.0 - self.dropout)), 0.0)
        return self.fc2(h)
