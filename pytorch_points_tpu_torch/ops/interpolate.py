"""three_nn / three_interpolate, the FP-layer upsampling primitives
(counterpart of the JAX ``ops/interpolate.py``).

For each high-res point, its 3 nearest low-res points (squared distances +
indices); low-res features are interpolated with inverse-distance weights.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.ops.grouping import knn


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             known_mask: torch.Tensor | None = None, impl: str = "auto"):
    """[B,n,3] high-res, [B,m,3] low-res -> (dist [B,n,3] squared
    ascending, idx [B,n,3] int32)."""
    return knn(unknown, known, 3, support_mask=known_mask, impl=impl)


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8):
    """weights = (1/(d+eps)) / sum(1/(d+eps)) over the 3 neighbours."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(dim=-1, keepdim=True)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor):
    """[B,m,C] low-res features, [B,n,3] idx, [B,n,3] weights -> [B,n,C].

    Plain PyTorch, as the reference's forward is plain XLA."""
    b, n, k = idx.shape
    gathered = features.gather(
        1, idx.long().reshape(b, n * k, 1).expand(b, n * k,
                                                  features.shape[-1])
    ).reshape(b, n, k, -1)
    return (gathered * weight.to(features.dtype)[..., None]).sum(dim=2)
