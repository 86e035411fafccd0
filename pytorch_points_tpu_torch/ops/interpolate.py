"""three_nn / three_interpolate, the FP-layer upsampling primitives
(counterpart of the JAX ``ops/interpolate.py``).

For each high-res point, its 3 nearest low-res points (squared distances +
indices); low-res features are interpolated with inverse-distance weights.
The backward scatters weighted gradients to the low-res points (kernel K4)
and gradients flow into both clouds through the kNN distances.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.ops.grouping import knn
from pytorch_points_tpu_torch.ops.scatter_impl import scatter_add_auto


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             known_mask: torch.Tensor | None = None, impl: str = "auto"):
    """[B,n,3] high-res, [B,m,3] low-res -> (dist [B,n,3] squared
    ascending, idx [B,n,3] int32)."""
    return knn(unknown, known, 3, support_mask=known_mask, impl=impl)


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8):
    """weights = (1/(d+eps)) / sum(1/(d+eps)) over the 3 neighbours."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(dim=-1, keepdim=True)


def _gathered(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B,m,C], [B,n,k] -> [B,n,k,C] (plain torch, as the reference's XLA)."""
    b, n, k = idx.shape
    return features.gather(
        1, idx.long().reshape(b, n * k, 1).expand(b, n * k,
                                                  features.shape[-1])
    ).reshape(b, n, k, -1)


class _ThreeInterpolate(torch.autograd.Function):
    """Forward in plain torch. Backward: a scatter-add (K4) of the weighted
    gradient into the features, and the gathered dot for the weights."""

    @staticmethod
    def forward(ctx, features, idx, weight, impl):
        ctx.save_for_backward(features, idx, weight)
        ctx.impl = impl
        return (_gathered(features, idx) * weight[..., None]).sum(dim=2)

    @staticmethod
    def backward(ctx, g):
        features, idx, weight = ctx.saved_tensors
        b, m, c = features.shape
        n, k = idx.shape[1:]
        grad_f = grad_w = None
        if ctx.needs_input_grad[0]:
            wg = g[:, :, None, :] * weight[..., None]  # [B,n,k,C]
            grad_f = scatter_add_auto(idx.reshape(b, n * k),
                                      wg.reshape(b, n * k, c), m, ctx.impl)
        if ctx.needs_input_grad[2]:
            grad_w = (_gathered(features, idx) * g[:, :, None, :]).sum(dim=-1)
        return grad_f, None, grad_w, None


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor, impl: str = "auto"):
    """[B,m,C] low-res features, [B,n,3] idx, [B,n,3] weights -> [B,n,C];
    differentiable in ``features`` and ``weight``."""
    return _ThreeInterpolate.apply(features, idx, weight.to(features.dtype),
                                   impl)
