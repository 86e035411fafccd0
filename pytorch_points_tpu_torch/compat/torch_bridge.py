"""Reference Conv+BatchNorm weights into the port (counterpart of the JAX
``compat/torch_bridge.py``).

The reference's shared MLPs are 1x1 convolutions (``nn.Conv1d``/``Conv2d``)
each followed by a BatchNorm; the port's ``SharedMLP`` is ``Linear`` layers
over the last axis with flax's BatchNorm (``layers/blocks.py``). The JAX
module's ``to_jax`` and ``from_jax`` have no counterpart: the port holds
torch tensors throughout and never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pytorch_points_tpu_torch.layers.blocks import BatchNorm


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def linear_kernel_from_conv(weight) -> np.ndarray:
    """Reference conv weight -> the JAX ``nnx.Linear`` kernel [Cin, Cout]
    (numpy), as the JAX bridge gives it: Conv1d weights [Cout, Cin, 1] or
    Conv2d [Cout, Cin, 1, 1] with the taps dropped, transposed. The port's
    ``Linear.weight`` is its transpose, [Cout, Cin]."""
    w = _numpy(weight)
    w = w.reshape(w.shape[0], w.shape[1])  # drop the 1(x1) taps
    return np.swapaxes(w, 0, 1)


def load_shared_mlp_from_torch(mlp, conv_weights, conv_biases=None,
                               bn_params=None) -> None:
    """Copy reference Conv(+BN) stack weights into a ``SharedMLP`` in place.

    Args:
      mlp: a :class:`pytorch_points_tpu_torch.layers.SharedMLP`.
      conv_weights: conv weights ([Cout,Cin,1] or [Cout,Cin,1,1]), one per
        Linear layer.
      conv_biases: optional matching list of [Cout] biases (None entries
        allowed).
      bn_params: optional list of dicts with torch BatchNorm state
        (``weight``, ``bias``, ``running_mean``, ``running_var``), one per
        BatchNorm layer; only valid when the SharedMLP was built with
        ``norm="batch"``. With ``act_last=False`` the last layer has no
        norm: pass one entry per real norm (None placeholders are skipped).

    Raises ValueError, as the JAX bridge does, on a count or shape that does
    not fit, or BatchNorm state for a SharedMLP without BatchNorms.
    """
    if len(conv_weights) != len(mlp.layers):
        raise ValueError(
            f"{len(conv_weights)} conv weights for {len(mlp.layers)} layers")
    kernels = []
    for i, (layer, w) in enumerate(zip(mlp.layers, conv_weights)):
        k = linear_kernel_from_conv(w)
        want = (layer.in_features, layer.out_features)
        if k.shape != want:
            raise ValueError(f"layer {i}: conv gives kernel {k.shape}, "
                             f"Linear expects {want}")
        kernels.append(k)
    states = []
    if bn_params is not None:
        real_norms = [n for n in mlp.norms if not isinstance(n, nn.Identity)]
        states = [p for p in bn_params if p is not None]
        if len(states) != len(real_norms):
            raise ValueError(
                f"{len(states)} BN states for {len(real_norms)} norm layers")
        if any(not isinstance(n, BatchNorm) for n in real_norms):
            raise ValueError("bn_params given but SharedMLP was not built "
                             "with norm='batch'")
        states = list(zip(real_norms, states))
    with torch.no_grad():
        for i, (layer, k) in enumerate(zip(mlp.layers, kernels)):
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(k.T)))
            if conv_biases is not None and conv_biases[i] is not None:
                layer.bias.copy_(torch.from_numpy(_numpy(conv_biases[i])))
        for norm, p in states:
            norm.weight.copy_(torch.from_numpy(_numpy(p["weight"])))
            norm.bias.copy_(torch.from_numpy(_numpy(p["bias"])))
            norm.running_mean.copy_(torch.from_numpy(
                _numpy(p["running_mean"])))
            norm.running_var.copy_(torch.from_numpy(
                _numpy(p["running_var"])))
