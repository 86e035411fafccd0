"""Basic blocks (counterpart of the JAX ``layers/blocks.py``)."""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import torch
from torch import nn

# flax's LayerNorm default (nnx.LayerNorm epsilon); torch's is 1e-5.
LAYER_NORM_EPS = 1e-6


def _linear(cin: int, cout: int, generator: torch.Generator) -> nn.Linear:
    """nn.Linear with flax's initialisation: lecun-normal weight (a normal
    truncated at 2 std, rescaled to unit variance per fan-in), zero bias.
    Drawn from ``generator`` on the CPU, so a seed gives the same weights on
    every device."""
    lin = nn.utils.skip_init(nn.Linear, cin, cout)
    std = math.sqrt(1.0 / cin) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        lin.bias.zero_()
    return lin


class SharedMLP(nn.Module):
    """Pointwise MLP over the last axis of [..., C] tensors.

    ``layers`` and ``norms`` are ``nn.ModuleList``s with ``nn.Identity``
    where the JAX list holds None, so module paths map one to one onto the
    JAX parameter tree.

    norm: None | "layer" (LayerNorm, eps 1e-6 as in flax).

    Weights are drawn from ``generator`` (seed 0 when None) on the CPU, then
    moved to ``device``, the card unless the caller names another device;
    without a card the default raises, as ``.to("cuda")`` does.
    """

    def __init__(self, channels: Sequence[int], *,
                 activation: Callable = torch.relu,
                 norm: str | None = "layer", act_last: bool = True,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if len(channels) < 2:
            raise ValueError("channels must include input and output dims")
        if norm not in (None, "layer"):
            raise ValueError(f"unknown norm {norm!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.activation = activation
        self.act_last = act_last
        layers, norms = [], []
        for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            layers.append(_linear(cin, cout, generator))
            is_last = i == len(channels) - 2
            if norm is not None and (act_last or not is_last):
                norms.append(nn.LayerNorm(cout, eps=LAYER_NORM_EPS))
            else:
                norms.append(nn.Identity())
        self.layers = nn.ModuleList(layers)
        self.norms = nn.ModuleList(norms)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, (lin, nrm) in enumerate(zip(self.layers, self.norms)):
            x = lin(x)
            if i == n - 1 and not self.act_last:
                break
            x = self.activation(nrm(x))
        return x
