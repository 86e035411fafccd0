"""DenseEdgeConv, the 3PU densely connected edge convolution (counterpart of
the JAX ``layers/edgeconv.py``).

For each point: kNN edge features (centre, neighbour - centre), a first
conv, then ``n - 1`` further convs each reading the concatenation of the
input and every earlier conv's output (dense connectivity), then a max over
the neighbourhood. Output channels = in_channels + n * growth_rate.
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_points_tpu_torch.layers.blocks import _linear
from pytorch_points_tpu_torch.ops import group_points, knn
from pytorch_points_tpu_torch.utils.profiling import annotate


class DenseEdgeConv(nn.Module):
    """Densely connected edge convolution over kNN graphs (3PU).

    ``first`` is a Linear(2 C, g) and ``convs`` an ``nn.ModuleList`` of
    ``n - 1`` Linears whose input widths grow by g each, so the parameter
    paths are the JAX module's (``first/...``, ``convs/0/...``). Weights are
    drawn from ``generator`` (seed 0 when None) on the CPU, then moved to
    ``device``, the card unless the caller names another device.

    dtype: the convs' computation dtype (None: float32), as
    :class:`SharedMLP`'s; parameters stay float32. A feature-space graph
    of bfloat16 features is searched on their float32 casts (exact).
    """

    def __init__(self, in_channels: int, growth_rate: int, n: int = 3,
                 k: int = 16, *, dtype: torch.dtype | None = None,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.k = k
        self.n = n
        self.growth_rate = growth_rate
        self.first = _linear(2 * in_channels, growth_rate, generator, dtype)
        convs = []
        cin = in_channels + growth_rate
        for _ in range(n - 1):
            convs.append(_linear(cin, growth_rate, generator, dtype))
            cin += growth_rate
        self.convs = nn.ModuleList(convs)
        self.to(device)

    @property
    def out_channels(self) -> int:
        return self.first.in_features // 2 + self.n * self.growth_rate

    def forward(self, features: torch.Tensor, xyz: torch.Tensor | None = None,
                mask: torch.Tensor | None = None,
                impl: str = "auto") -> torch.Tensor:
        """[B,N,C] (+ xyz [B,N,3] for the graph's metric, + [B,N] bool mask)
        -> [B,N,C + n g]; masked rows are 0.

        The graph is built on ``xyz`` when given (kNN over coordinates),
        else in feature space over all C channels (the dynamic graph of
        DGCNN). Its indices carry no gradient."""
        with annotate("layers.edgeconv"):
            ref = (features if xyz is None else xyz).detach()
            _, idx = knn(ref, ref, self.k + 1, support_mask=mask, impl=impl)
            nbrs = group_points(features, idx[..., 1:], impl)  # drop self
            center = features[:, :, None, :]
            x = center.expand_as(nbrs)  # the input, replicated per edge
            y = torch.relu(self.first(torch.cat([x, nbrs - center], dim=-1)))
            h = torch.cat([x, y], dim=-1)
            for conv in self.convs:
                y = torch.relu(conv(h))
                h = torch.cat([h, y], dim=-1)
            # amax, as jnp.max, splits a gradient evenly among tied maxima
            # (the centre copies always tie)
            out = torch.amax(h, dim=2)
            if mask is not None:
                out = torch.where(mask[..., None], out, 0.0)
            return out
