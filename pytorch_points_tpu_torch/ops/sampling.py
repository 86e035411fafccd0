"""Furthest point sampling + gather (counterpart of the JAX ``ops/sampling.py``).

Reference semantics: iteratively select ``k`` points maximising the minimum
distance to the already-selected set, seeded with the first valid index,
ties to the lowest index; float32 throughout so selections are
index-identical to the reference.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.kernels import fps as fps_kernel
from pytorch_points_tpu_torch.kernels.gather import gather_rows


def furthest_point_sample(xyz: torch.Tensor, k: int,
                          mask: torch.Tensor | None = None,
                          impl: str = "auto",
                          seed_idx: torch.Tensor | None = None):
    """[B,N,3] -> [B,k] int32 FPS indices.

    ``mask`` ([B,N] bool): invalid points are never selected; with fewer than
    ``k`` valid points the sampler re-selects duplicates. ``seed_idx`` ([B]
    int32) forces the first selection per cloud.
    """
    return fps_kernel.furthest_point_sample(xyz, k, mask, seed_idx, impl)[0]


def furthest_point_sample_and_gather(xyz: torch.Tensor, k: int,
                                     mask: torch.Tensor | None = None,
                                     impl: str = "auto",
                                     seed_idx: torch.Tensor | None = None):
    """FPS and the sampled coordinates: (new_xyz [B,k,3], idx [B,k]).

    The kernel emits the coordinates as it selects them, so no separate
    gather runs."""
    idx, coords = fps_kernel.furthest_point_sample(xyz, k, mask, seed_idx,
                                                   impl)
    return coords, idx


def gather_points(features: torch.Tensor, idx: torch.Tensor,
                  impl: str = "auto"):
    """[B,N,C] features, [B,K] int32 indices -> [B,K,C]."""
    return gather_rows(features, idx, impl)
