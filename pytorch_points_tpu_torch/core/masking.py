"""Padding, masks and poisoning (counterpart of the JAX ``core/masking.py``).

Ragged clouds are (padded tensor, bool mask) pairs. Two invariants hold for
every op:

  1. a padded (invalid) point never wins an argmin / argmax / top-k and is
     never returned as a neighbour index;
  2. a padded point receives zero gradient.

Kernels stay mask-free where the reference's do: invalid points get their
coordinates replaced by far-away constants (``poison_points``) with the same
offsets as the reference, so both packages see the same distances.
"""

from __future__ import annotations

import torch

# Large-but-finite poison offset: distances to poisoned points are
# ~(2 * BIG_COORD)^2 = 1.6e9, far above any real squared distance for
# normalised clouds, while BIG^2 stays well inside float32.
BIG_COORD = 2.0e4
BIG_DISTANCE = 1.0e9


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_len] bool validity mask."""
    idx = torch.arange(max_len, device=lengths.device)[None, :]
    return idx < lengths[:, None]


def poison_points(xyz: torch.Tensor, mask: torch.Tensor | None,
                  sign: float = 1.0) -> torch.Tensor:
    """Replace invalid points' coordinates with far-away constants.

    Each invalid slot i moves to ``sign * (BIG_COORD + 4 i)`` along the
    first coordinate, so two poisoned points are also far from each other.
    """
    if mask is None:
        return xyz
    n = xyz.shape[-2]
    offs = BIG_COORD + 4.0 * torch.arange(n, dtype=xyz.dtype,
                                          device=xyz.device)
    poison = torch.zeros_like(xyz)
    poison[..., 0] = sign * offs
    return torch.where(mask[..., None], xyz, poison)


def pad_points(xyz: torch.Tensor, target_n: int, axis: int = -2):
    """Zero-pad a cloud along the point axis up to ``target_n``.

    Returns (padded, mask) where mask marks the original points. Accepts a
    single cloud [N, C] or a batch [B, N, C].
    """
    axis = axis % xyz.ndim
    n = xyz.shape[axis]
    if n > target_n:
        raise ValueError(f"cloud has {n} points > target {target_n}")
    pad_shape = list(xyz.shape)
    pad_shape[axis] = target_n - n
    padded = torch.cat([xyz, xyz.new_zeros(pad_shape)], dim=axis)
    mask = torch.zeros(list(xyz.shape[:axis]) + [target_n], dtype=torch.bool,
                       device=xyz.device)
    mask[..., :n] = True
    return padded, mask
