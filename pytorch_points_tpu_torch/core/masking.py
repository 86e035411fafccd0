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

import math
from collections.abc import Sequence

import torch

# Large-but-finite poison offset: distances to poisoned points are
# ~(2 * BIG_COORD)^2 = 1.6e9, far above any real squared distance for
# normalised clouds, while BIG^2 stays well inside float32.
BIG_COORD = 2.0e4
BIG_DISTANCE = 1.0e9


def lengths_to_mask(lengths, max_len: int) -> torch.Tensor:
    """[B] int lengths (a tensor, or anything ``torch.as_tensor`` takes) ->
    [B, max_len] bool validity mask."""
    lengths = torch.as_tensor(lengths)
    idx = torch.arange(max_len, device=lengths.device)[None, :]
    return idx < lengths[:, None]


# Alias matching the more common naming in other libraries.
mask_from_lengths = lengths_to_mask


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


def bucket_sizes(sizes: Sequence[int], *, multiple: int = 256,
                 max_buckets: int = 8) -> list[int]:
    """Choose static bucket sizes covering the given cloud sizes.

    Buckets are multiples of ``multiple``; each size is padded up to the
    smallest covering bucket. With more distinct rounded sizes than
    ``max_buckets``, a quantile spread of them is kept, always with the
    largest. Pure host-side Python: the same sizes give the reference's
    buckets.
    """
    if not sizes:
        return []
    uniq = sorted({int(math.ceil(s / multiple)) * multiple for s in sizes})
    if len(uniq) <= max_buckets:
        return uniq
    picks = {uniq[-1]}
    for q in range(1, max_buckets):
        picks.add(uniq[int(round(q * (len(uniq) - 1) / max_buckets))])
    return sorted(picks)


def pad_to_bucket(xyz: torch.Tensor, buckets: Sequence[int]):
    """Pad a single cloud [N, C] to its covering bucket; returns (padded,
    mask)."""
    n = xyz.shape[-2]
    for b in sorted(buckets):
        if n <= b:
            return pad_points(xyz, b)
    raise ValueError(f"no bucket >= {n} in {list(buckets)}")
