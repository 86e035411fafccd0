"""On-device point-cloud augmentation (counterpart of the JAX
``data/augment.py``).

Where the reference takes a ``jax.random`` key, these take a
``torch.Generator``, which must live on the tensor's device (a CPU
generator cannot drive a draw on the card): the same generator state gives
the same draw. All functions take and return [B, N, 3] batches and respect
validity masks: padded points are left untouched, so the poison and pad
conventions survive augmentation.
"""

from __future__ import annotations

import math

import torch


def _apply_masked(xyz, new_xyz, mask):
    if mask is None:
        return new_xyz
    return torch.where(mask[..., None], new_xyz, xyz)


def _uniform(generator, shape, like, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       dtype=like.dtype, device=like.device)


def jitter(generator: torch.Generator, xyz: torch.Tensor,
           sigma: float = 0.01, clip: float = 0.05, mask=None):
    """Add clipped gaussian noise per point ([B,N,3] -> [B,N,3])."""
    noise = sigma * torch.randn(xyz.shape, generator=generator,
                                dtype=xyz.dtype, device=xyz.device)
    noise = noise.clamp(-clip, clip)
    return _apply_masked(xyz, xyz + noise, mask)


def _axis_rotations(angle: torch.Tensor, axis: str) -> torch.Tensor:
    """[...] angles -> [..., 3, 3] rotations about ``axis``, the
    reference's matrices."""
    c, s = torch.cos(angle), torch.sin(angle)
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    if axis == "x":
        rows = ((one, zero, zero), (zero, c, -s), (zero, s, c))
    elif axis == "y":
        rows = ((c, zero, s), (zero, one, zero), (-s, zero, c))
    elif axis == "z":
        rows = ((c, -s, zero), (s, c, zero), (zero, zero, one))
    else:
        raise ValueError(f"axis must be x/y/z, got {axis!r}")
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rotate_rows(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """out[b,n,i] = sum_j x[b,n,j] * rot[b,i,j], in f32 elementwise
    products and sums (no matmul, so no TF32 on the card: the reference
    forces full precision for the same reason)."""
    return (x[:, :, None, :] * rot[:, None, :, :]).sum(-1)


def rotate(generator: torch.Generator, xyz: torch.Tensor, normals=None,
           axis: str = "y", mask=None):
    """Random per-cloud rotation about one axis ([B,N,3] -> [B,N,3]).

    Returns ``xyz_rot`` or ``(xyz_rot, normals_rot)`` when normals are
    given (normals rotate with the same matrix).
    """
    b = xyz.shape[0]
    angle = _uniform(generator, (b,), xyz, 0.0, 2.0 * math.pi)
    rot = _axis_rotations(angle, axis)  # [B, 3, 3]
    out = _apply_masked(xyz, _rotate_rows(xyz, rot), mask)
    if normals is None:
        return out
    return out, _apply_masked(normals, _rotate_rows(normals, rot), mask)


def random_scale(generator: torch.Generator, xyz: torch.Tensor,
                 lo: float = 0.8, hi: float = 1.25, mask=None):
    """Uniform per-cloud isotropic scale ([B,N,3] -> [B,N,3])."""
    s = _uniform(generator, (xyz.shape[0], 1, 1), xyz, lo, hi)
    return _apply_masked(xyz, xyz * s, mask)


def random_dropout(generator: torch.Generator, xyz: torch.Tensor,
                   max_ratio: float = 0.5, mask=None):
    """Randomly invalidate up to ``max_ratio`` of each cloud's points.

    Static-shape analog of PointNet++'s random input dropout: it returns an
    updated validity MASK with dropped points marked invalid. Already
    invalid points stay invalid, and a cloud keeps its original mask where
    a draw would drop every valid point. Returns (xyz, new_mask).
    """
    b, n, _ = xyz.shape
    ratio = _uniform(generator, (b, 1), xyz, 0.0, max_ratio)
    keep = ~(_uniform(generator, (b, n), xyz, 0.0, 1.0) < ratio)
    base = torch.ones_like(keep) if mask is None else mask
    keep = keep & base
    return xyz, torch.where(keep.any(dim=1, keepdim=True), keep, base)
