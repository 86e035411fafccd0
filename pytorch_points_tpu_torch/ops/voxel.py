"""On-device voxel-grid downsampling, static shape, returning a mask
(counterpart of the JAX ``ops/voxel.py``).

The host library's grid subsampling (``_native``) averages the points of
each cell into a cloud of varying size; the device form keeps the FIRST
valid point of each occupied voxel (the lowest index, the library's tie
rule) and returns a validity mask, which every masked op takes.
"""

from __future__ import annotations

import torch

_BITS = 10  # cells per axis = 2^10; 3 axes pack into one int32 key


def voxel_downsample_mask(xyz: torch.Tensor, cell: float,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Keep-mask of one representative point per occupied voxel.

    xyz [B,N,3]; ``cell`` the voxel edge. The grid is anchored at each
    cloud's valid minimum corner and has up to 1024 cells an axis
    (coordinates beyond are clamped into the boundary cells). Invalid
    points (``mask`` False) never represent a voxel and stay invalid.

    Returns [B,N] bool: True for the lowest-index valid point of each
    voxel."""
    b, n, _ = xyz.shape
    valid = (torch.ones((b, n), dtype=torch.bool, device=xyz.device)
             if mask is None else mask.to(torch.bool))
    lo = torch.where(valid[..., None], xyz, torch.inf).amin(dim=1,
                                                            keepdim=True)
    g = torch.clamp(torch.floor((xyz - lo) / cell).to(torch.int32), 0,
                    (1 << _BITS) - 1)
    key = (g[..., 0] << (2 * _BITS)) | (g[..., 1] << _BITS) | g[..., 2]
    # invalid points sort last and never match a real voxel key
    key = torch.where(valid, key, (1 << 30) + 1)
    skey, order = torch.sort(key, dim=1, stable=True)  # ties: lowest index
    first = torch.ones_like(valid)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    keep = torch.zeros_like(valid).scatter(1, order, first)
    return keep & valid
