"""Pairwise squared distances in the matmul form (counterpart of the JAX
``ops/pairwise.py``).

``max(|p|^2 + |q|^2 - 2 p.q, 0)``, the form the reference keeps for the
places that only need a coarse distance (the auction's hardness hint). It
picks other near-tie winners than the diff^2 form the kernels use, so no
index-graded path goes through it.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[..., N, C], [..., M, C] -> [..., N, M] squared distances, clamped at
    0. The cross term is a float32 ``torch.matmul``: it is full float32 on
    the card only while ``torch.backends.cuda.matmul.allow_tf32`` is False
    (PyTorch's default), as the reference's ``Precision.HIGHEST``."""
    p2 = (p * p).sum(-1)[..., :, None]
    q2 = (q * q).sum(-1)[..., None, :]
    cross = torch.matmul(p, q.transpose(-1, -2))
    return torch.clamp_min(p2 + q2 - 2.0 * cross, 0.0)
