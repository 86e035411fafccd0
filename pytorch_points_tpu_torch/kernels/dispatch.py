"""Implementation dispatch: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.

Every public op takes ``impl`` in {"auto", "cuda", "torch"}:

* "auto" resolves to "cuda" for a CUDA tensor and to "torch" for a CPU
  tensor;
* "cuda" on a CPU tensor raises;
* "torch" runs the plain version wherever the tensor lies. It is the only
  way from a CUDA tensor to the plain version (used to hold the kernels
  against their plain versions on the card).

While torch.export (or torch.compile) traces a call, a kernel that is a
ctypes call on data pointers cannot be traced; the ops on the
autoencoder's forward and the dense chamfer (K1, K2 and its coordinate
instance, K3, K8, K5) then go through their ``torch.library`` custom ops
(``ppt::*``), which launch the kernel on a CUDA tensor and run the plain
version on a CPU one: :func:`traced` says when.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.kernels import AVAILABLE

IMPLS = ("auto", "cuda", "torch")
# the reference's values, which the telemetry functions (``chamfer_path``,
# ``knn_path``) also take: the port holds the reference's Pallas semantics
# on every route, so both answer the route the port takes
REFERENCE_IMPLS = ("pallas", "xla")


def resolve(impl: str, x: torch.Tensor, op: str) -> str:
    """Resolve ``impl`` for ``op`` applied to tensor ``x``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    if impl == "cuda":
        if not x.is_cuda:
            raise ValueError(
                f"{op}: impl='cuda' needs a CUDA tensor, got one on {x.device}"
            )
        if op not in AVAILABLE:
            raise NotImplementedError(f"{op}: no CUDA kernel yet")
    return impl


def traced(impl: str) -> bool:
    """Whether an op goes through its ``ppt::`` custom op: while torch
    traces it, unless the caller asked for the plain version (whose torch
    ops are traced as they are)."""
    return impl != "torch" and torch.compiler.is_compiling()
