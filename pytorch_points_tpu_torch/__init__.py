"""PyTorch + CUDA port of ``pytorch_points_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here mirrors
its counterpart's file name and semantics (indices identical, tie-breaks
included). The hot ops run hand-written CUDA kernels (``csrc/``) on CUDA
tensors and their plain PyTorch versions on CPU tensors; see
``kernels/dispatch.py``.

This package imports ``torch`` and never ``jax``, ``flax`` or
``pytorch_points_tpu``.
"""

__version__ = "0.1.0"

from pytorch_points_tpu_torch.ops import (  # noqa: E402
    chamfer_distance,
    chamfer_path,
    earth_mover_distance,
    nndistance,
    scatter_add,
)

__all__ = ["chamfer_distance", "chamfer_path", "earth_mover_distance",
           "nndistance", "scatter_add"]
