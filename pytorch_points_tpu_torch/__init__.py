"""PyTorch + CUDA port of ``pytorch_points_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here mirrors
its counterpart's file name and semantics (indices identical, tie-breaks
included). The hot ops run hand-written CUDA kernels (``csrc/``) on CUDA
tensors and their plain PyTorch versions on CPU tensors; see
``kernels/dispatch.py``.

The top level exports the reference's ported ops under its names
(``pytorch_points_tpu/__init__.py``); ``batch_normals``,
``normalize_point_batch``, ``normalize_to_box`` and
``voxel_downsample_mask`` are not ported yet. ``layers`` holds SharedMLP,
the PointNet++ SA/FP modules and DenseEdgeConv; ``models`` the
PointNet2Encoder, PointCloudAutoencoder, PointNet2SemSeg,
PointNet2Classifier and PointUpsampler; ``losses`` the Chamfer, EMD,
repulsion and uniformity losses and the metrics. The host side: ``data``
(PLY dataset, bucketed batcher, prefetcher, augmentation), ``utils``
(I/O, checkpoints, Trainer, timing, profiling, export), ``misc`` (the
logger) and ``_native`` (the C++ host library, built with g++ at first
use). Not ported yet: ``norm="batch"``, ``remat`` and the bf16 ``dtype``
policy, ``sample_and_group_sorted``, the losses built on ``geo/`` and
``geo/`` itself, ``CageDeformer``, ``compat.torch_bridge`` and
``parallel/`` beyond the one-device step.
This package imports ``torch`` and never ``jax``, ``flax`` or
``pytorch_points_tpu``.
"""

__version__ = "0.1.0"

from pytorch_points_tpu_torch.ops import (  # noqa: E402
    ball_query,
    chamfer_distance,
    chamfer_path,
    earth_mover_distance,
    furthest_point_sample,
    furthest_point_sample_and_gather,
    gather_points,
    group_knn,
    group_points,
    knn,
    nndistance,
    sample_and_group,
    scatter_add,
    three_interpolate,
    three_nn,
)

__all__ = ["ball_query", "chamfer_distance", "chamfer_path",
           "earth_mover_distance", "furthest_point_sample",
           "furthest_point_sample_and_gather", "gather_points", "group_knn",
           "group_points", "knn", "nndistance", "sample_and_group",
           "scatter_add", "three_interpolate", "three_nn"]
