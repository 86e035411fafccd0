"""PyTorch + CUDA port of ``pytorch_points_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here mirrors
its counterpart's file name and semantics (indices identical, tie-breaks
included). The hot ops run hand-written CUDA kernels (``csrc/``) on CUDA
tensors and their plain PyTorch versions on CPU tensors; see
``kernels/dispatch.py``.

The top level exports the reference's ops under its names
(``pytorch_points_tpu/__init__.py``) and its ``geo``, ``layers``,
``losses`` and ``models`` modules. ``layers`` holds SharedMLP (LayerNorm
or flax's BatchNorm, float32 or the bf16 ``dtype`` policy), the PointNet++
SA/FP modules (with the Morton-consistent ``sorted_pipeline``) and
DenseEdgeConv; ``models`` the PointNet2Encoder, PointCloudAutoencoder,
PointNet2SemSeg, PointNet2Classifier (each with ``norm``, ``dtype`` and,
where the reference has it, ``remat``), PointUpsampler and CageDeformer;
``losses`` the Chamfer, EMD, SMAPE, Laplacian, normal, edge-length,
repulsion and uniformity losses and the metrics; ``geo`` the mesh
operators, mean value coordinates and differentiable splatting. The host
side: ``data`` (PLY dataset, bucketed batcher, prefetcher,
augmentation), ``utils`` (I/O, checkpoints, Trainer, timing, profiling,
export), ``misc`` (the logger) and ``_native`` (the C++ host library,
built with g++ at first use). ``compat`` has the reference's
channels-first wrappers, the torch bridge and ``load_jax_params``;
``parallel`` the mesh, the data-parallel step and the point-sharded ops
on ``torch.distributed``. Every module of the JAX package has its
counterpart here, except its XLA fallback of the EMD (``_auction_xla``)
and the bridge's ``to_jax``/``from_jax``.
This package imports ``torch`` and never ``jax``, ``flax`` or
``pytorch_points_tpu``.
"""

__version__ = "0.1.0"

from pytorch_points_tpu_torch.ops import (  # noqa: E402
    ball_query,
    batch_normals,
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
    normalize_point_batch,
    normalize_to_box,
    sample_and_group,
    sample_and_group_sorted,
    scatter_add,
    three_interpolate,
    three_nn,
    voxel_downsample_mask,
)

from pytorch_points_tpu_torch import (  # noqa: E402
    geo,
    layers,
    losses,
    models,
)

__all__ = ["ball_query", "batch_normals", "chamfer_distance", "chamfer_path",
           "earth_mover_distance", "furthest_point_sample",
           "furthest_point_sample_and_gather", "gather_points", "geo",
           "group_knn", "group_points", "knn", "layers", "losses", "models",
           "nndistance", "normalize_point_batch", "normalize_to_box",
           "sample_and_group", "sample_and_group_sorted", "scatter_add",
           "three_interpolate", "three_nn", "voxel_downsample_mask"]
