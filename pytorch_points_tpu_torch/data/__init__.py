"""Host-side data pipeline (counterpart of the JAX ``data/``).

  * :class:`PlyFolderDataset`: a folder of .ply files (the native reader
    when it builds) with optional preprocessing,
  * :class:`BucketedBatcher`: groups clouds by bucketed size into padded
    (points, mask) batches, one static shape per bucket,
  * :class:`Prefetcher`: background-thread batch prefetch (host I/O,
    padding and the copy to the device overlapped with the step),
  * :mod:`augment`: seeded on-device augmentation (jitter, rotate, scale,
    dropout) driven by a ``torch.Generator``.
"""

from pytorch_points_tpu_torch.data import augment
from pytorch_points_tpu_torch.data.loader import (
    BucketedBatcher,
    PlyFolderDataset,
    Prefetcher,
    random_clouds,
)

__all__ = ["BucketedBatcher", "PlyFolderDataset", "Prefetcher", "augment",
           "random_clouds"]
