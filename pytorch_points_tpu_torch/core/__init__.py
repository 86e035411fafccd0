from pytorch_points_tpu_torch.core.dtypes import accum_dtype, compute_dtype
from pytorch_points_tpu_torch.core.masking import (
    BIG_COORD,
    BIG_DISTANCE,
    bucket_sizes,
    lengths_to_mask,
    mask_from_lengths,
    pad_points,
    pad_to_bucket,
    poison_points,
)

__all__ = [
    "BIG_COORD",
    "BIG_DISTANCE",
    "accum_dtype",
    "bucket_sizes",
    "compute_dtype",
    "lengths_to_mask",
    "mask_from_lengths",
    "pad_points",
    "pad_to_bucket",
    "poison_points",
]
