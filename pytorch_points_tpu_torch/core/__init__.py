from pytorch_points_tpu_torch.core.dtypes import accum_dtype, compute_dtype
from pytorch_points_tpu_torch.core.masking import (
    BIG_COORD,
    BIG_DISTANCE,
    lengths_to_mask,
    pad_points,
    poison_points,
)

__all__ = [
    "BIG_COORD",
    "BIG_DISTANCE",
    "accum_dtype",
    "compute_dtype",
    "lengths_to_mask",
    "pad_points",
    "poison_points",
]
