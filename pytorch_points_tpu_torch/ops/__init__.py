from pytorch_points_tpu_torch.ops.grouping import (
    ball_query,
    group_all,
    group_points,
    knn,
    sample_and_group,
)
from pytorch_points_tpu_torch.ops.interpolate import (
    interpolation_weights,
    three_interpolate,
    three_nn,
)
from pytorch_points_tpu_torch.ops.sampling import (
    furthest_point_sample,
    furthest_point_sample_and_gather,
    gather_points,
)

__all__ = [
    "ball_query",
    "furthest_point_sample",
    "furthest_point_sample_and_gather",
    "gather_points",
    "group_all",
    "group_points",
    "interpolation_weights",
    "knn",
    "sample_and_group",
    "three_interpolate",
    "three_nn",
]
