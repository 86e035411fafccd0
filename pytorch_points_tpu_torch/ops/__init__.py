from pytorch_points_tpu_torch.ops.chamfer import (
    chamfer_distance,
    chamfer_path,
    nndistance,
)
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
    scatter_add,
)

__all__ = [
    "ball_query",
    "chamfer_distance",
    "chamfer_path",
    "furthest_point_sample",
    "furthest_point_sample_and_gather",
    "gather_points",
    "group_all",
    "group_points",
    "interpolation_weights",
    "knn",
    "nndistance",
    "sample_and_group",
    "scatter_add",
    "three_interpolate",
    "three_nn",
]
