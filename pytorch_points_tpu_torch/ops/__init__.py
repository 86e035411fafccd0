from pytorch_points_tpu_torch.ops.chamfer import (
    chamfer_distance,
    chamfer_path,
    nndistance,
)
from pytorch_points_tpu_torch.ops.emd import earth_mover_distance
from pytorch_points_tpu_torch.ops.grouping import (
    ball_query,
    duplicate_shadow_mask,
    group_all,
    group_knn,
    group_points,
    knn,
    knn_path,
    sample_and_group,
)
from pytorch_points_tpu_torch.ops.interpolate import (
    interpolation_weights,
    three_interpolate,
    three_nn,
)
from pytorch_points_tpu_torch.ops.pairwise import pairwise_sqdist
from pytorch_points_tpu_torch.ops.sampling import (
    furthest_point_sample,
    furthest_point_sample_and_gather,
    gather_points,
    random_sample,
    scatter_add,
)

__all__ = [
    "ball_query",
    "chamfer_distance",
    "chamfer_path",
    "duplicate_shadow_mask",
    "earth_mover_distance",
    "furthest_point_sample",
    "furthest_point_sample_and_gather",
    "gather_points",
    "group_all",
    "group_knn",
    "group_points",
    "interpolation_weights",
    "knn",
    "knn_path",
    "nndistance",
    "pairwise_sqdist",
    "random_sample",
    "sample_and_group",
    "scatter_add",
    "three_interpolate",
    "three_nn",
]
