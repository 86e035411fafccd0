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
    group_around,
    group_knn,
    group_points,
    knn,
    knn_path,
    sample_and_group,
    sample_and_group_sorted,
)
from pytorch_points_tpu_torch.ops.interpolate import (
    interpolation_weights,
    three_interpolate,
    three_nn,
)
from pytorch_points_tpu_torch.ops.normalize import (
    normalize_point_batch,
    normalize_to_box,
)
from pytorch_points_tpu_torch.ops.normals import batch_normals
from pytorch_points_tpu_torch.ops.pairwise import pairwise_sqdist
from pytorch_points_tpu_torch.ops.sampling import (
    furthest_point_sample,
    furthest_point_sample_and_gather,
    gather_points,
    random_sample,
    scatter_add,
)
from pytorch_points_tpu_torch.ops.voxel import voxel_downsample_mask

__all__ = [
    "ball_query",
    "batch_normals",
    "chamfer_distance",
    "chamfer_path",
    "duplicate_shadow_mask",
    "earth_mover_distance",
    "furthest_point_sample",
    "furthest_point_sample_and_gather",
    "gather_points",
    "group_all",
    "group_around",
    "group_knn",
    "group_points",
    "interpolation_weights",
    "knn",
    "knn_path",
    "nndistance",
    "normalize_point_batch",
    "normalize_to_box",
    "pairwise_sqdist",
    "random_sample",
    "sample_and_group",
    "sample_and_group_sorted",
    "scatter_add",
    "three_interpolate",
    "three_nn",
    "voxel_downsample_mask",
]
