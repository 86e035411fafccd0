from pytorch_points_tpu_torch.layers.blocks import SharedMLP
from pytorch_points_tpu_torch.layers.pointnet2 import (
    PointNetFPModule,
    PointNetSAModule,
)

__all__ = ["PointNetFPModule", "PointNetSAModule", "SharedMLP"]
