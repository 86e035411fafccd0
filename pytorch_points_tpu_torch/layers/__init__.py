from pytorch_points_tpu_torch.layers.blocks import SharedMLP
from pytorch_points_tpu_torch.layers.edgeconv import DenseEdgeConv
from pytorch_points_tpu_torch.layers.pointnet2 import (
    PointNetFPModule,
    PointNetSAModule,
    PointNetSAModuleMSG,
)

__all__ = ["DenseEdgeConv", "PointNetFPModule", "PointNetSAModule",
           "PointNetSAModuleMSG", "SharedMLP"]
