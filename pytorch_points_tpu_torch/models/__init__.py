from pytorch_points_tpu_torch.models.pointnet2 import (
    PointCloudAutoencoder,
    PointNet2Encoder,
)

__all__ = ["PointCloudAutoencoder", "PointNet2Encoder"]
