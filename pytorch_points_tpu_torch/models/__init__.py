from pytorch_points_tpu_torch.models.pointnet2 import (
    PointCloudAutoencoder,
    PointNet2Classifier,
    PointNet2Encoder,
    PointNet2PartSegMSG,
    PointNet2SemSeg,
)
from pytorch_points_tpu_torch.models.cage_deformer import CageDeformer
from pytorch_points_tpu_torch.models.upsampler import PointUpsampler

__all__ = ["CageDeformer", "PointCloudAutoencoder", "PointNet2Classifier",
           "PointNet2Encoder", "PointNet2PartSegMSG", "PointNet2SemSeg",
           "PointUpsampler"]
