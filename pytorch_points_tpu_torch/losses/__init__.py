"""Losses and evaluation metrics (counterpart of the JAX ``losses``)."""

from pytorch_points_tpu_torch.losses.losses import (
    ChamferLoss,
    EMDLoss,
    MeshEdgeLengthLoss,
    MeshLaplacianLoss,
    NormalLoss,
    PointEdgeLengthLoss,
    PointLaplacianLoss,
    RepulsionLoss,
    SmapeLoss,
    UniformLoss,
)
from pytorch_points_tpu_torch.losses.metrics import (
    chamfer_l1,
    coverage_and_mmd,
    fscore,
    hausdorff_distance,
    one_nn_accuracy,
)

__all__ = [
    "ChamferLoss",
    "EMDLoss",
    "MeshEdgeLengthLoss",
    "MeshLaplacianLoss",
    "NormalLoss",
    "PointEdgeLengthLoss",
    "PointLaplacianLoss",
    "RepulsionLoss",
    "SmapeLoss",
    "UniformLoss",
    "chamfer_l1",
    "coverage_and_mmd",
    "fscore",
    "hausdorff_distance",
    "one_nn_accuracy",
]
