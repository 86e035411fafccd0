"""Utilities: point-cloud and mesh I/O, checkpointing, training, timing,
profiling and export (counterpart of the JAX ``utils/``)."""

from pytorch_points_tpu_torch.utils import geometry_utils, pc_utils, profiling
from pytorch_points_tpu_torch.utils.benchmark import device_sync, measure
from pytorch_points_tpu_torch.utils.export import (
    export_fn,
    export_forward,
    load_exported,
)
from pytorch_points_tpu_torch.utils.train_utils import (
    check_values,
    clamp_gradients,
    linear_loss_weight,
    load_network,
    save_network,
    step_lr_schedule,
    warmup_cosine_lr_schedule,
    weights_init,
)
from pytorch_points_tpu_torch.utils.trainer import Trainer

__all__ = ["Trainer", "check_values", "clamp_gradients", "device_sync",
           "export_fn", "export_forward", "geometry_utils",
           "linear_loss_weight", "load_exported", "load_network", "measure",
           "pc_utils", "profiling", "save_network", "step_lr_schedule",
           "warmup_cosine_lr_schedule", "weights_init"]
