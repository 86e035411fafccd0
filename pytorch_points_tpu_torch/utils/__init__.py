"""Utilities: point-cloud and mesh I/O, checkpointing, training, timing,
profiling and export (counterpart of the JAX ``utils/``).

The modules that import the ops, layers or the train step load at first
use of one of their names: ``ops`` and ``layers`` open their spans through
``utils.profiling``, so this package is imported while they are."""

import importlib

from pytorch_points_tpu_torch.utils import geometry_utils, pc_utils, profiling
from pytorch_points_tpu_torch.utils.benchmark import device_sync, measure

_LAZY = {
    "export_fn": "export", "export_forward": "export",
    "load_exported": "export",
    **dict.fromkeys(["check_values", "clamp_gradients", "linear_loss_weight",
                     "load_network", "save_network", "step_lr_schedule",
                     "warmup_cosine_lr_schedule", "weights_init"],
                    "train_utils"),
    "Trainer": "trainer",
}


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Trainer", "check_values", "clamp_gradients", "device_sync",
           "export_fn", "export_forward", "geometry_utils",
           "linear_loss_weight", "load_exported", "load_network", "measure",
           "pc_utils", "profiling", "save_network", "step_lr_schedule",
           "warmup_cosine_lr_schedule", "weights_init"]
