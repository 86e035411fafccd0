"""Misc: logging (counterpart of the JAX ``misc/``)."""

from pytorch_points_tpu_torch.misc.logger import get_logger

__all__ = ["get_logger"]
