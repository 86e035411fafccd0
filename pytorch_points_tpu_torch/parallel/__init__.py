from pytorch_points_tpu_torch.parallel.data_parallel import (
    make_train_step,
    reconstruction_loss,
)

__all__ = ["make_train_step", "reconstruction_loss"]
