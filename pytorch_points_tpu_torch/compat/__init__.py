from pytorch_points_tpu_torch.compat.jax_params import load_jax_params

__all__ = ["load_jax_params"]
