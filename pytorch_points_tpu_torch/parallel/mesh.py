"""Device mesh construction (counterpart of the JAX ``parallel/mesh.py``).

``torch.distributed`` is the port's ``shard_map``: one process a rank and a
device a process. The process group is the caller's to start
(``torch.distributed.init_process_group`` with its store, rank and world
size, or a launcher such as ``torchrun``); the mesh names its dims over
that world.
"""

from __future__ import annotations

import math
import os

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axes: dict[str, int] | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` with named dims over every rank of the world.

    Args:
      axes: ordered {axis_name: size}; sizes must multiply to the world
        size. Default: every rank on a single 'data' axis.
      device_type: "cuda" (NCCL, or gloo where the caller started a gloo
        group) or "cpu" (gloo).
    """
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if axes is None:
        axes = {"data": world}
    sizes = list(axes.values())
    if math.prod(sizes) != world:
        raise ValueError(
            f"mesh axes {axes} need {math.prod(sizes)} devices, have {world}")
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(axes.keys()))
