"""Load a JAX (flax nnx) model's parameters into its port.

``tree`` is the nested dict of numpy arrays that
``jax.tree.map(np.asarray, nnx.to_pure_dict(nnx.state(model, nnx.Param)))``
gives. Module paths match one to one (``encoder/sa1/mlp/layers/0``); a
Linear's ``kernel`` [in, out] becomes ``weight`` [out, in], and a
LayerNorm's or BatchNorm's ``scale`` becomes ``weight``.

A BatchNorm's running statistics are ``nnx.BatchStat``s, not Params: pass
them as ``batch_stats``, the same kind of tree of
``nnx.state(model, nnx.BatchStat)``, or pass the state of both,
``nnx.state(model, (nnx.Param, nnx.BatchStat))``, as ``tree``. Its
``mean``/``var`` fill ``running_mean``/``running_var``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pytorch_points_tpu_torch.layers.blocks import BatchNorm


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, prefix + (str(key),))
    elif tree is not None:
        yield "/".join(prefix), tree


def load_jax_params(model: nn.Module, tree: dict,
                    batch_stats: dict | None = None) -> None:
    """Copy ``tree`` (and ``batch_stats``) into ``model`` in place. Raises
    ValueError on a missing, extra or mis-shaped entry: a model with
    BatchNorms needs their statistics in one of the two trees."""
    targets = {}  # jax path -> (parameter or buffer, transpose?)
    for name, module in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(module, nn.Linear):
            targets[f"{path}/kernel"] = (module.weight, True)
            targets[f"{path}/bias"] = (module.bias, False)
        elif isinstance(module, (nn.LayerNorm, BatchNorm)):
            targets[f"{path}/scale"] = (module.weight, False)
            targets[f"{path}/bias"] = (module.bias, False)
        if isinstance(module, BatchNorm):
            targets[f"{path}/mean"] = (module.running_mean, False)
            targets[f"{path}/var"] = (module.running_var, False)
    flat = dict(_flatten(tree))
    if batch_stats is not None:
        stats = dict(_flatten(batch_stats))
        both = sorted(flat.keys() & stats.keys())
        if both:
            raise ValueError(f"entries in both trees: {both}")
        flat.update(stats)
    missing = sorted(targets.keys() - flat.keys())
    extra = sorted(flat.keys() - targets.keys())
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"extra {extra}")
    values = {}
    for path, (param, transpose) in targets.items():
        value = np.asarray(flat[path], dtype=np.float32)
        if transpose:
            value = value.T
        if value.shape != tuple(param.shape):
            raise ValueError(f"{path}: shape {value.shape} does not fit "
                             f"{tuple(param.shape)}")
        values[path] = value
    with torch.no_grad():
        for path, (param, _) in targets.items():
            param.copy_(torch.tensor(values[path]))
