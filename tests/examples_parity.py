"""Shared pieces of the example parity tests (``test_torch_examples*.py``):
loading an example by its file, carrying a JAX example's initial weights
into the port example's model, and the JAX model holding a port model's
parameters."""

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
from flax import nnx

from pytorch_points_tpu_torch.compat import load_jax_params

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("train_on_ply_dataset", "train_autoencoder", "export_and_serve",
         "upsample_cloud", "render_cloud", "deform_with_cage")


def load(folder: str, name: str):
    """``folder/name.py`` as a module named ``folder_name``: the examples
    of both packages share their file names."""
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Carried:
    """The JAX example's model, recorded, and its initial parameters handed
    to the port example's model."""

    def __init__(self):
        self.model = self.params = None

    def jax_ctor(self, cls, jit_call=False):
        def build(*args, rngs, **kwargs):
            # every example seeds nnx.Rngs(0)
            model = nnx.jit(lambda: cls(*args, rngs=nnx.Rngs(0), **kwargs))()
            self.model = model
            self.params = jax.tree.map(
                np.asarray, nnx.to_pure_dict(nnx.state(model, nnx.Param)))
            if not jit_call:
                return model
            forward = nnx.jit(lambda m, x: m(x))
            return lambda x: forward(model, x)

        return build

    def port_ctor(self, cls):
        def build(*args, **kwargs):
            model = cls(*args, **kwargs)
            load_jax_params(model, self.params)
            return model

        return build


def one_device(mp):
    """The JAX examples' device count, as the port's: one device."""
    devices = jax.devices()[:1]
    mp.setattr(jax, "devices", lambda *a, **k: devices)
    mp.setattr(jax, "device_count", lambda *a, **k: 1)


def recorder(sink, jitted):
    """``record(loss) -> loss``, appending the loss's value to ``sink``
    (inside a JAX jit through ``jax.debug.callback``, on each call)."""
    def record(loss):
        if jitted:
            jax.debug.callback(lambda v: sink.append(float(v)), loss)
        else:
            sink.append(loss.item())
        return loss

    return record


def run_main(mp, module, argv):
    mp.setattr(sys, "argv", ["x", *argv])
    return module.main()


def same_params(model, params):
    """``model`` (the JAX one) holding the port model's ``params``."""
    state = nnx.state(model, nnx.Param)
    nnx.replace_by_pure_dict(
        state, jax_tree(params, nnx.to_pure_dict(state)))
    nnx.update(model, state)
    return model


def jax_tree(params, template, prefix=""):
    """The port model's parameters as the JAX model's pure dict (the
    inverse of ``load_jax_params``: a Linear's weight transposed to its
    kernel, a LayerNorm's weight to its scale)."""
    tree = {}
    for key, value in template.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            tree[key] = jax_tree(params, value, path + ".")
        elif key == "kernel":
            tree[key] = params[f"{prefix}weight"].numpy().T
        elif key == "scale":
            tree[key] = params[f"{prefix}weight"].numpy()
        else:
            tree[key] = params[path].numpy()
    return tree
