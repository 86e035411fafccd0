"""Ahead-of-time model export for serving (counterpart of the JAX
``utils/export.py``), with ``torch.export``.

    blob = export_forward(model, example_input)   # an nn.Module's forward
    blob = export_fn(fn, example_args)            # any traceable function
    restored = load_exported(blob_or_path)
    y = restored(x)

The program is traced at the example's static shapes and device, with the
weights saved in the artifact. Unlike the reference's self-contained
StableHLO blob, the program records the port's kernels as ``ppt::*``
custom ops (K1 FPS, K2 ball query and its coordinate instance, K3 gather,
K8 kNN, K5 dense NN): the serving host must have ``pytorch_points_tpu_torch``
installed and imported (this module imports it), and runs the kernels on
a CUDA program and their plain versions on a CPU one.
"""

from __future__ import annotations

import io
import os

import torch

import pytorch_points_tpu_torch.ops  # noqa: F401  (registers ppt::*)


class _Function(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _save(exported, path) -> bytes:
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_fn(fn, example_args, *, path=None, platforms=None) -> bytes:
    """Serialize ``fn`` at the example arguments' shapes, dtypes and
    device.

    Args:
      fn: a callable that torch.export can trace; closed-over tensors
        (weights) become constants of the program.
      example_args: a tensor or a tuple of tensors fixing the signature.
      path: optional file to write the artifact to.
      platforms: the reference's cross-platform lowering; a torch program
        runs on the device it was traced on, so only None is accepted.

    Returns:
      The serialized artifact bytes.
    """
    if platforms is not None:
        raise NotImplementedError(
            "platforms: a torch.export program runs on the device of its "
            "example arguments")
    if not isinstance(example_args, (tuple, list)):
        example_args = (example_args,)
    exported = torch.export.export(_Function(fn), tuple(example_args))
    return _save(exported, path)


def export_forward(model: torch.nn.Module, example_input, *, path=None,
                   platforms=None) -> bytes:
    """Serialize ``model(example_input)`` with its parameters and buffers
    saved in the artifact (``model.eval()`` first for a serving forward)."""
    if platforms is not None:
        raise NotImplementedError(
            "platforms: a torch.export program runs on the device of its "
            "example arguments")
    exported = torch.export.export(model, (example_input,))
    return _save(exported, path)


def load_exported(blob_or_path):
    """Deserialize an exported artifact; returns a callable module.

    Accepts the bytes :func:`export_fn` / :func:`export_forward` return, or
    a filesystem path to them.
    """
    if isinstance(blob_or_path, (str, os.PathLike)):
        exported = torch.export.load(blob_or_path)
    else:
        exported = torch.export.load(io.BytesIO(bytes(blob_or_path)))
    return exported.module()
