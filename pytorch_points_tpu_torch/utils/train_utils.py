"""Training utilities (counterpart of the JAX ``utils/train_utils.py``).

``save_network`` / ``load_network`` keep the reference's two-function
checkpoint API over ``torch.save``. Loading is tolerant: entries whose name
or shape doesn't match the target keep the target's value, with a warning,
unless ``strict=True``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from pytorch_points_tpu_torch.layers.blocks import trunc_normal_
from pytorch_points_tpu_torch.misc.logger import get_logger

log = get_logger(__name__)
CHECKPOINT_FILE = "checkpoint.pt"


def _flatten(tree, prefix=""):
    """(path, leaf) pairs of a nested dict / list / tuple, paths joined by
    "/" (a state_dict's keys are its paths)."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map(tree, fn, prefix=""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return type(tree)((k, _map(v, fn, f"{prefix}{k}/"))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _as_tree(state):
    return state.state_dict() if isinstance(state, nn.Module) else state


def _target_dir(path, step):
    path = os.path.abspath(str(path))
    return os.path.join(path, str(step)) if step is not None else path


def save_network(state, path, step: int | None = None, **extra):
    """Checkpoint ``state`` (a module, a state_dict or any nested dict /
    list of tensors) with ``torch.save`` of ``{"state": state, **extra}``
    into ``path``, or ``path/<step>/`` when ``step`` is given. Returns the
    checkpoint's directory."""
    target = _target_dir(path, step)
    os.makedirs(target, exist_ok=True)
    torch.save({"state": _as_tree(state), **extra},
               os.path.join(target, CHECKPOINT_FILE))
    log.info("saved checkpoint to %s", target)
    return target


def _shape(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def load_network(target_state, path, step: int | None = None, *,
                 strict: bool = False):
    """Restore a checkpoint into the structure of ``target_state`` (a
    module's state_dict when given a module).

    An entry whose path and shape match is restored, cast to the target's
    dtype and device; any other keeps the target's value, with a warning.
    ``strict=True`` raises ValueError on a shape mismatch and KeyError on a
    missing entry. Returns (restored_state, extra_dict); a module is not
    changed (``module.load_state_dict(restored_state)`` does that).
    """
    raw = torch.load(os.path.join(_target_dir(path, step), CHECKPOINT_FILE),
                     map_location="cpu", weights_only=True)
    flat = dict(_flatten(raw.get("state", raw)))
    extra = {k: v for k, v in raw.items() if k != "state"}

    def restore(key, val):
        if key not in flat:
            if strict:
                raise KeyError(f"missing checkpoint entry {key}")
            log.warning("missing checkpoint entry %s, keeping target value",
                        key)
            return val
        cand = flat[key]
        if _shape(cand) != _shape(val):
            msg = (f"shape mismatch at {key}: ckpt {_shape(cand)} vs "
                   f"{_shape(val)}")
            if strict:
                raise ValueError(msg)
            log.warning("%s, keeping target value", msg)
            return val
        if isinstance(val, torch.Tensor):
            return torch.as_tensor(cand).to(dtype=val.dtype,
                                            device=val.device)
        return cand

    return _map(_as_tree(target_state), restore), extra


def check_values(tree, name: str = "tensor") -> bool:
    """NaN/Inf guard: True if every tensor of ``tree`` (a module's
    parameters, a state_dict, a nested dict / list, or one tensor) is
    finite; logs the path of each one that is not."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    ok = True
    for path, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor) and not bool(
                torch.isfinite(leaf.detach()).all()):
            log.error("non-finite values in %s%s", name,
                      f"[{path}]" if path else "")
            ok = False
    return ok


def clamp_gradients(grads, max_norm: float = 1.0):
    """Global-norm gradient clipping: ``(grads * scale, norm)`` with norm
    the square root of the sum of every element's square and scale =
    min(1, max_norm / max(norm, 1e-12)), as the reference computes it
    (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6 instead).
    ``grads`` is a tensor or a nested dict / list of them; the result has
    its structure, and ``norm`` is a 0-d tensor on the grads' device (no
    host sync)."""
    leaves = [g for _, g in _flatten(grads)]
    norm = torch.sqrt(sum((g * g).sum() for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return _map(grads, lambda _, g: g * scale), norm


def linear_loss_weight(start_weight: float, end_weight: float,
                       start_step: int, end_step: int):
    """Linear loss-weight schedule: ``schedule(step) -> weight``, from
    ``start_weight`` at ``start_step`` to ``end_weight`` at ``end_step``,
    constant outside."""

    def schedule(step):
        t = min(max((step - start_step) / max(end_step - start_step, 1), 0),
                1)
        return start_weight + t * (end_weight - start_weight)

    return schedule


def step_lr_schedule(base_lr: float, decay_steps: int, gamma: float = 0.5,
                     min_lr: float = 0.0):
    """StepLR-style rate: lr = max(base_lr * gamma^(step // decay_steps),
    min_lr). ``schedule(step)`` returns the rate; ``LambdaLR`` multiplies
    the optimizer's rate by a factor, so drive an optimizer built with
    ``lr=base_lr`` by ``LambdaLR(opt, lambda s: sched(s) / base_lr)``."""

    def schedule(step):
        return max(base_lr * gamma ** (step // decay_steps), min_lr)

    return schedule


def warmup_cosine_lr_schedule(base_lr: float, total_steps: int,
                              warmup_steps: int = 0, min_lr: float = 0.0):
    """Linear warmup, then cosine decay to ``min_lr`` at ``total_steps``;
    ``schedule(step)`` returns the rate (drive an optimizer with it as
    :func:`step_lr_schedule` says)."""

    def schedule(step):
        if step < warmup_steps:
            return base_lr * min(step / max(warmup_steps, 1), 1.0)
        t = min(max((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0), 1)
        return min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * t))

    return schedule


# Truncated normal on [-2, 2]: its standard deviation is this fraction of
# the untruncated one (jax.nn.initializers.variance_scaling's correction).
_TRUNC_STD = 0.87962566103423978


def _draw(method: str, fan_in: int, fan_out: int, gen: torch.Generator):
    """One [fan_in, fan_out] kernel, the flax layout, drawn as
    ``jax.nn.initializers`` defines ``method``."""
    w = torch.empty((fan_in, fan_out), dtype=torch.float32)
    if method == "normal":
        return w.normal_(0.0, 0.02, generator=gen)
    scale, fan, dist = {
        "xavier_uniform": (1.0, (fan_in + fan_out) / 2, "uniform"),
        "xavier_normal": (1.0, (fan_in + fan_out) / 2, "truncated"),
        "kaiming_uniform": (2.0, fan_in, "uniform"),
        "kaiming_normal": (2.0, fan_in, "truncated"),
    }[method]
    variance = scale / fan
    if dist == "uniform":
        limit = math.sqrt(3.0 * variance)
        return w.uniform_(-limit, limit, generator=gen)
    return trunc_normal_(w, math.sqrt(variance) / _TRUNC_STD, gen)


def weights_init(model: nn.Module, method: str = "xavier_uniform",
                 seed: int = 0) -> nn.Module:
    """Re-initialize, in place, every ``nn.Linear`` weight of ``model``:
    the counterparts of the reference's >=2-D ``kernel`` leaves; biases
    and norm scales are left alone. Returns ``model``.

    Methods as in ``jax.nn.initializers``: xavier_uniform, xavier_normal
    (truncated normal), kaiming_uniform (he_uniform), kaiming_normal
    (he_normal, truncated), normal (std 0.02). Fans are those of the flax
    layout [in, out]: the weight is drawn so and stored transposed. The
    draws come from a CPU generator seeded with ``seed``.
    """
    if method not in ("xavier_uniform", "xavier_normal", "kaiming_uniform",
                      "kaiming_normal", "normal"):
        raise KeyError(method)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                out_f, in_f = module.weight.shape
                module.weight.copy_(_draw(method, in_f, out_f, gen).T)
    return model
