"""Basic blocks (counterpart of the JAX ``layers/blocks.py``): the shared
MLP, and the Linear, LayerNorm and BatchNorm it is built of, each computing
as its flax counterpart does, in float32 or under the bf16 policy
(``dtype=torch.bfloat16``, ``core/dtypes.py``)."""

from __future__ import annotations

import contextlib
import math
from collections.abc import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pytorch_points_tpu_torch.kernels import dispatch
from pytorch_points_tpu_torch.kernels.layernorm import layer_norm_relu

# flax's LayerNorm default (nnx.LayerNorm epsilon); torch's is 1e-5.
LAYER_NORM_EPS = 1e-6
# flax's BatchNorm defaults as the reference builds it: epsilon 1e-5,
# momentum 0.9 (the running statistics keep 0.9 of themselves).
BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.9


class Linear(nn.Linear):
    """``nn.Linear`` computing as flax's ``nnx.Linear(dtype=...)``: with a
    ``dtype``, the input, weight and bias are rounded to it, the product
    is rounded to it, then the bias is added (and rounded). The weight and
    bias stay float32 parameters."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype | None = None,
                 device=None):
        super().__init__(cin, cout, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d)) + self.bias.to(d)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last axis (flax's eps 1e-6). With a
    ``dtype``, as flax's: the scale and bias rounded to it, the statistics
    and arithmetic in float32 (torch's fused layer norm on the float32
    input), one rounding to ``dtype`` at the end."""

    def __init__(self, c: int, dtype: torch.dtype | None = None):
        super().__init__(c, eps=LAYER_NORM_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        d = self.compute_dtype
        f32 = torch.float32
        return F.layer_norm(x.to(f32), self.normalized_shape,
                            self.weight.to(d).to(f32),
                            self.bias.to(d).to(f32), self.eps).to(d)


class BatchNorm(nn.Module):
    """flax's ``nnx.BatchNorm`` over the last axis (not torch's BatchNorm):
    in training mode the statistics are taken over every other axis, the
    variance the biased "fast" one, max(0, E[x^2] - E[x]^2), and the
    running statistics updated with it, ``r = 0.9 r + 0.1 batch``; in eval
    mode (``.eval()``, flax's ``use_running_average``) the running ones
    are used. y = (x - mean) (rsqrt(var + eps) scale) + bias, eps 1e-5.

    With a ``dtype``, as flax's ``promote_dtype``: in training mode the
    statistics and arithmetic are float32 and the result is rounded once;
    in eval mode the running statistics, scale and bias are rounded to
    ``dtype`` and the arithmetic runs in it.

    ``weight``/``bias`` are the flax ``scale``/``bias`` Params;
    ``running_mean``/``running_var`` buffers its ``mean``/``var``
    BatchStats. ``update_stats`` False computes a training-mode forward
    without touching the running statistics (a rematerialised forward's
    recompute, which under nnx does not update them a second time)."""

    def __init__(self, c: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = BATCH_NORM_EPS
        self.momentum = BATCH_NORM_MOMENTUM
        self.compute_dtype = dtype
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        if not self.training:
            mean, var = self.running_mean, self.running_var
            scale, bias = self.weight, self.bias
            if d is not None:
                x, mean, var, scale, bias = (t.to(d) for t in (
                    x, mean, var, scale, bias))
            return (x - mean) * (torch.rsqrt(var + self.eps) * scale) + bias
        xf = x.to(torch.float32)
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dims)
        var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        scale, bias = self.weight, self.bias
        if d is not None:
            scale, bias = scale.to(d), bias.to(d)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * scale) + bias
        return y if d is None else y.to(d)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the context, ``module``'s BatchNorms compute their batch
    statistics without updating their running ones (a checkpoint's
    recompute)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(norms, saved):
            m.update_stats = flag


def remat_call(fn: Callable, remat: bool, *args,
               frozen: nn.Module | None = None, **kwargs):
    """``fn(*args, **kwargs)``, checkpointed (``torch.utils.checkpoint``,
    non-reentrant) when ``remat`` and grad is enabled, as the reference's
    ``nnx.remat``: the activations are recomputed in the backward. The
    recompute runs under :func:`frozen_running_stats` of ``frozen`` (``fn``
    itself when None), so a step updates BatchNorm's running statistics
    once."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args, **kwargs)
    frozen = fn if frozen is None else frozen
    return checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            frozen_running_stats(frozen)),
        **kwargs)


def trunc_normal_(tensor: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``tensor`` in place with a normal of mean 0 and ``std``
    truncated at 2 ``std``, by the inverse CDF of uniform draws from
    ``generator``: the values depend on the seed alone, whatever the torch
    version (``nn.init.trunc_normal_`` draws by inverse CDF up to torch
    2.12 and by rejection after, so a seed gave other weights there)."""
    bound = math.erf(2.0 / math.sqrt(2.0))  # 2 Phi(2) - 1
    with torch.no_grad():
        tensor.uniform_(-bound, bound, generator=generator)
        tensor.erfinv_()
        tensor.mul_(std * math.sqrt(2.0))
        return tensor.clamp_(min=-2.0 * std, max=2.0 * std)


def _linear(cin: int, cout: int, generator: torch.Generator,
            dtype: torch.dtype | None = None) -> Linear:
    """:class:`Linear` with flax's initialisation: lecun-normal weight (a
    normal truncated at 2 std, rescaled to unit variance per fan-in), zero
    bias. Drawn from ``generator`` on the CPU (:func:`trunc_normal_`), so
    a seed gives the same weights on every device and torch version."""
    lin = nn.utils.skip_init(Linear, cin, cout, dtype)
    std = math.sqrt(1.0 / cin) / 0.87962566103423978
    with torch.no_grad():
        trunc_normal_(lin.weight, std, generator)
        lin.bias.zero_()
    return lin


class SharedMLP(nn.Module):
    """Pointwise MLP over the last axis of [..., C] tensors.

    ``layers`` and ``norms`` are ``nn.ModuleList``s with ``nn.Identity``
    where the JAX list holds None, so module paths map one to one onto the
    JAX parameter tree.

    norm: None | "layer" (LayerNorm, eps 1e-6 as in flax) | "batch"
    (flax's BatchNorm, :class:`BatchNorm`: the reference's Conv+BN blocks;
    ``.train()``/``.eval()`` choose batch or running statistics).

    dtype: the computation dtype, None (float32) or ``torch.bfloat16``
    (the bf16 policy, ``core/dtypes.py``): every matmul and norm computes
    as flax's do at that dtype; parameters stay float32, and the output is
    in ``dtype``.

    Weights are drawn from ``generator`` (seed 0 when None) on the CPU, then
    moved to ``device``, the card unless the caller names another device;
    without a card the default raises, as ``.to("cuda")`` does.
    """

    def __init__(self, channels: Sequence[int], *,
                 activation: Callable = torch.relu,
                 norm: str | None = "layer", act_last: bool = True,
                 dtype: torch.dtype | None = None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(channels) < 2:
            raise ValueError("channels must include input and output dims")
        if norm not in (None, "layer", "batch"):
            raise ValueError(f"unknown norm {norm!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.activation = activation
        self.act_last = act_last
        layers, norms = [], []
        for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            layers.append(_linear(cin, cout, generator, dtype))
            is_last = i == len(channels) - 2
            if norm is not None and (act_last or not is_last):
                norms.append(LayerNorm(cout, dtype) if norm == "layer"
                             else BatchNorm(cout, dtype))
            else:
                norms.append(nn.Identity())
        self.layers = nn.ModuleList(layers)
        self.norms = nn.ModuleList(norms)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, (lin, nrm) in enumerate(zip(self.layers, self.norms)):
            x = lin(x)
            if i == n - 1 and not self.act_last:
                break
            if self._fuses(nrm, x):
                x = layer_norm_relu(x, nrm.weight, nrm.bias, nrm.eps)
            else:
                x = self.activation(nrm(x))
        return x

    def _fuses(self, nrm: nn.Module, x: torch.Tensor) -> bool:
        """Whether ``activation(nrm(x))`` runs as one LayerNorm+ReLU pair
        on the kernels (``kernels/layernorm.py``): a float32 LayerNorm and
        ReLU on a CUDA tensor, outside a torch trace. The bf16 policy,
        BatchNorm, other activations, CPU tensors and traced programs take
        the modules themselves."""
        return (isinstance(nrm, LayerNorm) and nrm.compute_dtype is None
                and self.activation in _RELUS and _on_card(x)
                and x.dtype == torch.float32)


_RELUS = (torch.relu, F.relu)


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda and not dispatch.traced("auto")
