"""LayerNorm over the last axis followed by ReLU, forward and backward.

CUDA kernels: ``csrc/layernorm.cu``, which replace no TPU kernel (the JAX
package leaves the shared MLPs' norm and ReLU to XLA, which fuses them).
On the card they take the place of torch's layer norm, its grad-input and
gamma/beta kernels and the ReLU's elementwise passes, for the float32
``LayerNorm`` + ``torch.relu`` pairs of ``layers.blocks.SharedMLP``: one
forward launch and one backward call (two launches: the rows, then the
parameter gradients' fixed-order sum) a pair. The header note there says
what bounds them on the card.

The plain versions compute the same function: the forward is torch's own
layer norm (``torch.native_layer_norm``, which also gives the statistics)
and ReLU, the backward the kernel's formula written out. The forward
kernel is bitwise the plain forward on the card at every C: it sums a
row's statistics in the order of the torch kernel that takes the row (on
16-byte aligned rows of C a multiple of 4, torch's vectorized kernel:
register instances at C = 32, 64, 96, 128, 256, 512 and 1024, a warp a row
at the others; on any other row, torch's row-moments kernel). The backward
matches to float32 rounding; its mask is the forward's ``a > 0`` bitwise,
and two runs are bitwise equal.
"""

from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from pytorch_points_tpu_torch.kernels import _build

_ppt_fwd = _build.entry("ppt_layer_norm_relu_fwd")
_ppt_bwd = _build.entry("ppt_layer_norm_relu_bwd")
_ppt_scratch_blocks_per_sm = _build.entry(
    "ppt_layer_norm_relu_scratch_blocks_per_sm")


def layer_norm_relu_torch(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float):
    """Plain version: [R,C] rows -> (relu(layer_norm(x)) [R,C], mean [R],
    rstd [R]), torch's layer norm over the last axis."""
    z, mean, rstd = torch.native_layer_norm(x, (x.shape[-1],), weight, bias,
                                            eps)
    return torch.relu(z), mean.reshape(-1), rstd.reshape(-1)


def layer_norm_relu_backward_torch(da: torch.Tensor, x: torch.Tensor,
                                   mean: torch.Tensor, rstd: torch.Tensor,
                                   weight: torch.Tensor, bias: torch.Tensor):
    """Plain backward, the kernel's formula: with x-hat = (x - mean) rstd
    and z = x-hat weight + bias, dz = da where not z <= 0 (torch's ReLU
    backward), g = dz weight, dx = rstd / C ((C g - x-hat sum(g x-hat)) -
    sum(g)) over each row; dweight = sum over rows of dz x-hat, dbias of
    dz. Returns (dx [R,C], dweight [C], dbias [C])."""
    c = x.shape[-1]
    t = (x - mean[:, None]) * rstd[:, None]
    dz = torch.where(t * weight + bias <= 0, 0.0, da)
    g = dz * weight
    s1 = g.sum(-1, keepdim=True)
    s2 = (g * t).sum(-1, keepdim=True)
    dx = (c * g - t * s2 - s1) * (rstd[:, None] / c)
    return dx, (dz * t).sum(0), dz.sum(0)


@functools.cache
def _scratch_blocks(device_index: int) -> int:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * _ppt_scratch_blocks_per_sm()


def layer_norm_relu_cuda(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float):
    """Launch the forward kernel: same contract as
    :func:`layer_norm_relu_torch` for float32 [R,C] rows, bitwise on the
    card."""
    rows, c = x.shape
    _build.require(x, "layer_norm_relu x", torch.float32, (rows, c))
    _build.require(weight, "layer_norm_relu weight", torch.float32, (c,))
    _build.require(bias, "layer_norm_relu bias", torch.float32, (c,))
    a = torch.empty_like(x)
    mean = x.new_empty(rows)
    rstd = x.new_empty(rows)
    err = _ppt_fwd(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), rows, c,
                   eps, a.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                   _build.stream(x))
    _build.check(err, _ppt_fwd.name)
    layer_norm_relu_cuda.launches += 1
    return a, mean, rstd


def layer_norm_relu_backward_cuda(da: torch.Tensor, x: torch.Tensor,
                                  mean: torch.Tensor, rstd: torch.Tensor,
                                  weight: torch.Tensor, bias: torch.Tensor):
    """Launch the backward: same contract as
    :func:`layer_norm_relu_backward_torch`, to rounding, on the forward's
    mean and rstd."""
    rows, c = x.shape
    for t, name in ((da, "da"), (x, "x")):
        _build.require(t, f"layer_norm_relu {name}", torch.float32, (rows, c))
    for t, name in ((mean, "mean"), (rstd, "rstd")):
        _build.require(t, f"layer_norm_relu {name}", torch.float32, (rows,))
    for t, name in ((weight, "weight"), (bias, "bias")):
        _build.require(t, f"layer_norm_relu {name}", torch.float32, (c,))
    blocks = _scratch_blocks(x.get_device())
    scratch = x.new_empty((blocks, 2, c))
    dx = torch.empty_like(x)
    dweight = x.new_empty(c)
    dbias = x.new_empty(c)
    err = _ppt_bwd(da.data_ptr(), x.data_ptr(), mean.data_ptr(),
                   rstd.data_ptr(), weight.data_ptr(), bias.data_ptr(), rows,
                   c, scratch.data_ptr(), blocks, dx.data_ptr(),
                   dweight.data_ptr(), dbias.data_ptr(), _build.stream(x))
    _build.check(err, _ppt_bwd.name)
    layer_norm_relu_backward_cuda.launches += 1
    return dx, dweight, dbias


layer_norm_relu_cuda.launches = 0
layer_norm_relu_backward_cuda.launches = 0


class _LayerNormReLU(torch.autograd.Function):
    """relu(layer_norm(x)) over the last axis on the kernels; saves x and
    the row statistics, and recomputes x-hat and the mask in the
    backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        shape = x.shape
        rows = x.reshape(-1, shape[-1]).contiguous()
        weight, bias = weight.contiguous(), bias.contiguous()
        a, mean, rstd = layer_norm_relu_cuda(rows, weight, bias, eps)
        ctx.save_for_backward(rows, mean, rstd, weight, bias)
        ctx.shape = shape
        return a.reshape(shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, da):
        rows, mean, rstd, weight, bias = ctx.saved_tensors
        dx, dweight, dbias = layer_norm_relu_backward_cuda(
            da.reshape(rows.shape).contiguous(), rows, mean, rstd, weight,
            bias)
        need = ctx.needs_input_grad
        return (dx.reshape(ctx.shape) if need[0] else None,
                dweight if need[1] else None, dbias if need[2] else None,
                None)


def layer_norm_relu(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float):
    """relu(layer_norm(x)) over the last axis of float32 [..., C] on the
    kernels, with autograd. It takes no ``impl``: its caller
    (``SharedMLP``) has already chosen this route, and a CPU tensor
    raises."""
    return _LayerNormReLU.apply(x, weight, bias, eps)
