"""The LayerNorm+ReLU pair of the shared MLPs (``kernels/layernorm.py``) on
the CPU: the plain versions against torch's own layer norm and ReLU, and
the routes ``SharedMLP`` takes.

The kernels themselves run only on the card (``test_torch_layernorm_cuda.py``);
here ``SharedMLP`` keeps its modules on every CPU tensor, and the tests that
check which pairs would go to the kernels stand in a recorder for the fused
call and say the tensor is on the card (``blocks._on_card``).

Tolerances: the plain backward is held to autograd in float64, within 1e-10
relative of each tensor's largest value (the two sum the rows' terms in
other orders); everything else is bitwise.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from pytorch_points_tpu_torch.kernels import _build, layernorm
from pytorch_points_tpu_torch.layers import blocks
from pytorch_points_tpu_torch.layers.blocks import LAYER_NORM_EPS, SharedMLP

ROWS = 37


def _rows(c, dtype=torch.float64, seed=0):
    """[ROWS, c] rows with a constant row (variance 0), a row of small
    spread (where eps matters) and a row whose middle element is its mean
    (x-hat exactly 0), and parameters around 1 and 0."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(ROWS, c, generator=g, dtype=dtype)
    x[0] = 0.75
    x[1] *= 1e-3
    if c >= 3:
        x[2, :3] = torch.tensor([-1.0, 0.0, 1.0], dtype=dtype)
        x[2, 3:] = 0.0
    w = 1 + 0.5 * torch.randn(c, generator=g, dtype=dtype)
    b = 0.5 * torch.randn(c, generator=g, dtype=dtype)
    da = torch.randn(ROWS, c, generator=g, dtype=dtype)
    return x, w, b, da


def _scale(t):
    return t.abs().max().clamp_min(1e-300)


@pytest.mark.parametrize("c", [64, 128, 48, 3])
def test_plain_backward_matches_autograd_float64(c):
    x, w, b, da = _rows(c)
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    a = torch.relu(F.layer_norm(xg, (c,), wg, bg, LAYER_NORM_EPS))
    ref = torch.autograd.grad(a, (xg, wg, bg), da)
    _, mean, rstd = layernorm.layer_norm_relu_torch(x, w, b, LAYER_NORM_EPS)
    got = layernorm.layer_norm_relu_backward_torch(da, x, mean, rstd, w, b)
    for g, r in zip(got, ref, strict=True):
        assert g.shape == r.shape
        assert ((g - r).abs().max() / _scale(r)).item() <= 1e-10


def test_plain_backward_passes_nan_as_torch_relu_does():
    """A NaN row: torch's ReLU backward passes the gradient where its
    output is NaN, so dbias keeps that row's da and every other gradient of
    the row is NaN, on both routes."""
    x, w, b, da = _rows(64)
    x[5, 7] = float("nan")
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    a = torch.relu(F.layer_norm(xg, (64,), wg, bg, LAYER_NORM_EPS))
    ref = torch.autograd.grad(a, (xg, wg, bg), da)
    _, mean, rstd = layernorm.layer_norm_relu_torch(x, w, b, LAYER_NORM_EPS)
    got = layernorm.layer_norm_relu_backward_torch(da, x, mean, rstd, w, b)
    for g, r in zip(got, ref, strict=True):
        assert torch.equal(g.isnan(), r.isnan())
    assert got[0][5].isnan().all() and not got[2].isnan().any()
    assert torch.allclose(got[2], ref[2], rtol=1e-12, atol=0)


def test_plain_forward_is_torch_layer_norm_and_relu():
    x, w, b, _ = (t.float() for t in _rows(128))
    a, mean, rstd = layernorm.layer_norm_relu_torch(x, w, b, LAYER_NORM_EPS)
    assert torch.equal(a, torch.relu(F.layer_norm(x, (128,), w, b,
                                                  LAYER_NORM_EPS)))
    var, mu = torch.var_mean(x.double(), -1, correction=0)
    assert mean.shape == rstd.shape == (ROWS,)
    assert torch.allclose(mean.double(), mu, rtol=0, atol=1e-6)
    assert torch.allclose(rstd.double(), (var + LAYER_NORM_EPS).rsqrt(),
                          rtol=1e-5, atol=0)


def test_entry_point_refuses_a_cpu_tensor():
    """The fused entry has no plain route of its own (``SharedMLP`` keeps
    its modules off the card): a CPU tensor raises before anything runs."""
    x, w, b, _ = (t.float() for t in _rows(64))
    f0 = layernorm.layer_norm_relu_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        layernorm.layer_norm_relu(x.requires_grad_(), w, b, LAYER_NORM_EPS)
    assert layernorm.layer_norm_relu_cuda.launches == f0


def test_module_imports_without_building_and_launchers_refuse_cpu():
    mod = layernorm  # imported above: its entry points bind, nothing built
    for entry in (mod._ppt_fwd, mod._ppt_bwd, mod._ppt_scratch_blocks_per_sm):
        assert entry.fn is None
    x, w, b, _ = (t.float() for t in _rows(64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mod.layer_norm_relu_cuda(x, w, b, LAYER_NORM_EPS)
    mean = rstd = torch.zeros(ROWS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mod.layer_norm_relu_backward_cuda(x, x, mean, rstd, w, b)
    assert mod.layer_norm_relu_cuda.launches == 0
    assert _build.library.cache_info().currsize == 0


def _mlp(act_last=True, **kw):
    return SharedMLP([5, 64, 128, 16], act_last=act_last, device="cpu",
                     generator=torch.Generator().manual_seed(3), **kw)


def _today(mlp, x):
    """SharedMLP's forward as the modules compute it, pair by pair."""
    n = len(mlp.layers)
    for i, (lin, nrm) in enumerate(zip(mlp.layers, mlp.norms)):
        x = lin(x)
        if i == n - 1 and not mlp.act_last:
            break
        x = mlp.activation(nrm(x))
    return x


def _run(mlp, fn, x):
    mlp.zero_grad(set_to_none=True)
    xg = x.clone().requires_grad_()
    out = fn(xg)
    out.float().square().sum().backward()
    return [out, xg.grad, *(p.grad for p in mlp.parameters())]


@pytest.mark.parametrize("act_last", [True, False])
def test_shared_mlp_on_cpu_is_the_modules_bitwise(act_last):
    mlp = _mlp(act_last)
    x = torch.randn(2, 40, 5, generator=torch.Generator().manual_seed(4))
    got = _run(mlp, mlp, x)
    ref = _run(mlp, lambda t: _today(mlp, t), x)
    for g, r in zip(got, ref, strict=True):
        assert torch.equal(g, r)


class _Recorder:
    """Stands in for the fused call: counts, then computes the pair as the
    modules do."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x, weight, bias, eps):
        self.calls += 1
        return torch.relu(F.layer_norm(x, (x.shape[-1],), weight, bias, eps))


@pytest.mark.parametrize("route,fused", [
    ("float32 LayerNorm, torch.relu", 3),
    ("float32 LayerNorm, F.relu", 3),
    ("bf16 policy", 0),
    ("BatchNorm", 0),
    ("gelu", 0),
    ("no norm", 0),
])
def test_routes_that_reach_the_fused_pair(monkeypatch, route, fused):
    kw = {"float32 LayerNorm, torch.relu": {},
          "float32 LayerNorm, F.relu": {"activation": F.relu},
          "bf16 policy": {"dtype": torch.bfloat16},
          "BatchNorm": {"norm": "batch"},
          "gelu": {"activation": F.gelu},
          "no norm": {"norm": None}}[route]
    mlp = _mlp(**kw)
    x = torch.randn(2, 40, 5, generator=torch.Generator().manual_seed(5))
    ref = _run(mlp, mlp, x)
    rec = _Recorder()
    monkeypatch.setattr(blocks, "_on_card", lambda t: True)
    monkeypatch.setattr(blocks, "layer_norm_relu", rec)
    got = _run(mlp, mlp, x)
    assert rec.calls == fused
    for g, r in zip(got, ref, strict=True):
        assert torch.equal(g, r)


@pytest.mark.parametrize("is_cuda,traced,on_card", [
    (True, False, True), (True, True, False), (False, False, False)])
def test_on_card_leaves_traced_programs_and_cpu_tensors(monkeypatch, is_cuda,
                                                        traced, on_card):
    monkeypatch.setattr(blocks.dispatch, "traced", lambda impl: traced)
    assert blocks._on_card(types.SimpleNamespace(is_cuda=is_cuda)) is on_card
