"""The LayerNorm+ReLU kernels (``csrc/layernorm.cu``) against their plain
versions, on the card.

Every test here needs a CUDA device: each carries the ``cuda`` marker and
skips without one. The file imports no JAX; from the repository root on the
card:

    python -m pytest --noconftest -q tests/test_torch_layernorm_cuda.py

The shapes are every (rows, C) the benchmark's first three cells
normalise, the MSG part segmenter's widths (C = 32, 96 and 196 among them),
then ragged row counts and channel counts that take the wide or the generic
instance.

At every shape the forward is bitwise the plain version on the card,
torch's own layer norm: the kernel takes a row's statistics in the Welford
order of the torch kernel that takes the row (its vectorized kernel on
aligned rows of C a multiple of 4, else its row-moments kernel). The
backward sums in its own order. So beside that, the reference is
the plain version in float64 on the same float32 inputs, and the kernels
are held to float32 rounding of it, each tolerance from the sums it rounds
(u = 2^-24; C <= 4100, so a sum's tree is at most 13 levels deep):

* mean within 4e-6 of the row's largest |x| (64 u against about 11 u);
* rstd within 1e-5 relative (a variance within a few u, rsqrtf 2 ulp);
* a within 1e-5 (1 + |z| + |gamma| k), k = 1 + rstd max|x| over the row,
  x-hat's condition (a rounding of x or of the mean moves x-hat by about
  u k; a row far from 0 against its spread has a large k);
* dx within 1e-5 k rstd max|g| (1 + max|x-hat|^2) over each row (the two
  row sums s1 and s2 enter as s1 / C and x-hat s2 / C);
* dgamma, dbeta within 1e-5 of the sum of the terms' magnitudes.

Where the reference's z lies within 1e-4 of 0 (and is not exactly 0, which
both compute exactly), a rounding of z may fall on the other side of 0
than float64 puts it, and the ReLU's mask then differs for reasons of
rounding alone: those rows' da is set to 0 before the backward is compared,
and the masks are compared only outside them. The backward's own mask is
held bitwise to the forward's a > 0 through dbeta with integer da, which the
kernels sum exactly in float32.
"""

import pytest
import torch

from pytorch_points_tpu_torch.kernels import layernorm
from pytorch_points_tpu_torch.layers import blocks
from pytorch_points_tpu_torch.layers.blocks import (
    LAYER_NORM_EPS,
    SharedMLP,
    remat_call,
)

pytestmark = pytest.mark.cuda

EPS = LAYER_NORM_EPS
# (rows, C) of every LayerNorm in the three cells: pn2_ae at B=32, N=2048
# and N=16384 (SA1, SA2, SA3, FP3, FP2, FP1, head), pu_3pu's expand and head
CELL_SHAPES = [(524288, 64), (524288, 128), (131072, 128), (131072, 256),
               (4096, 256), (4096, 512), (4096, 1024), (16384, 256),
               (16384, 128), (65536, 128), (65536, 64), (262144, 128),
               (262144, 64)]
# the MSG part segmenter's (pn2_partseg_msg at B=32, N=2048) that the shapes
# above leave out: SA1's three scales (32, 64 and 128 neighbours of 512
# centroids), SA2's second (128 of 128)
MSG_SHAPES = [(524288, 32), (1048576, 64), (2097152, 64), (2097152, 96),
              (2097152, 128), (524288, 196), (524288, 256)]
# ragged row counts, and C the register instances do not take: the wide
# forward (a multiple of 4, held in registers to 512, read twice past it)
# and the generic one (any other C)
RAGGED_SHAPES = [(1, 64), (3, 128), (1001, 64), (777, 256), (129, 1024),
                 (33, 512), (5, 96), (1000, 100), (37, 3), (300, 2048),
                 (1000, 150), (513, 6), (200, 516), (100, 4100), (50, 1537)]
NEAR = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, rows, c, seed=0):
    """x [rows, c] float32 with a constant row (variance 0, x-hat exactly
    0), rows of small spread (eps matters) and rows scaled up and shifted;
    gamma around 1, beta around 0, with beta[0] = 0 (z exactly 0 where
    x-hat is) and channel 1's gamma and beta 0 (z exactly 0 in every
    row)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, c, generator=g, device=dev)
    x[3::11] = 50.0 * x[3::11] + 3.0
    x[0::7] *= 1e-3
    x[0] = 0.75
    w = 1 + 0.5 * torch.randn(c, generator=g, device=dev)
    b = 0.5 * torch.randn(c, generator=g, device=dev)
    b[0] = 0.0
    if c >= 2:
        w[1] = b[1] = 0.0
    da = torch.randn(rows, c, generator=g, device=dev)
    return x, w, b, da


def _forward64(x, w, b):
    """The plain forward in float64: (z, a, mean, rstd, x-hat)."""
    x, w, b = (t.double() for t in (x, w, b))
    a, mean, rstd = layernorm.layer_norm_relu_torch(x, w, b, EPS)
    t = (x - mean[:, None]) * rstd[:, None]
    return t * w + b, a, mean, rstd, t


@pytest.mark.parametrize("rows,c", CELL_SHAPES + MSG_SHAPES + RAGGED_SHAPES)
def test_layer_norm_relu_matches_plain(dev, rows, c):
    x, w, b, da = _inputs(dev, rows, c)
    z, a64, mu64, rs64, t64 = _forward64(x, w, b)
    x64 = x.double()
    # x-hat's condition: a rounding of x or of the mean moves x-hat by
    # about u max|x| rstd
    cond = (1 + rs64 * x64.abs().amax(1))[:, None]
    near = (z.abs() < NEAR) & (z != 0)
    near_rows = near.any(1)
    da[near_rows] = 0.0
    w64, b64, da64 = (t.double() for t in (w, b, da))
    dx64, dw64, db64 = layernorm.layer_norm_relu_backward_torch(
        da64, x64, mu64, rs64, w64, b64)
    dz = torch.where(z <= 0, 0.0, da64)
    a, mean, rstd = layernorm.layer_norm_relu_cuda(x, w, b, EPS)
    dx, dw, db = layernorm.layer_norm_relu_backward_cuda(da, x, mean, rstd,
                                                         w, b)
    torch.cuda.synchronize()
    xmax = x64.abs().amax(1)
    assert ((mean.double() - mu64).abs() <= 4e-6 * xmax).all()
    assert ((rstd.double() / rs64 - 1).abs() <= 1e-5).all()
    assert ((a.double() - a64).abs()
            <= 1e-5 * (1 + z.abs() + w64.abs() * cond)).all()
    assert torch.equal((a > 0)[~near], (a64 > 0)[~near])
    row_scale = (rs64 * (dz * w64).abs().amax(1)
                 * (1 + t64.square().amax(1)) * cond[:, 0])
    assert ((dx.double() - dx64).abs().amax(1) <= 1e-5 * row_scale).all()
    assert ((dw.double() - dw64).abs()
            <= 1e-5 * (dz * t64).abs().sum(0)).all()
    assert ((db.double() - db64).abs() <= 1e-5 * dz.abs().sum(0)).all()
    # the rows left out of the backward's comparison are few (at C = 2048
    # about 1 in 7 holds a z within 1e-4 of 0)
    assert near_rows.sum().item() <= 1 + 0.3 * rows
    for got, ref in zip((a, mean, rstd),  # torch's forward bitwise
                        layernorm.layer_norm_relu_torch(x, w, b, EPS),
                        strict=True):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("rows,c", [(524288, 64), (131072, 256),
                                    (4096, 1024), (1001, 64), (1000, 100),
                                    (524288, 32), (524288, 96),
                                    (524288, 196)])
def test_backward_mask_is_the_forwards_bitwise(dev, rows, c):
    """dbeta = sum over rows of da where a > 0: with integer da (1, then
    random 1..16) and at most 2^20 rows every partial sum is an integer of
    at most 2^24, exact in float32 in any order, so dbeta equals the count
    taken from the forward's a only if the backward's mask is the forward's
    element by element (a differing element moves its channel's sum by its
    da)."""
    x, w, b, _ = _inputs(dev, rows, c, seed=1)
    a, mean, rstd = layernorm.layer_norm_relu_cuda(x, w, b, EPS)
    g = torch.Generator(device=dev).manual_seed(2)
    for da in (torch.ones_like(x),
               torch.randint(1, 17, x.shape, generator=g, device=dev).float()):
        _, _, db = layernorm.layer_norm_relu_backward_cuda(da, x, mean, rstd,
                                                           w, b)
        want = torch.where(a > 0, da, 0.0).double().sum(0)
        assert torch.equal(db.double(), want)


@pytest.mark.parametrize("rows,c", [(1001, 64), (777, 256), (5, 96),
                                    (1001, 32), (333, 196)])
def test_nan_row_propagates_as_torch(dev, rows, c):
    """A NaN in a row: its a and dx are NaN, as torch's layer norm and ReLU
    give; its da still enters dbeta (torch's ReLU backward passes a NaN
    output's gradient) and makes dgamma NaN, on both routes."""
    x, w, b, da = _inputs(dev, rows, c, seed=3)
    x[rows // 2, c // 3] = float("nan")
    a, mean, rstd = layernorm.layer_norm_relu_cuda(x, w, b, EPS)
    dx, dw, db = layernorm.layer_norm_relu_backward_cuda(da, x, mean, rstd,
                                                         w, b)
    pa, pmean, prstd = layernorm.layer_norm_relu_torch(x, w, b, EPS)
    pdx, pdw, pdb = layernorm.layer_norm_relu_backward_torch(da, x, pmean,
                                                             prstd, w, b)
    for got, ref in ((a, pa), (mean, pmean), (rstd, prstd), (dx, pdx),
                     (dw, pdw), (db, pdb)):
        assert torch.equal(got.isnan(), ref.isnan())
    assert a[rows // 2].isnan().all() and dw.isnan().all()
    assert not db.isnan().any()
    assert torch.allclose(db, pdb, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,c", [(524288, 64), (131072, 256),
                                    (4096, 1024), (1000, 100), (524288, 32),
                                    (2097152, 96), (524288, 196)])
def test_two_runs_bitwise_equal(dev, rows, c):
    x, w, b, da = _inputs(dev, rows, c, seed=4)

    def run():
        a, mean, rstd = layernorm.layer_norm_relu_cuda(x, w, b, EPS)
        return (a, mean, rstd, *layernorm.layer_norm_relu_backward_cuda(
            da, x, mean, rstd, w, b))

    for first, second in zip(run(), run(), strict=True):
        assert torch.equal(first, second)


@pytest.mark.parametrize("c", [64, 196])
def test_unaligned_rows_take_the_generic_instance(dev, c):
    """Rows that start off a 16-byte boundary go to the generic instance,
    which is bitwise torch's layer norm on those rows (its row-moments
    kernel takes them too) and gives the fast instance's result to
    rounding."""
    x, w, b, da = _inputs(dev, 1001, c, seed=5)
    buf = torch.empty(x.numel() + 1, device=dev)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    fast = layernorm.layer_norm_relu_cuda(x, w, b, EPS)
    slow = layernorm.layer_norm_relu_cuda(xs, w, b, EPS)
    plain = layernorm.layer_norm_relu_torch(xs, w, b, EPS)
    for f, s, p in zip(fast, slow, plain, strict=True):
        assert torch.equal(s, p)
        assert torch.allclose(f, s, rtol=1e-5, atol=1e-5)


def test_launch_counters_move_once_a_call(dev):
    x, w, b, da = _inputs(dev, 1001, 128, seed=6)
    f0 = layernorm.layer_norm_relu_cuda.launches
    b0 = layernorm.layer_norm_relu_backward_cuda.launches
    xg = x.clone().requires_grad_()
    out = layernorm.layer_norm_relu(xg, w, b, EPS)
    assert layernorm.layer_norm_relu_cuda.launches == f0 + 1
    assert layernorm.layer_norm_relu_backward_cuda.launches == b0
    out.backward(da)
    assert layernorm.layer_norm_relu_cuda.launches == f0 + 1
    assert layernorm.layer_norm_relu_backward_cuda.launches == b0 + 1


class _Pair(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(w.clone())
        self.bias = torch.nn.Parameter(b.clone())

    def forward(self, x):
        return layernorm.layer_norm_relu(x, self.weight, self.bias, EPS)


def test_remat_gives_the_same_result(dev):
    """Under ``remat_call`` (non-reentrant checkpoint) the forward runs
    again in the backward: the same bits, so the same gradients."""
    x, w, b, da = _inputs(dev, 65536, 128, seed=7)
    grads = []
    for remat in (False, True):
        pair = _Pair(w, b)
        xg = x.clone().requires_grad_()
        f0 = layernorm.layer_norm_relu_cuda.launches
        out = remat_call(pair, remat, xg)
        out.backward(da)
        assert layernorm.layer_norm_relu_cuda.launches == f0 + 1 + remat
        grads.append((out.detach(), xg.grad, pair.weight.grad,
                      pair.bias.grad))
    for plain, rematted in zip(*grads, strict=True):
        assert torch.equal(plain, rematted)


def test_shared_mlp_takes_the_kernels_and_matches_its_modules(dev,
                                                              monkeypatch):
    """A float32 LayerNorm + ReLU SharedMLP on the card: one forward and
    one backward launch a norm, and the modules' result to rounding."""
    gen = torch.Generator().manual_seed(8)
    mlp = SharedMLP([3, 64, 128, 256], device=dev, generator=gen)
    x = torch.randn(8, 512, 3, device=dev)
    results = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(blocks, "_on_card", lambda t: False)
        mlp.zero_grad(set_to_none=True)
        f0 = layernorm.layer_norm_relu_cuda.launches
        b0 = layernorm.layer_norm_relu_backward_cuda.launches
        out = mlp(x)
        out.square().sum().backward()
        assert layernorm.layer_norm_relu_cuda.launches - f0 == 3 * fused
        assert layernorm.layer_norm_relu_backward_cuda.launches - b0 == (
            3 * fused)
        results.append([out.detach(), *(p.grad for p in mlp.parameters())])
    for got, ref in zip(*results, strict=True):
        scale = ref.abs().max().clamp_min(1e-30)
        assert ((got - ref).abs().max() / scale).item() <= 1e-4
