"""The port's PointUpsampler, RepulsionLoss and UniformLoss against the JAX
package.

Weights come from the JAX model through ``load_jax_params``; inputs from
numpy with a seed. The JAX side runs its Pallas kernels in interpret mode
(``force_impl("pallas")``), jitted whole; the port runs its plain PyTorch
versions on the CPU. The model's loss is config 7's Chamfer plus 0.1
repulsion at h = 0.3: at the default h = 0.03 the repulsion of a random
model's 512 points (neighbours 0.15-0.28 apart) is ~1e-5 of the Chamfer
and its gradient would go unseen.

Tolerances: outputs atol 1e-4; losses rtol 1e-5; gradients within
GRAD_TOL of each tensor's largest JAX gradient. UniformLoss is held exactly
on dyadic-grid clouds, where the matmul-form distances of both packages
are exact, so no count can flip at a radius.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.kernels import topk_scan as jax_topk
from pytorch_points_tpu.losses import RepulsionLoss as JaxRepulsionLoss
from pytorch_points_tpu.losses import UniformLoss as JaxUniformLoss
from pytorch_points_tpu.models import PointUpsampler as JaxPointUpsampler
from pytorch_points_tpu.ops import chamfer_distance as jax_chamfer_distance
from pytorch_points_tpu.ops.grouping import knn_path as jax_knn_path
from pytorch_points_tpu_torch.compat import load_jax_params
from pytorch_points_tpu_torch.compat.jax_params import _flatten
from pytorch_points_tpu_torch.kernels import topk_scan
from pytorch_points_tpu_torch.losses import RepulsionLoss, UniformLoss
from pytorch_points_tpu_torch.models import PointUpsampler
from pytorch_points_tpu_torch.models.upsampler import (
    child_features,
    grid_codes,
)
from pytorch_points_tpu_torch.ops import chamfer_distance, knn_path
from test_torch_edgeconv import jax_params
from test_torch_train import _port_grads
from torch_inputs import cloud, valid_mask

ATOL = 1e-4
RTOL = 1e-5
GRAD_TOL = 1e-4
B, N, R = 2, 128, 4
SMALL = dict(ratio=R, channels=8, growth_rate=8, dense_n=2, k=8)
REPULSION_H = 0.3


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.fixture(scope="module", autouse=True)
def pallas():
    """The JAX package on its Pallas kernels (interpret mode) for the whole
    module; the jit caches are cleared on the way in and out."""
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


@pytest.fixture(scope="module")
def models():
    jmodel = JaxPointUpsampler(**SMALL, rngs=nnx.Rngs(0))
    tree = jax_params(jmodel)
    port = PointUpsampler(**SMALL, device="cpu")
    load_jax_params(port, tree)
    return jmodel, port, tree


def _upsampler_inputs(masked):
    rng = np.random.default_rng(31)
    xyz = cloud(rng, B, N)
    gt = cloud(rng, B, N * R)
    return xyz, gt, valid_mask(rng, B, N) if masked else None


@pytest.mark.parametrize("masked", [False, True])
def test_upsampler_forward_matches_jax(models, masked):
    jmodel, port, _ = models
    xyz, _, mask = _upsampler_inputs(masked)
    ref = np.asarray(nnx.jit(lambda m, x, mk: m(x, mk))(jmodel, _j(xyz),
                                                       _j(mask)))
    with torch.inference_mode():
        out = port(_t(xyz), _t(mask))
    assert out.shape == (B, N * R, 3) == ref.shape
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_upsampler_train_grads_match_jax(models):
    """Config 7's loss (Chamfer + 0.1 repulsion): value and every parameter
    grad, the dense-connectivity concatenations and the kNN graphs'
    gathers included."""
    jmodel, port, _ = models
    xyz, gt, _ = _upsampler_inputs(False)
    jrep = JaxRepulsionLoss(h=REPULSION_H)

    def jloss(m):
        pred = m(jnp.asarray(xyz))
        return jax_chamfer_distance(pred, jnp.asarray(gt)) + 0.1 * jrep(pred)

    rv, rgrads = nnx.jit(nnx.value_and_grad(jloss))(jmodel)
    ref = {k: np.asarray(v) for k, v in _flatten(nnx.to_pure_dict(rgrads))}

    port.zero_grad(set_to_none=True)
    pred = port(_t(xyz))
    value = (chamfer_distance(pred, _t(gt))
             + 0.1 * RepulsionLoss(h=REPULSION_H)(pred))
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=RTOL)
    got = _port_grads(port)
    assert got.keys() == ref.keys()
    for path in sorted(ref):
        r = ref[path]
        np.testing.assert_allclose(got[path].numpy(), r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=path)


def test_load_jax_params_covers_the_upsampler(models):
    _, port, tree = models
    np.testing.assert_array_equal(
        port.edge2.convs[0].weight.detach().numpy(),
        tree["edge2"]["convs"][0]["kernel"].T)
    np.testing.assert_array_equal(port.lift.weight.detach().numpy(),
                                  tree["lift"]["kernel"].T)
    n_jax = sum(v.size for v in jax.tree.leaves(tree))
    assert n_jax == sum(p.numel() for p in port.parameters())


def test_children_pair_each_parent_with_every_grid_code():
    """Row i*r + j of the expansion's input is parent i's features with grid
    code j: ``jnp.repeat`` of the features, ``jnp.tile`` of the codes. The
    other pairing (tile the features, repeat the codes) gives other rows."""
    rng = np.random.default_rng(32)
    f = _t(rng.standard_normal((2, 5, 3)).astype(np.float32))
    g = grid_codes(R)
    a = 2 * np.pi * np.arange(R, dtype=np.float32) / np.float32(R)
    np.testing.assert_allclose(g.numpy(), np.stack([np.cos(a), np.sin(a)],
                                                   -1), rtol=0, atol=1e-7)
    got = child_features(f, R)
    want = torch.stack([torch.cat([f[b, i], g[j]])
                        for b in range(2) for i in range(5)
                        for j in range(R)]).reshape(2, 5 * R, 5)
    assert torch.equal(got, want)
    swapped = torch.cat([f.repeat(1, R, 1),
                         g.repeat_interleave(5, 0)[None].expand(2, -1, -1)],
                        -1)
    assert not torch.equal(swapped, want)


@pytest.fixture(params=["stream", "ring"])
def knn_route(request, monkeypatch):
    """The kNN route of a 512-point cloud: the streaming scan, or the
    Morton-ring scan with the ring threshold lowered to 512 in both
    packages (as config 7's 8192-point prediction takes it)."""
    if request.param == "ring":
        jax.clear_caches()  # the threshold is read at trace time
        monkeypatch.setattr(jax_topk, "RING_MIN_NS", 512)
        monkeypatch.setattr(topk_scan, "RING_MIN_NS", 512)
        yield request.param
        jax.clear_caches()
    else:
        yield request.param


@pytest.mark.parametrize("masked", [False, True])
def test_repulsion_loss_value_and_grad(knn_route, masked):
    rng = np.random.default_rng(33)
    xyz = cloud(rng, B, 512)
    mask = valid_mask(rng, B, 512) if masked else None
    route = {"stream": "stream", "ring": "ring_masked" if masked else "ring"}
    assert (jax_knn_path(xyz, xyz, 5, _j(mask))
            == knn_path(_t(xyz), _t(xyz), 5, _t(mask)) == route[knn_route])
    jrep = JaxRepulsionLoss(h=REPULSION_H)
    rv, rg = jax.jit(jax.value_and_grad(lambda x, m: jrep(x, m)))(
        jnp.asarray(xyz), _j(mask))
    x = _t(xyz).requires_grad_()
    value = RepulsionLoss(h=REPULSION_H)(x, _t(mask))
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=RTOL)
    rg = np.asarray(rg)
    np.testing.assert_allclose(x.grad.numpy(), rg, rtol=0,
                               atol=GRAD_TOL * np.abs(rg).max())
    if mask is not None:
        assert (x.grad.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_uniform_loss_on_the_grid(masked):
    # the dyadic grid k/64 within 8 steps of 0: every distance exact in
    # float32, and balls of radius 0.063-0.110 hold several points
    rng = np.random.default_rng(34)
    xyz = (rng.integers(-8, 9, (B, 512, 3)) / 64).astype(np.float32)
    mask = valid_mask(rng, B, 512) if masked else None
    ref = float(jax.jit(lambda x, m: JaxUniformLoss(npoint=16)(x, m))(
        jnp.asarray(xyz), _j(mask)))
    got = UniformLoss(npoint=16)(_t(xyz), _t(mask))
    assert not got.requires_grad
    np.testing.assert_allclose(got.item(), ref, rtol=RTOL)
