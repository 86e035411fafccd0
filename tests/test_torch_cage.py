"""The port's CageDeformer against the JAX model, the Neural Cages train
step's loss included.

Weights come from the JAX model through ``load_jax_params``; inputs from
numpy with a seed. The JAX side runs its Pallas kernels in interpret mode
(``force_impl("pallas")``), jitted whole; the port runs its plain PyTorch
versions on the CPU. The model is at ``npoint1=16, npoint2=8`` with the
icosphere cage of 42 vertices that ``chip_smoke.py``'s Neural Cages phase
uses.

Tolerances: the deformed cloud and the new cage atol 1e-5 (the offsets are
0.1 tanh of the head); the MVC weights 1e-4 (test_torch_geometry.py's
MVC_TOL); the loss rtol 1e-5 and each parameter grad within GRAD_TOL of
its tensor's largest JAX grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_points_tpu import losses as jlosses
from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.models import CageDeformer as JaxCageDeformer
from pytorch_points_tpu_torch import losses
from pytorch_points_tpu_torch.compat import load_jax_params
from pytorch_points_tpu_torch.compat.jax_params import _flatten
from pytorch_points_tpu_torch.models import CageDeformer
from pytorch_points_tpu_torch.utils.geometry_utils import (
    generate_icosphere,
    mesh_edges,
)
from test_torch_sorted_bn_bf16 import _params, _port_grads

ATOL, MVC_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4
B, N = 2, 128
CAGE_V, CAGE_F = generate_icosphere(1, radius=1.5)
CAGE_E = mesh_edges(CAGE_F)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def pallas():
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


@pytest.fixture(scope="module")
def models():
    # built under nnx.jit: the same weights as an eager build, without
    # compiling each initialiser op alone
    jm = nnx.jit(lambda: JaxCageDeformer(len(CAGE_V), npoint1=16, npoint2=8,
                                         rngs=nnx.Rngs(0)))()
    port = CageDeformer(len(CAGE_V), npoint1=16, npoint2=8, device="cpu")
    load_jax_params(port, _params(jm))
    return jm, port


def _clouds():
    rng = np.random.default_rng(70)
    src = rng.standard_normal((B, N, 3)).astype(np.float32)
    src *= (0.9 / np.abs(src).max(-1, keepdims=True).clip(1.0))
    tgt = (src * np.array([1.0, 0.6, 1.0], np.float32)
           + 0.02 * rng.standard_normal(src.shape)).astype(np.float32)
    return src, tgt


def _jloss(m, src, tgt):
    deformed, new_cage, w = m(src, tgt, CAGE_V, CAGE_F)
    loss = (jlosses.ChamferLoss()(deformed, tgt)
            + jlosses.MeshLaplacianLoss()(
                new_cage, CAGE_E, jnp.broadcast_to(CAGE_V, new_cage.shape))
            + jlosses.PointLaplacianLoss()(src, deformed))
    return loss, (deformed, new_cage, w)


def test_cage_deformer_forward_loss_and_grads_match_jax(models):
    """The Neural Cages step's loss: Chamfer to the target, the cage's
    uniform Laplacian against the source cage's, and the point Laplacian
    of the deformed cloud under the source's neighbourhoods."""
    jm, port = models
    src, tgt = _clouds()
    (rv, (rdef, rcage, rw)), rgrads = nnx.jit(nnx.value_and_grad(
        _jloss, has_aux=True))(jm, jnp.asarray(src), jnp.asarray(tgt))
    port.zero_grad(set_to_none=True)
    deformed, new_cage, w = port(_t(src), _t(tgt), CAGE_V, CAGE_F)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(rw), rtol=0,
                               atol=MVC_TOL)
    np.testing.assert_allclose(new_cage.detach().numpy(), np.asarray(rcage),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(deformed.detach().numpy(), np.asarray(rdef),
                               rtol=0, atol=MVC_TOL)
    assert float((new_cage - _t(CAGE_V)).abs().max().detach()) <= 0.1 + 1e-6
    loss = (losses.ChamferLoss()(deformed, _t(tgt))
            + losses.MeshLaplacianLoss()(new_cage, CAGE_E,
                                         _t(CAGE_V).expand_as(new_cage))
            + losses.PointLaplacianLoss()(_t(src), deformed))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(rv), rtol=1e-5)
    ref = {k: np.asarray(v) for k, v in _flatten(nnx.to_pure_dict(rgrads))}
    got = _port_grads(port)
    assert got.keys() == ref.keys()
    for path in sorted(ref):
        r = ref[path]
        np.testing.assert_allclose(got[path], r, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(r).max(),
                                                       1e-12),
                                   err_msg=path)


def test_cage_deformer_reuses_weights(models):
    _, port = models
    src, tgt = _clouds()
    with torch.no_grad():
        d1, c1, w = port(_t(src), _t(tgt), CAGE_V, CAGE_F)
        d2, c2, w2 = port(_t(src), _t(tgt), CAGE_V, CAGE_F, weights=w)
    assert w2 is w and torch.equal(d1, d2) and torch.equal(c1, c2)
    n_jax = sum(v.size for v in jax.tree.leaves(_params(models[0])))
    assert n_jax == sum(p.numel() for p in port.parameters())
