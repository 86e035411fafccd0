"""The port's DenseEdgeConv against the JAX layer, forward and backward.

Weights come from the JAX layer through ``load_jax_params``; inputs from
numpy with a seed. With ``xyz`` given the graph is built on coordinates and
the JAX side runs its Pallas kernels (interpret mode, under
``force_impl("pallas")``). With ``xyz=None`` the graph is built in feature
space over all C channels, the documented contract, which the reference's
XLA route computes (its Pallas scan reads three channels); the features lie
on a dyadic grid, where the XLA route's matmul-form distances and the
port's diff^2 form are both exact. The JAX side is jitted whole (one
compile, not one an eager op).

Tolerances: outputs atol 1e-4; gradients within GRAD_TOL of each tensor's
largest JAX gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.layers import DenseEdgeConv as JaxDenseEdgeConv
from pytorch_points_tpu_torch.compat import load_jax_params
from pytorch_points_tpu_torch.layers import DenseEdgeConv
from pytorch_points_tpu_torch.ops import grouping
from torch_inputs import valid_mask

ATOL = 1e-4
GRAD_TOL = 1e-4
B, N, C, G, K = 2, 128, 8, 8, 8


def jax_params(model):
    return jax.tree.map(np.asarray,
                        nnx.to_pure_dict(nnx.state(model, nnx.Param)))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.fixture(scope="module")
def layers():
    jmodel = JaxDenseEdgeConv(C, G, n=2, k=K, rngs=nnx.Rngs(0))
    port = DenseEdgeConv(C, G, n=2, k=K, device="cpu")
    load_jax_params(port, jax_params(jmodel))
    return jmodel, port


def _inputs(graph, masked):
    """(features, xyz or None, mask or None, output weights)."""
    rng = np.random.default_rng(30)
    if graph == "features":  # the dyadic grid k/8: every distance exact
        f = (rng.integers(-8, 9, (B, N, C)) / 8).astype(np.float32)
        xyz = None
    else:
        f = rng.standard_normal((B, N, C)).astype(np.float32)
        xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    mask = valid_mask(rng, B, N) if masked else None
    w = rng.standard_normal((B, N, C + 2 * G)).astype(np.float32)
    return f, xyz, mask, w


def _jax_route(graph):
    return "pallas" if graph == "xyz" else "xla"


def _jax_value_and_grads(jmodel, graph, f, xyz, mask, w):
    """(output, grad wrt the features, parameter grads) of sum(out * w)."""

    def loss(model, f):
        out = model(f, xyz=_j(xyz), mask=_j(mask))
        return jnp.sum(out * w), out

    jax.clear_caches()  # the route is read at trace time
    jax_dispatch.force_impl(_jax_route(graph))
    try:
        (_, out), (gparams, gf) = nnx.jit(
            nnx.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                jmodel, jnp.asarray(f))
    finally:
        jax_dispatch.force_impl(None)
        jax.clear_caches()
    return np.asarray(out), np.asarray(gf), nnx.to_pure_dict(gparams)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("graph", ["xyz", "features"])
def test_dense_edge_conv_matches_jax(layers, monkeypatch, graph, masked):
    jmodel, port = layers
    f, xyz, mask, w = _inputs(graph, masked)
    ref, ref_gf, ref_gp = _jax_value_and_grads(jmodel, graph, f, xyz, mask,
                                               w)

    def no_knn_backward(*_):
        raise AssertionError("the graph's kNN distance took a gradient")

    # the neighbour indices carry no gradient: the kNN's backward never runs
    monkeypatch.setattr(grouping._Knn, "backward", no_knn_backward)
    port.zero_grad(set_to_none=True)
    x = _t(f).requires_grad_()
    out = port(x, xyz=_t(xyz), mask=_t(mask))
    assert out.shape == (B, N, port.out_channels) == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=ATOL)
    if mask is not None:
        assert (out.detach().numpy()[~mask] == 0).all()
    (out * _t(w)).sum().backward()
    got = {"features": x.grad.numpy(),
           "first/kernel": port.first.weight.grad.numpy().T,
           "first/bias": port.first.bias.grad.numpy(),
           "convs/0/kernel": port.convs[0].weight.grad.numpy().T,
           "convs/0/bias": port.convs[0].bias.grad.numpy()}
    ref_g = {"features": ref_gf,
             "first/kernel": ref_gp["first"]["kernel"],
             "first/bias": ref_gp["first"]["bias"],
             "convs/0/kernel": ref_gp["convs"][0]["kernel"],
             "convs/0/bias": ref_gp["convs"][0]["bias"]}
    for name, r in ref_g.items():
        r = np.asarray(r)
        np.testing.assert_allclose(got[name], r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=name)


def test_dense_edge_conv_shape_and_seed():
    a = DenseEdgeConv(24, 24, device="cpu",
                      generator=torch.Generator().manual_seed(5))
    b = DenseEdgeConv(24, 24, device="cpu",
                      generator=torch.Generator().manual_seed(5))
    assert a.out_channels == 24 + 3 * 24
    assert [c.in_features for c in a.convs] == [48, 72]
    for pa, pb in zip(a.parameters(), b.parameters(), strict=True):
        assert torch.equal(pa, pb)
