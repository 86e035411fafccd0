"""The port's PointCloudAutoencoder forward against the JAX model.

The JAX model runs with its Pallas kernels (interpret mode on the CPU, under
``force_impl("pallas")``); its weights are carried into the port with
``load_jax_params``; the port runs its plain PyTorch versions on the CPU.
Inputs come from numpy with a seed. Tolerance atol 1e-4: the selections are
index-identical, and what remains is float32 matmul / LayerNorm rounding
(JAX's own XLA-vs-Pallas outputs differ by ~3e-6 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.models import PointCloudAutoencoder as JaxAutoencoder
from pytorch_points_tpu_torch.compat import load_jax_params
from pytorch_points_tpu_torch.models import PointCloudAutoencoder
from torch_inputs import autoencoder_inputs

ATOL = 1e-4
B, N = 2, 512


@pytest.fixture(scope="module")
def jax_model():
    model = JaxAutoencoder(npoint1=128, npoint2=32, rngs=nnx.Rngs(0))
    tree = jax.tree.map(np.asarray,
                        nnx.to_pure_dict(nnx.state(model, nnx.Param)))
    return model, tree


def _jax_pallas_forward(model, xyz, mask):
    # ops are jitted with impl resolved at trace time: drop cached traces
    # so the forced Pallas route is traced, and drop them again after.
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    try:
        return np.asarray(model(jnp.asarray(xyz),
                                None if mask is None else jnp.asarray(mask)))
    finally:
        jax_dispatch.force_impl(None)
        jax.clear_caches()


@pytest.mark.parametrize("masked", [False, True])
def test_autoencoder_matches_jax(jax_model, masked):
    model, tree = jax_model
    xyz, mask = autoencoder_inputs(masked, B, N)
    ref = _jax_pallas_forward(model, xyz, mask)

    port = PointCloudAutoencoder(npoint1=128, npoint2=32, device="cpu").eval()
    load_jax_params(port, tree)
    with torch.inference_mode():
        out = port(torch.from_numpy(xyz),
                   None if mask is None else torch.from_numpy(mask))
    assert out.shape == (B, N, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    if mask is not None:
        assert (out.numpy()[~mask] == 0).all()


def test_load_jax_params_covers_every_parameter(jax_model):
    _, tree = jax_model
    port = PointCloudAutoencoder(npoint1=128, npoint2=32, device="cpu")
    load_jax_params(port, tree)
    kernel = tree["encoder"]["sa2"]["mlp"]["layers"][1]["kernel"]
    np.testing.assert_array_equal(
        port.encoder.sa2.mlp.layers[1].weight.detach().numpy(), kernel.T)
    scale = tree["head"]["norms"][0]["scale"]
    np.testing.assert_array_equal(
        port.head.norms[0].weight.detach().numpy(), scale)
    n_jax = sum(v.size for v in jax.tree.leaves(tree))
    assert n_jax == sum(p.numel() for p in port.parameters())
    assert port.head.norms[0].eps == 1e-6  # flax's LayerNorm epsilon


def _edited(tree, path, fn):
    tree = jax.tree.map(lambda a: a, tree)  # copy the dict structure
    node = tree
    for key in path[:-1]:
        node = node[key]
    fn(node, path[-1])
    return tree


@pytest.mark.parametrize("fault", ["misshaped", "missing", "extra"])
def test_load_jax_params_rejects_bad_tree(jax_model, fault):
    _, tree = jax_model
    path = ("fp2", "mlp", "layers", 0, "kernel")
    edit = {
        "misshaped": lambda d, k: d.__setitem__(k, d[k][:-1]),
        "missing": lambda d, k: d.pop(k),
        "extra": lambda d, k: d.__setitem__("extra", d[k]),
    }[fault]
    port = PointCloudAutoencoder(npoint1=128, npoint2=32, device="cpu")
    before = port.fp1.mlp.layers[0].weight.detach().clone()
    with pytest.raises(ValueError):
        load_jax_params(port, _edited(tree, path, edit))
    # a rejected tree leaves the model untouched
    assert torch.equal(port.fp1.mlp.layers[0].weight.detach(), before)


def test_same_seed_same_weights():
    a = PointCloudAutoencoder(npoint1=16, npoint2=8, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    b = PointCloudAutoencoder(npoint1=16, npoint2=8, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


# The first four weights of SA1's first Linear from seed 0, as torch 2.11's
# ``nn.init.trunc_normal_`` (an inverse-CDF draw) gives them on the card's
# machine; torch 2.13's rejection draw gave [-0.7390, -0.7564, ...] from the
# same seed before ``layers.blocks.trunc_normal_`` drew them itself.
SEED0_SA1_W0 = [-0.0058786883018910885, 0.45521751046180725,
                -0.814900815486908, -0.6837354898452759]


def test_seeded_weights_do_not_depend_on_the_torch_version():
    model = PointCloudAutoencoder(npoint1=96, npoint2=24, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    got = model.encoder.sa1.mlp.layers[0].weight.detach().flatten()[:4]
    assert got.tolist() == SEED0_SA1_W0


def test_linear_init_matches_jax_statistics():
    """A wide Linear (in 600, out 200): the port's draw has the bound and
    standard deviation of flax's lecun-normal kernel (2%)."""
    from pytorch_points_tpu_torch.layers.blocks import _linear

    ref = np.asarray(nnx.Linear(600, 200, rngs=nnx.Rngs(0)).kernel[...])
    got = _linear(600, 200, torch.Generator().manual_seed(0)).weight
    got = got.detach().numpy().T
    np.testing.assert_allclose(got.std(), ref.std(), rtol=0.02)
    np.testing.assert_allclose(abs(got.mean()), 0, atol=0.01 * ref.std())
    bound = np.abs(ref).max()
    assert bound * 0.97 <= np.abs(got).max() <= bound * 1.01
