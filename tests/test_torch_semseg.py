"""The port's PointNet2SemSeg and PointNet2Classifier against the JAX
models.

Weights come from the JAX models through ``load_jax_params``; inputs from
numpy with a seed. The JAX side runs its Pallas kernels in interpret mode
(``force_impl("pallas")``), jitted whole; the port runs its plain PyTorch
versions on the CPU. SemSeg takes the sizes ``test_torch_slice.py`` gives
the autoencoder (npoint 128/32, N=512); the classifier's encoder is at its
defaults (npoint 512/128), so its cloud has 512 points.

Tolerances: logits atol 1e-4; the cross-entropy rtol 1e-5; gradients
within GRAD_TOL of each tensor's largest JAX gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.models import PointNet2Classifier as JaxClassifier
from pytorch_points_tpu.models import PointNet2SemSeg as JaxSemSeg
from pytorch_points_tpu_torch.compat import load_jax_params
from pytorch_points_tpu_torch.compat.jax_params import _flatten
from pytorch_points_tpu_torch.models import (
    PointNet2Classifier,
    PointNet2SemSeg,
)
from test_torch_edgeconv import jax_params
from test_torch_train import _port_grads
from torch_inputs import autoencoder_inputs

ATOL = 1e-4
RTOL = 1e-5
GRAD_TOL = 1e-4
CLASSES = 13
B, N = 2, 512
SEG = dict(npoint1=128, npoint2=32)


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
def semseg():
    jmodel = JaxSemSeg(CLASSES, **SEG, rngs=nnx.Rngs(0))
    tree = jax_params(jmodel)
    port = PointNet2SemSeg(CLASSES, **SEG, device="cpu")
    load_jax_params(port, tree)
    return jmodel, port, tree


@pytest.fixture(scope="module")
def classifier():
    jmodel = JaxClassifier(40, rngs=nnx.Rngs(0))
    tree = jax_params(jmodel)
    port = PointNet2Classifier(40, device="cpu")
    load_jax_params(port, tree)
    return jmodel, port, tree


def _labels():
    return np.random.default_rng(40).integers(0, CLASSES, (B, N))


def test_semseg_forward_masked_matches_jax(semseg):
    jmodel, port, _ = semseg
    xyz, mask = autoencoder_inputs(masked=True, b=B, n=N)
    ref = np.asarray(nnx.jit(lambda m, x, mk: m(x, mk))(jmodel, _j(xyz),
                                                       _j(mask)))
    with torch.inference_mode():
        out = port(_t(xyz), _t(mask))
    assert out.shape == (B, N, CLASSES) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    assert (out.numpy()[~mask] == 0).all()


def test_semseg_cross_entropy_and_grads_match_jax(semseg):
    """Config 8's loss, softmax cross-entropy averaged over every point:
    the unmasked logits, the loss and every parameter grad."""
    jmodel, port, _ = semseg
    xyz, _ = autoencoder_inputs(masked=False, b=B, n=N)
    labels = _labels()

    def jloss(m):
        logits = m(jnp.asarray(xyz))
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels))), logits

    (rv, rlogits), rgrads = nnx.jit(nnx.value_and_grad(jloss,
                                                       has_aux=True))(jmodel)
    ref = {k: np.asarray(v) for k, v in _flatten(nnx.to_pure_dict(rgrads))}

    port.zero_grad(set_to_none=True)
    logits = port(_t(xyz))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(rlogits),
                               rtol=0, atol=ATOL)
    value = F.cross_entropy(logits.reshape(-1, CLASSES),
                            _t(labels).reshape(-1))
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=RTOL)
    got = _port_grads(port)
    assert got.keys() == ref.keys()
    for path in sorted(ref):
        r = ref[path]
        np.testing.assert_allclose(got[path].numpy(), r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=path)


def test_classifier_forward_matches_jax(classifier):
    jmodel, port, _ = classifier
    xyz, _ = autoencoder_inputs(masked=False, b=1, n=512)
    ref = np.asarray(nnx.jit(lambda m, x: m(x))(jmodel, _j(xyz)))
    with torch.inference_mode():
        out = port(_t(xyz))
    assert out.shape == (1, 40) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("which", ["semseg", "classifier"])
def test_load_jax_params_covers_every_parameter(request, which):
    _, port, tree = request.getfixturevalue(which)
    np.testing.assert_array_equal(
        port.head.layers[-1].weight.detach().numpy(),
        tree["head"]["layers"][len(port.head.layers) - 1]["kernel"].T)
    n_jax = sum(v.size for v in jax.tree.leaves(tree))
    assert n_jax == sum(p.numel() for p in port.parameters())


def test_semseg_shares_the_autoencoders_fp_stack(semseg):
    _, port, _ = semseg
    assert [m.mlp.layers[0].in_features
            for m in (port.fp3, port.fp2, port.fp1)] == [1280, 384, 128]
    assert port.head.layers[-1].out_features == CLASSES
    assert isinstance(port.head.norms[-1], torch.nn.Identity)


def test_batch_norm_waits():
    """norm="batch" builds flax's BatchNorm in every norm slot (held
    against flax in test_torch_sorted_bn_bf16.py); an unknown norm still
    raises."""
    from pytorch_points_tpu_torch.layers.blocks import BatchNorm

    model = PointNet2SemSeg(CLASSES, **SEG, norm="batch", device="cpu")
    assert isinstance(model.encoder.sa1.mlp.norms[0], BatchNorm)
    assert isinstance(model.head.norms[0], BatchNorm)
    with pytest.raises(ValueError, match="norm"):
        PointNet2SemSeg(CLASSES, norm="group", device="cpu")
