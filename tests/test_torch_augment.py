"""The port's augmentation (``data/augment.py``) and ``random_sample``
against the JAX package's.

The draws come from a ``torch.Generator`` where the reference takes a key,
so the two packages draw different numbers; what is held equal is what does
not depend on the draw: the rotation matrices for the same angles (rtol
1e-6 and atol 1e-7: sin and cos of the same f32 angle may differ by an ulp
between libraries), and the contracts the reference's tests hold (lengths
kept to rtol 1e-5, masked points untouched bitwise, jitter within its
clip, scale within its range, dropout never empties a cloud, a seed gives
the same draw twice). Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.data import augment as jax_augment
from pytorch_points_tpu_torch.data import augment
from pytorch_points_tpu_torch.ops import random_sample

B, N, VALID = 4, 64, 48


def _inputs():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32))
    mask = torch.arange(N)[None].expand(B, N) < VALID
    return x, mask


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_rotation_matrices_match_jax(axis):
    angles = np.random.default_rng(1).uniform(0, 2 * np.pi, 16).astype(
        np.float32)
    want = np.asarray(jax_augment._axis_rotations(jnp.asarray(angles), axis))
    got = augment._axis_rotations(torch.from_numpy(angles), axis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        augment._axis_rotations(torch.from_numpy(angles), "w")


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_rotate_keeps_lengths_axis_and_padding(axis):
    x, mask = _inputs()
    nrm = torch.nn.functional.normalize(torch.randn(B, N, 3, generator=_gen(
        9)), dim=-1)
    r, rn = augment.rotate(_gen(), x, nrm, axis=axis, mask=mask)
    np.testing.assert_allclose(r.norm(dim=-1).numpy(),
                               x.norm(dim=-1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(rn.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    keep = "xyz".index(axis)
    np.testing.assert_allclose(r[..., keep].numpy(), x[..., keep].numpy(),
                               atol=1e-6)
    assert torch.equal(r[~mask], x[~mask]) and torch.equal(rn[~mask],
                                                           nrm[~mask])
    # each cloud turns by its own angle: the same as JAX's matrix for it
    angle = torch.rand((B,), generator=_gen()) * (2 * np.pi)
    rot = np.asarray(jax_augment._axis_rotations(jnp.asarray(angle.numpy()),
                                                 axis))
    want = np.einsum("bnj,bij->bni", x.numpy(), rot)
    np.testing.assert_allclose(r[mask].numpy(), want[mask.numpy()],
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(augment.rotate(_gen(), x, axis=axis), augment.rotate(
        _gen(), x, axis=axis))


def test_jitter_respects_its_clip_and_mask():
    x, mask = _inputs()
    j = augment.jitter(_gen(), x, sigma=0.05, clip=0.05, mask=mask)
    d = (j - x).abs()
    assert d.max() <= 0.05 + 1e-6 and (d[mask] > 0.049).any()
    assert torch.equal(j[~mask], x[~mask])
    assert torch.equal(j, augment.jitter(_gen(), x, sigma=0.05, clip=0.05,
                                         mask=mask))
    assert not torch.equal(j, augment.jitter(_gen(1), x, sigma=0.05,
                                             clip=0.05, mask=mask))


def test_random_scale_is_per_cloud_and_in_range():
    x, mask = _inputs()
    s = augment.random_scale(_gen(), x, mask=mask)
    ratio = (s[:, :VALID] / x[:, :VALID]).reshape(B, -1)
    np.testing.assert_allclose(ratio.numpy(),
                               ratio[:, :1].expand_as(ratio).numpy(),
                               rtol=1e-5)
    assert ((ratio >= 0.8 - 1e-6) & (ratio <= 1.25 + 1e-6)).all()
    assert torch.equal(s[~mask], x[~mask])


@pytest.mark.parametrize("masked", [False, True])
def test_random_dropout_never_empties_a_cloud(masked):
    x, mask = _inputs()
    m = mask if masked else None
    base = mask if masked else torch.ones(B, N, dtype=torch.bool)
    dropped = 0
    for seed in range(20):
        out, keep = augment.random_dropout(_gen(seed), x, max_ratio=1.0,
                                           mask=m)
        assert out is x and keep.dtype == torch.bool
        assert not (keep & ~base).any()  # invalid stays invalid
        assert keep.any(dim=1).all()  # never empties a cloud
        dropped += int((base & ~keep).sum())
    assert dropped > 0
    one = torch.zeros(1, N, dtype=torch.bool)
    one[0, 5] = True  # one valid point: it is never dropped
    for seed in range(10):
        _, keep = augment.random_dropout(_gen(seed), x[:1], 1.0, mask=one)
        assert torch.equal(keep, one)


def test_random_sample_masks_and_distinct_indices():
    x, mask = _inputs()
    pts, idx = random_sample(x, 16, _gen())
    assert idx.dtype == torch.int32 and pts.shape == (B, 16, 3)
    assert all(len(set(row.tolist())) == 16 for row in idx)
    assert torch.equal(pts, x.gather(1, idx.long()[..., None].expand(-1, -1,
                                                                      3)))
    rng = np.random.default_rng(2)
    m = torch.from_numpy(rng.uniform(size=(B, N)) < 0.4)
    m[:, :16] = True  # >= 16 valid points a cloud
    pts, idx = random_sample(x, 16, _gen(), mask=m)
    for b in range(B):
        row = idx[b].tolist()
        assert len(set(row)) == 16 and m[b, row].all()
    full = torch.zeros(B, N, dtype=torch.bool)
    full[:, :16] = True  # exactly k valid: all of them
    _, idx = random_sample(x, 16, _gen(), mask=full)
    assert all(sorted(r.tolist()) == list(range(16)) for r in idx)
    assert torch.equal(random_sample(x, 16, _gen(3))[1],
                       random_sample(x, 16, _gen(3))[1])
