"""The port's coordinate-emitting ball query (``ball_query_and_group_coords``,
K2 with ``with_coords=True``), its autograd Function ``_bq_group_centered``
and the older-layout gather (``gather_rows``, beside ``gather_rows_t``)
against the JAX package.

The JAX kernels run in Pallas interpret mode, as the JAX package's own
kernel tests run them on the CPU; the port runs its plain PyTorch versions
(CPU tensors). Inputs come from numpy with a seed.

Tolerances, and why:
  * idx and cnt exactly equal, as for K2 (``test_torch_kernels.py``);
  * g bitwise equal: both sides compute it as one float32 subtraction of
    the same two numbers (the reference sums a one-hot column of exact
    zeros first, which changes no bit). The dyadic grid k/64 is held too:
    there every distance is exact, so no CPU FMA can move a near-radius hit;
  * grad_xyz within 1e-5 of its largest entry: a scatter of the cotangent,
    summed in another order than the JAX backward's; grad_cen at rtol 1e-6:
    a sum over the ns slots of a positive cotangent, in another order;
  * the gathers bitwise: both copy float32 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.kernels import ballquery as jax_bq
from pytorch_points_tpu.kernels import gather as jax_gather
from pytorch_points_tpu.ops import grouping as jax_grouping
from pytorch_points_tpu_torch.kernels import ballquery, gather
from pytorch_points_tpu_torch.ops import grouping
from torch_inputs import bq_inputs, emd_cloud

RADIUS = 0.2


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _grid_inputs(masked):
    """(support, centroids, mask or None) on the dyadic grid k/64 in
    [0, 1]^3, with far (zero-hit) and dense (saturated) centroids."""
    rng = np.random.default_rng(21)
    xyz = np.abs(emd_cloud(rng, 2, 300, "grid"))
    cen = xyz[:, rng.choice(300, 40, replace=False)].copy()
    cen[:, :4] = 5.0
    cen[:, 4:8] = 0.5
    mask = rng.uniform(size=(2, 300)) < 0.75 if masked else None
    return xyz, cen, mask


def _coords_pair(xyz, cen, mask, nsample, tp):
    ref = jax_bq.ball_query_and_group_coords(
        jnp.asarray(xyz), jnp.asarray(cen), RADIUS, nsample,
        None if mask is None else jnp.asarray(mask), tp=tp)
    got = ballquery.ball_query_and_group_coords(
        _t(xyz), _t(cen), RADIUS, nsample, _t(mask), tp=tp, impl="torch")
    return got, ref


def _assert_coords(got, ref):
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert [g.dtype for g in got] == [torch.int32, torch.int32,
                                      torch.float32]


@pytest.mark.parametrize("nsample", [8, 5])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("form", ["resident", "grid"])
def test_coords_ball_query_matches_pallas(form, masked, nsample):
    xyz, cen, mask = bq_inputs(masked)
    got, ref = _coords_pair(xyz, cen, mask, nsample,
                            128 if form == "grid" else None)
    _assert_coords(got, ref)
    cnt = got[1].numpy()
    assert (cnt == 0).any() and (cnt == nsample).any()
    assert ((cnt > 0) & (cnt < nsample)).any()  # first-hit fill slots


@pytest.mark.parametrize("masked", [False, True])
def test_coords_ball_query_matches_pallas_on_grid(masked):
    got, ref = _coords_pair(*_grid_inputs(masked), 8, None)
    _assert_coords(got, ref)


def test_zero_hit_row_takes_the_unpoisoned_point_0():
    # point 0 masked out in both clouds: the zero-hit rows still get the
    # raw xyz[b, 0] - centroid, as the reference fills them
    xyz, cen, mask = bq_inputs(True)
    mask[:, 0] = False
    got, ref = _coords_pair(xyz, cen, mask, 8, None)
    _assert_coords(got, ref)
    zero = got[1].numpy() == 0
    assert zero[:, :4].all()
    want = xyz[:, None, None, 0, :] - cen[:, :, None, :]
    np.testing.assert_array_equal(
        got[2].numpy()[zero], np.broadcast_to(want, got[2].shape)[zero])


def test_coords_ball_query_outputs_carry_no_grad():
    xyz, cen, _ = bq_inputs(False)
    x = _t(xyz).requires_grad_()
    out = ballquery.ball_query_and_group_coords(x, _t(cen), RADIUS, 8)
    assert not any(o.requires_grad for o in out)


def test_bq_group_centered_matches_jax_custom_vjp():
    xyz, cen, _ = bq_inputs(False)
    nsample = 8
    w = np.random.default_rng(22).uniform(
        0.5, 1.5, (2, 40, nsample, 3)).astype(np.float32)

    def loss(x, c):
        _, _, g = jax_grouping._bq_group_centered(x, c, RADIUS, nsample)
        return jnp.sum(g * jnp.asarray(w))

    ref_gx, ref_gc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xyz),
                                                    jnp.asarray(cen))
    ref = jax_grouping._bq_group_centered(jnp.asarray(xyz), jnp.asarray(cen),
                                          RADIUS, nsample)
    x, c = _t(xyz).requires_grad_(), _t(cen).requires_grad_()
    got = grouping._bq_group_centered(x, c, RADIUS, nsample)
    _assert_coords([o.detach() for o in got], ref)
    (got[2] * _t(w)).sum().backward()
    ref_gx, ref_gc = np.asarray(ref_gx), np.asarray(ref_gc)
    np.testing.assert_allclose(x.grad.numpy(), ref_gx, rtol=0,
                               atol=1e-5 * np.abs(ref_gx).max())
    np.testing.assert_allclose(c.grad.numpy(), ref_gc, rtol=1e-6, atol=0)
    assert (x.grad.numpy()[0, 0] != 0).any()  # fill slots reach point 0


@pytest.mark.parametrize("c", [3, 16])
def test_older_layout_gather_matches_both_pallas_gathers(c):
    rng = np.random.default_rng(23)
    f = rng.standard_normal((2, 300, c)).astype(np.float32)
    idx = rng.integers(0, 300, (2, 500)).astype(np.int32)
    ref = np.asarray(jax_gather.gather_rows(jnp.asarray(f), jnp.asarray(idx)))
    np.testing.assert_array_equal(
        np.asarray(jax_gather.gather_rows_t(jnp.asarray(f),
                                            jnp.asarray(idx))), ref)
    for fn in (gather.gather_rows, gather.gather_rows_t):
        np.testing.assert_array_equal(fn(_t(f), _t(idx)).numpy(), ref)
