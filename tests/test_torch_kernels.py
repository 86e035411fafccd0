"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version (what a CPU tensor runs) is held against the
JAX kernel itself, run in Pallas interpret mode as the JAX kernel tests run
it on the CPU: indices exactly equal, values to rtol 1e-6 (expected
bitwise). Inputs come from numpy with a seed. The CUDA kernels themselves
need the card: tests/test_torch_cuda.py holds them against these plain
versions there.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.core.masking import poison_points as jax_poison
from pytorch_points_tpu.kernels import ballquery as jax_bq
from pytorch_points_tpu.kernels import fps as jax_fps
from pytorch_points_tpu.kernels import gather as jax_gather
from pytorch_points_tpu.kernels import topk_scan as jax_topk
from pytorch_points_tpu_torch.core import masking
from pytorch_points_tpu_torch.kernels import ballquery, dispatch, fps, gather
from pytorch_points_tpu_torch.kernels import (
    distance_tiles,
    nn_sorted,
    scatter,
    topk_scan,
)
from pytorch_points_tpu_torch.ops import grouping
from torch_inputs import FPS_CASES, bq_inputs, cloud, fps_inputs, valid_mask

RTOL = 1e-6


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", sorted(FPS_CASES))
def test_fps_matches_pallas(case):
    xyz, k, mask, seed = fps_inputs(case)
    ref_idx, ref_xyz = jax_fps.furthest_point_sample(
        jnp.asarray(xyz), k, None if mask is None else jnp.asarray(mask),
        None if seed is None else jnp.asarray(seed), emit_coords=True,
    )
    idx, coords = fps.furthest_point_sample(_t(xyz), k, _t(mask), _t(seed),
                                            impl="torch")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(coords.numpy(), np.asarray(ref_xyz), rtol=RTOL)
    assert idx.dtype == torch.int32 and coords.dtype == torch.float32


# ---------------------------------------------------------------------------
# K2: ball query (resident and grid forms)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["resident", "grid"])
@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_matches_pallas(form, masked):
    xyz, cen, mask = bq_inputs(masked)
    radius, nsample = 0.2, 8
    ref_idx, ref_cnt = jax_bq.ball_query(
        jnp.asarray(xyz), jnp.asarray(cen), radius, nsample,
        None if mask is None else jnp.asarray(mask),
        tp=128 if form == "grid" else None,
    )
    idx, cnt = ballquery.ball_query(_t(xyz), _t(cen), radius, nsample,
                                    _t(mask), impl="torch")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    cnt = cnt.numpy()
    assert (cnt == 0).any() and (cnt == nsample).any()  # both edge rows hit


def test_ball_query_radius_rounds_like_pallas():
    # r^2 squared in double, rounded once to float32 (not squared in f32).
    r = 0.3
    assert ballquery.squared_radius(r) == float(np.float32(r * r))


# ---------------------------------------------------------------------------
# K3: gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [3, 16])
def test_gather_matches_pallas(c):
    rng = np.random.default_rng(3)
    b, n, k = 2, 200, 4096
    f = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    ref = jax_gather.gather_rows_t(jnp.asarray(f), jnp.asarray(idx))
    out = gather.gather_rows(_t(f), _t(idx), impl="torch")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# K8: streaming kNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 16])
@pytest.mark.parametrize("kind", ["random", "grid", "masked"])
def test_knn_matches_pallas(k, kind):
    rng = np.random.default_rng(4)
    b, nq, ns = 2, 150, 260
    q = cloud(rng, b, nq, "grid" if kind == "grid" else "random")
    s = cloud(rng, b, ns, "grid" if kind == "grid" else "random")
    mask = valid_mask(rng, b, ns) if kind == "masked" else None
    s_ref = jnp.asarray(s)
    if mask is not None:
        s_ref = jax_poison(s_ref, jnp.asarray(mask), sign=-1.0)
    ref_d, ref_i = jax_topk.knn(jnp.asarray(q), s_ref, k, sorted_ok=False)
    d, i = grouping.knn(_t(q), _t(s), k, support_mask=_t(mask), impl="torch")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=RTOL)
    if mask is not None:
        assert mask[np.arange(b)[:, None, None], i.numpy()].all()


# ---------------------------------------------------------------------------
# Dispatch, masking helpers
# ---------------------------------------------------------------------------


def test_poison_points_matches_jax():
    rng = np.random.default_rng(5)
    xyz = cloud(rng, 2, 50)
    mask = valid_mask(rng, 2, 50)
    for sign in (1.0, -1.0):
        ref = jax_poison(jnp.asarray(xyz), jnp.asarray(mask), sign=sign)
        out = masking.poison_points(_t(xyz), _t(mask), sign=sign)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(40, 3), (2, 40, 3)])
def test_pad_points_and_lengths_match_jax(shape):
    from pytorch_points_tpu.core.masking import lengths_to_mask, pad_points

    xyz = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    ref, ref_mask = pad_points(jnp.asarray(xyz), 64)
    out, mask = masking.pad_points(_t(xyz), 64)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    with pytest.raises(ValueError):
        masking.pad_points(_t(xyz), 39)
    lengths = np.array([0, 5, 64])
    np.testing.assert_array_equal(
        masking.lengths_to_mask(_t(lengths), 64).numpy(),
        np.asarray(lengths_to_mask(jnp.asarray(lengths), 64)))


def test_dispatch_resolves_by_device():
    x = torch.zeros(1, 4, 3)
    assert dispatch.resolve("auto", x, "fps") == "torch"
    assert dispatch.resolve("torch", x, "knn") == "torch"
    with pytest.raises(ValueError):
        dispatch.resolve("pallas", x, "fps")


@pytest.mark.parametrize("op", ["fps", "ball_query", "gather", "knn",
                                "scatter", "nn_dense", "nn_band",
                                "nn_resident"])
def test_cuda_impl_on_cpu_tensor_raises(op):
    x = torch.zeros(1, 8, 3)
    idx = torch.zeros(1, 4, dtype=torch.int32)
    cloud = torch.zeros(1, 512, 3)
    call = {
        "fps": lambda: fps.furthest_point_sample(x, 2, impl="cuda"),
        "ball_query": lambda: ballquery.ball_query(x, x, 0.1, 4, impl="cuda"),
        "gather": lambda: gather.gather_rows(x, idx, impl="cuda"),
        "knn": lambda: topk_scan.knn(x, x, 3, impl="cuda"),
        "scatter": lambda: scatter.scatter_add(idx, x[:, :4], 8,
                                               impl="cuda"),
        "nn_dense": lambda: distance_tiles.nn_both_directions(x, x,
                                                              impl="cuda"),
        "nn_band": lambda: nn_sorted.band_min(cloud, cloud, impl="cuda"),
        "nn_resident": lambda: nn_sorted.nn_resident(
            cloud, cloud, idx.new_zeros(1, 512), torch.ones(1, 1, 8,
                                                            dtype=bool),
            impl="cuda"),
    }[op]
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "sys.modules['pytorch_points_tpu'] = None\n"
        "import pytorch_points_tpu_torch.models, pytorch_points_tpu_torch.ops\n"
        "import pytorch_points_tpu_torch.compat\n"
        "import pytorch_points_tpu_torch.parallel\n"
        "from pytorch_points_tpu_torch.kernels import (\n"
        "    _build, ballquery, dispatch, distance_tiles, fps, gather,\n"
        "    nn_sorted, scatter, topk_scan)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
