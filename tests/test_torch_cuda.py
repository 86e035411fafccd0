"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: each carries the ``cuda`` marker and
skips without one. The file imports no JAX, so it runs on a machine without
it; from the repository root on the card:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.) The bar is
the kernels' contract: indices identical and values bitwise equal.
"""

import numpy as np
import pytest
import torch

from pytorch_points_tpu_torch.kernels import ballquery, fps, gather, topk_scan
from pytorch_points_tpu_torch.models import PointCloudAutoencoder
from torch_inputs import (
    FPS_CASES,
    autoencoder_inputs,
    bq_inputs,
    cloud,
    fps_inputs,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)).to(dev)
            for a in arrays]


def _assert_same(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("case", sorted(FPS_CASES))
def test_fps_cuda_matches_plain(dev, case):
    xyz, k, mask, seed = fps_inputs(case, b=4)
    xyz, mask, seed = _on(dev, xyz, mask, seed)
    with torch.inference_mode():
        got = fps.furthest_point_sample(xyz, k, mask, seed, impl="cuda")
        ref = fps.furthest_point_sample(xyz, k, mask, seed, impl="torch")
    _assert_same(got, ref)


def test_fps_cuda_scratch_path(dev):
    # N*4 bytes above the shared-memory budget: running min-distance in a
    # device scratch buffer instead.
    n = fps._SMEM_MAX_BYTES // 4 + 100
    (xyz,) = _on(dev, cloud(np.random.default_rng(8), 2, n))
    with torch.inference_mode():
        got = fps.furthest_point_sample(xyz, 64, impl="cuda")
        ref = fps.furthest_point_sample(xyz, 64, impl="torch")
    _assert_same(got, ref)


@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_cuda_matches_plain(dev, masked):
    xyz, cen, mask = _on(dev, *bq_inputs(masked))
    with torch.inference_mode():
        got = ballquery.ball_query(xyz, cen, 0.2, 8, mask, impl="cuda")
        ref = ballquery.ball_query(xyz, cen, 0.2, 8, mask, impl="torch")
    _assert_same(got, ref)


@pytest.mark.parametrize("c", [3, 128])
def test_gather_cuda_matches_plain(dev, c):
    rng = np.random.default_rng(3)
    f, idx = _on(dev, rng.standard_normal((2, 500, c)).astype(np.float32),
                 rng.integers(0, 500, (2, 4096)).astype(np.int32))
    with torch.inference_mode():
        got = gather.gather_rows(f, idx, impl="cuda")
        ref = gather.gather_rows(f, idx, impl="torch")
    _assert_same([got], [ref])


@pytest.mark.parametrize("k", [3, 16, 64])
@pytest.mark.parametrize("kind", ["random", "grid"])
def test_knn_cuda_matches_plain(dev, k, kind):
    rng = np.random.default_rng(4)
    q, s = _on(dev, cloud(rng, 2, 700, kind), cloud(rng, 2, 1100, kind))
    with torch.inference_mode():
        got = topk_scan.knn(q, s, k, impl="cuda")
        ref = topk_scan.knn(q, s, k, impl="torch")
    _assert_same(got, ref)


def test_cuda_kernels_refuse_grad(dev):
    x = torch.zeros(1, 8, 3, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fps.furthest_point_sample(x, 2, impl="cuda")


def test_autoencoder_cuda_matches_plain(dev):
    xyz, mask = autoencoder_inputs(masked=True)
    x, m = _on(dev, xyz, mask)
    model = PointCloudAutoencoder(npoint1=128, npoint2=32, device=dev).eval()
    with torch.inference_mode():
        for mk in (None, m):
            got = model(x, mk, impl="cuda")
            ref = model(x, mk, impl="torch")
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
