"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: each carries the ``cuda`` marker and
skips without one. The file imports no JAX, so it runs on a machine without
it; from the repository root on the card:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.) The bar is
the kernels' contract: indices identical and values bitwise equal; the scatter (K4) sums in ascending k, so it
equals its plain version run on the CPU bitwise.
"""

import numpy as np
import pytest
import torch

from pytorch_points_tpu_torch.kernels import (
    ballquery,
    distance_tiles,
    fps,
    gather,
    nn_sorted,
    scatter,
    topk_scan,
)
from pytorch_points_tpu_torch.models import PointCloudAutoencoder
from pytorch_points_tpu_torch.parallel import reconstruction_loss
from torch_inputs import (
    FPS_CASES,
    SCATTER_CASES,
    autoencoder_inputs,
    bq_inputs,
    cloud,
    fps_inputs,
    nn_inputs,
    scatter_inputs,
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


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_cuda_matches_plain(dev, case):
    idx, upd, n = scatter_inputs(case)
    cpu = scatter.scatter_add(torch.from_numpy(idx), torch.from_numpy(upd), n)
    i, u = _on(dev, idx, upd)
    got = scatter.scatter_add(i, u, n, impl="cuda")
    again = scatter.scatter_add(i, u, n, impl="cuda")
    ref = scatter.scatter_add(i, u, n, impl="torch")  # atomics on the card
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), cpu)
    # Against the atomics, the bound of two f32 summation orders of a row's
    # k updates: 2 k 2^-24 sum|u|.
    count = scatter.scatter_add(i, torch.ones_like(u), n, impl="torch")
    bound = 2 * count * 2.0**-24 * scatter.scatter_add(i, u.abs(), n,
                                                        impl="torch")
    assert ((got - ref).abs() <= bound).all()


@pytest.mark.parametrize("kind", ["random", "masked", "grid"])
def test_nn_dense_cuda_matches_plain(dev, kind):
    p, q = _on(dev, *nn_inputs(kind, 600, 700))
    with torch.inference_mode():
        got = distance_tiles.nn_both_directions(p, q, impl="cuda")
        ref = distance_tiles.nn_both_directions(p, q, impl="torch")
    _assert_same(got, ref)


@pytest.mark.parametrize("n,m", [(600, 700), (1024, 300), (4096, 4096)])
@pytest.mark.parametrize("kind", ["random", "grid"])
def test_nn_sorted_cuda_matches_plain_and_dense(dev, n, m, kind):
    p, q = _on(dev, *nn_inputs(kind, n, m))
    with torch.inference_mode():
        got = nn_sorted.nndistance_indexed(p, q, impl="cuda")
        ref = nn_sorted.nndistance_indexed(p, q, impl="torch")
        dense = distance_tiles.nn_both_directions(p, q, impl="cuda")
        sums = nn_sorted.nndistance_sums(p, q, impl="cuda")
        sums_ref = nn_sorted.nndistance_sums(p, q, impl="torch")
    _assert_same(got, ref)
    _assert_same(got, dense)
    _assert_same(sums[2:], sums_ref[2:])
    torch.testing.assert_close(sums[:2], sums_ref[:2], rtol=1e-6, atol=0)


def test_nn_band_cuda_matches_plain(dev):
    p, q = _on(dev, *nn_inputs("random", 2048, 1536))
    ps, _ = nn_sorted.sort_by_morton(p)
    qs, _ = nn_sorted.sort_by_morton(q)
    rng = np.random.default_rng(9)
    (cen,) = _on(dev, rng.integers(0, 3, (2, 4)).astype(np.int32))
    with torch.inference_mode():
        for kw in (dict(tbq=128, stride=4), dict(tbq=512), dict(centers=cen)):
            got = nn_sorted.band_min(ps, qs, impl="cuda", **kw)
            ref = nn_sorted.band_min(ps, qs, impl="torch", **kw)
            _assert_same([got], [ref])


def test_autoencoder_backward_cuda_matches_plain(dev):
    xyz, _ = autoencoder_inputs(masked=False)
    (x,) = _on(dev, xyz)
    model = PointCloudAutoencoder(npoint1=128, npoint2=32, device=dev)
    grads = {}
    for impl in ("cuda", "torch"):
        model.zero_grad(set_to_none=True)
        reconstruction_loss(impl=impl)(model, {"points": x}).backward()
        grads[impl] = [p.grad.clone() for p in model.parameters()]
    for got, ref in zip(grads["cuda"], grads["torch"]):
        scale = ref.abs().max().item()
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * scale)
