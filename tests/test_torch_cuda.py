"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: each carries the ``cuda`` marker and
skips without one. The file imports no JAX, so it runs on a machine without
it; from the repository root on the card:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.) The bar is
the kernels' contract: indices identical and values bitwise equal; the scatter (K4) sums in ascending k, so it
equals its plain version run on the CPU bitwise. The auction (K11) and its
endgame (K12) give the plain versions' owners and prices bitwise.
"""

import numpy as np
import pytest
import torch

from pytorch_points_tpu_torch.core.masking import poison_points
from pytorch_points_tpu_torch.kernels import (
    auction,
    ballquery,
    distance_tiles,
    fps,
    gather,
    nn_sorted,
    scatter,
    topk_scan,
)
from pytorch_points_tpu_torch.layers import DenseEdgeConv
from pytorch_points_tpu_torch.losses import RepulsionLoss, UniformLoss
from pytorch_points_tpu_torch.models import (
    PointCloudAutoencoder,
    PointNet2Classifier,
    PointNet2SemSeg,
    PointUpsampler,
)
from pytorch_points_tpu_torch.ops import chamfer_distance, earth_mover_distance
from pytorch_points_tpu_torch.parallel import (
    make_train_step,
    reconstruction_loss,
)
from torch_inputs import (
    BQ_EDGE_NSAMPLES,
    FPS_CASES,
    SCATTER_CASES,
    autoencoder_inputs,
    bq_edge_inputs,
    bq_inputs,
    cloud,
    emd_cloud,
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
        got = fps.furthest_point_sample(xyz, k, mask, seed, True, impl="cuda")
        ref = fps.furthest_point_sample(xyz, k, mask, seed, True, impl="torch")
    _assert_same(got, ref)


def test_fps_cuda_scratch_path(dev):
    # N past the on-chip limit (one block of 16384 points): the streaming
    # kernel, running min-distance in a device scratch buffer.
    n = fps.BLOCK_POINTS + 100
    (xyz,) = _on(dev, cloud(np.random.default_rng(8), 2, n))
    with torch.inference_mode():
        got = fps.furthest_point_sample(xyz, 64, emit_coords=True, impl="cuda")
        ref = fps.furthest_point_sample(xyz, 64, emit_coords=True, impl="torch")
    _assert_same(got, ref)


def _fps_matches_plain(xyz, k, mask=None, seed=None):
    """K1 bitwise equal to the plain version; returns the plain result."""
    with torch.inference_mode():
        ref = fps.furthest_point_sample(xyz, k, mask, seed, True, impl="torch")
        _assert_same(fps.furthest_point_sample(xyz, k, mask, seed, True,
                                               impl="cuda"), ref)
    return ref


@pytest.mark.parametrize("n", [1, 31, 2048, 16384, 16385])
def test_fps_cuda_sizes_match_plain(dev, n):
    # both sides of the on-chip limit: one block up to 16384 points, the
    # streaming kernel past it
    rng = np.random.default_rng(30 + n)
    xyz, mask = _on(dev, cloud(rng, 3, n), rng.uniform(size=(3, n)) < 0.75)
    k = min(n, 200)
    _fps_matches_plain(xyz, k)
    _fps_matches_plain(xyz, k, mask)


FPS_EDGES = {  # name -> (B, N, k, kind, valid count or None, seed)
    "k1": (3, 2048, 1, "random", None, None),
    "k_eq_n": (2, 700, 700, "random", None, None),
    "k_gt_valid": (3, 2048, 300, "random", 100, None),
    "no_valid": (2, 512, 16, "random", 0, None),
    "seed": (3, 4096, 64, "random", None, "random"),
    "seed_last": (3, 4096, 64, "random", None, "last"),
    "masked_seed_last": (2, 4096, 64, "random", 3000, "last"),
    "tie_grid": (2, 4096, 512, "grid", None, None),
    "b1": (1, 16384, 256, "random", None, None),
    "b40": (40, 16384, 64, "random", None, None),
    "onchip_limit": (2, fps.BLOCK_POINTS, 16, "random", None, "last"),
    "streamed": (2, 20000, 64, "random", None, "last"),
}


@pytest.mark.parametrize("case", sorted(FPS_EDGES))
def test_fps_cuda_edges_match_plain(dev, case):
    # k = 1, k = N, k past the valid count (duplicates), no valid point
    # (index 0 throughout), seeds (on the last index too), exact ties at
    # every step, one cloud, 40 clouds, the largest on-chip cloud and a
    # streamed one
    b, n, k, kind, valid, seed = FPS_EDGES[case]
    rng = np.random.default_rng(40)
    xyz = cloud(rng, b, n, kind)
    mask = None if valid is None else np.broadcast_to(
        np.arange(n) < valid, (b, n)).copy()
    if seed == "random":
        seed = rng.integers(0, n, (b,)).astype(np.int32)
    elif seed == "last":
        seed = np.full((b,), n - 1, np.int32)
    xyz, mask, seed = _on(dev, xyz, mask, seed)
    idx, _ = _fps_matches_plain(xyz, k, mask, seed)
    if valid == 0:
        assert (idx == 0).all()
    if valid and valid < k and seed is None:  # duplicates of valid points
        assert (idx[:, valid:] < valid).all()


@pytest.mark.parametrize("n", [2048, 16384, 100000])
def test_fps_step_floor(dev, n):
    cycles, ns = fps.fps_step_floor(n, device=dev)
    assert 0 < cycles < 1e6 and 0 < ns < 1e6


@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_cuda_matches_plain(dev, masked):
    xyz, cen, mask = _on(dev, *bq_inputs(masked))
    with torch.inference_mode():
        got = ballquery.ball_query(xyz, cen, 0.2, 8, mask, impl="cuda")
        ref = ballquery.ball_query(xyz, cen, 0.2, 8, mask, impl="torch")
    _assert_same(got, ref)


@pytest.mark.parametrize("nsample", [8, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_coords_cuda_matches_plain(dev, masked, nsample):
    xyz, cen, mask = bq_inputs(masked)
    if masked:
        mask[:, 0] = False  # zero-hit rows fill from the unpoisoned point 0
    xyz, cen, mask = _on(dev, xyz, cen, mask)
    with torch.inference_mode():
        got = ballquery.ball_query_and_group_coords(xyz, cen, 0.2, nsample,
                                                    mask, impl="cuda")
        ref = ballquery.ball_query_and_group_coords(xyz, cen, 0.2, nsample,
                                                    mask, impl="torch")
        idx, cnt = ballquery.ball_query(xyz, cen, 0.2, nsample, mask,
                                        impl="cuda")
    _assert_same(got, ref)
    _assert_same(got[:2], (idx, cnt))
    assert (got[1] == 0).any()


def _bq_both_match_plain(xyz, cen, radius, nsample, mask=None):
    """Both instances of K2 (the plain query and the coordinate-emitting
    one) bitwise equal to their plain versions, work counters included;
    returns the coordinate instance's (idx, cnt, g, counts)."""
    with torch.inference_mode():
        for fn in (ballquery.ball_query,
                   ballquery.ball_query_and_group_coords):
            res = {}
            for impl in ("cuda", "torch"):
                counts = torch.full(cen.shape[:2], -1, dtype=torch.int32,
                                    device=cen.device)
                res[impl] = (*fn(xyz, cen, radius, nsample, mask,
                                 counts=counts, impl=impl), counts)
            _assert_same(res["cuda"], res["torch"])
    return res["cuda"]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nsample", BQ_EDGE_NSAMPLES)
def test_ball_query_cuda_step_edges_match_plain(dev, nsample, masked):
    # the CPU tests' edges: the nsample-th hit on the last point of a
    # 32-point chunk, of the kernel's 128-point step and of the cloud
    # (N = 333), fewer hits than nsample, zero-hit rows, masked support
    xyz, cen, mask = bq_edge_inputs(nsample, masked)
    if masked:
        mask[:, 0] = False  # zero-hit rows fill from the unpoisoned point 0
    idx, cnt, _, counts = _bq_both_match_plain(*_on(dev, xyz, cen), 0.2,
                                               nsample, *_on(dev, mask))
    assert (cnt[:, 1] == 0).all()
    assert ((counts % ballquery.SCAN_STEP == 0) | (counts == 333)).all()
    if not masked:
        assert (idx[[0, 1, 2, 3], 0, nsample - 1].cpu()
                == torch.tensor([63, 95, 127, 332])).all()


BQ_PATH_SHAPES = {  # B, N, P, radius
    "sa2": (16, 512, 128, 0.4),
    "serve_b32": (32, 16384, 512, 0.2),
    "headline": (32, 16384, 2048, 0.2),
}


@pytest.mark.parametrize("shape", sorted(BQ_PATH_SHAPES))
def test_ball_query_cuda_path_shapes_match_plain(dev, shape):
    # the main paths' shapes, FPS centroids (the kernel's own K1)
    b, n, p, radius = BQ_PATH_SHAPES[shape]
    (xyz,) = _on(dev, cloud(np.random.default_rng(52), b, n))
    with torch.inference_mode():
        cen = fps.furthest_point_sample(xyz, p, emit_coords=True,
                                          impl="cuda")[1]
    _, cnt, _, counts = _bq_both_match_plain(xyz, cen, radius, 32)
    if n == 16384:  # full rows stop early, in whole steps
        assert (counts[cnt == 32] < n).any()


def test_ball_query_cuda_unaligned_support(dev):
    # a support 12 bytes into its storage, N % 4 != 0: the kernel packs it
    # from any alignment
    (base,) = _on(dev, cloud(np.random.default_rng(53), 1, 1002))
    xyz = base[:, 1:]
    assert xyz.is_contiguous() and xyz.data_ptr() % 16
    _bq_both_match_plain(xyz, xyz[:, ::10].contiguous(), 0.2, 32)


def test_bq_group_centered_backward_cuda_matches_plain(dev):
    from pytorch_points_tpu_torch.ops.grouping import _bq_group_centered

    xyz, cen, _ = bq_inputs(False)
    w = np.random.default_rng(22).standard_normal(
        (2, 40, 8, 3)).astype(np.float32)
    xyz, cen, w = _on(dev, xyz, cen, w)
    res = {}
    for impl in ("cuda", "torch"):
        x, c = xyz.clone().requires_grad_(), cen.clone().requires_grad_()
        _, _, g = _bq_group_centered(x, c, 0.2, 8, impl=impl)
        (g * w).sum().backward()
        res[impl] = (g.detach(), x.grad, c.grad)
    _assert_same([res["cuda"][0], res["cuda"][2]],
                 [res["torch"][0], res["torch"][2]])
    # K4 sums in ascending k, the plain version with atomics on the card
    scale = res["torch"][1].abs().max()
    assert ((res["cuda"][1] - res["torch"][1]).abs() <= 1e-5 * scale).all()


def test_nn_worklist_cuda_matches_plain(dev):
    # dyadic grid clouds (ties), a seeded random candidate mask with every
    # tile row and column paired, k_max at the count, then cut below it
    rng = np.random.default_rng(31)
    p, q = _on(dev, emd_cloud(rng, 4, 4096, "grid"),
               emd_cloud(rng, 4, 3000, "grid"))
    pp = distance_tiles._pad_poison(p, 4096, 1.0)
    qp = distance_tiles._pad_poison(q, 3072, -1.0)
    cand = rng.uniform(size=(4, 16, 24)) < 0.3
    cand[:, np.arange(16), rng.integers(0, 24, 16)] = True
    cand[:, rng.integers(0, 16, 24), np.arange(24)] = True
    (cand,) = _on(dev, cand)
    k_max = int(cand.reshape(4, -1).sum(1).max())
    with torch.inference_mode():
        for k in (k_max, k_max - 20):
            got = distance_tiles._run_worklist(cand, pp, qp, 4, 16, 24, 256,
                                               128, 4096, k, impl="cuda")
            ref = distance_tiles._run_worklist(cand, pp, qp, 4, 16, 24, 256,
                                               128, 4096, k, impl="torch")
            _assert_same((*got[0], got[1]), (*ref[0], ref[1]))


WORKLIST_TILES = [(100, 36), (128, 64), (256, 128), (384, 420), (1024, 256),
                  (2048, 640)]


@pytest.mark.parametrize("tn,tm", WORKLIST_TILES)
def test_nn_worklist_cuda_tiles_match_plain(dev, tn, tm):
    # each instance of the pair kernel (1, 2, 4 and 8 rows a thread), rows
    # of a tile short of a warp, p tiles of two slabs, q tiles of two staged
    # chunks and of a ragged column group; dyadic grid clouds (ties)
    rng = np.random.default_rng(37)
    b, ni, nj = 2, 3, 4
    pp, qp = _on(dev, emd_cloud(rng, b, ni * tn, "grid"),
                 emd_cloud(rng, b, nj * tm, "grid"))
    cand = rng.uniform(size=(b, ni, nj)) < 0.5
    cand[:, 0, 0] = True
    (cand,) = _on(dev, cand)
    k_max = int(cand.reshape(b, -1).sum(1).max())
    with torch.inference_mode():
        for k in (k_max, k_max - 3):
            got = distance_tiles._run_worklist(cand, pp, qp, b, ni, nj, tn,
                                               tm, ni * tn, k, impl="cuda")
            ref = distance_tiles._run_worklist(cand, pp, qp, b, ni, nj, tn,
                                               tm, ni * tn, k, impl="torch")
            _assert_same((*got[0], got[1]), (*ref[0], ref[1]))


@pytest.mark.parametrize("cut", [False, True])
def test_nn_worklist_cuda_shuffled_same_bits_twice(dev, cut):
    # q a per-cloud shuffle of p at B=4 N=16384, the pruned NN's own plan,
    # the list whole or cut 40 pairs below the largest count (the p rows no
    # pair reaches stay (inf, 0)); two runs give the same bits
    rng = np.random.default_rng(38)
    p = cloud(rng, 4, 16384)
    p, q = _on(dev, p, np.stack([c[rng.permutation(16384)] for c in p]))
    plan = distance_tiles.pruned_plan(p, q)
    k_max = (int(plan["count"].max()) - 40) if cut else plan["k_max"]
    codes1, codes2, count = distance_tiles._worklist_codes(plan["cand"],
                                                           k_max)
    args = (plan["pp"], plan["qp"], codes1, codes2, count, plan["tn"],
            plan["tm"])
    with torch.inference_mode():
        got = distance_tiles.run_worklist_cuda(*args)
        again = distance_tiles.run_worklist_cuda(*args)
        ref = distance_tiles.run_worklist_torch(*args)
    _assert_same(got, ref)
    _assert_same(got, again)
    assert torch.isinf(got[0]).any() == cut


@pytest.mark.parametrize("kind", ["shuffle", "independent"])
def test_nn_pruned_cuda_matches_plain_and_dense(dev, kind):
    # q a per-cloud shuffle of p: the worklist answers; independent clouds:
    # too many candidate pairs, the dense kernel (K5) answers
    rng = np.random.default_rng(36)
    p = cloud(rng, 2, 16384)
    q = (np.stack([c[rng.permutation(16384)] for c in p])
         if kind == "shuffle" else cloud(rng, 2, 16384))
    p, q = _on(dev, p, q)
    plan = distance_tiles.pruned_plan(p, q)
    assert bool((plan["count"] > plan["k_max"]).any()) == (
        kind == "independent")
    with torch.inference_mode():
        before = distance_tiles.run_worklist_cuda.launches
        got = distance_tiles.nn_both_directions_pruned(p, q, impl="cuda")
        ran = distance_tiles.run_worklist_cuda.launches - before
        ref = distance_tiles.nn_both_directions_pruned(p, q, impl="torch")
        dense = distance_tiles.nn_both_directions(p, q, impl="cuda")
    assert ran == (kind == "shuffle")
    _assert_same(got, ref)
    _assert_same(got, dense)  # tie-free clouds


@pytest.mark.parametrize("c", [1, 3, 4, 5, 8, 128])
def test_gather_cuda_matches_plain(dev, c):
    # C <= 4: a thread a row; C % 4 == 0: 16-byte vectors; else scalars
    rng = np.random.default_rng(3)
    f, idx = _on(dev, rng.standard_normal((2, 500, c)).astype(np.float32),
                 rng.integers(0, 500, (2, 4100)).astype(np.int32))
    with torch.inference_mode():
        got = gather.gather_rows(f, idx, impl="cuda")
        ref = gather.gather_rows(f, idx, impl="torch")
        older = gather.gather_rows_t(f, idx, impl="cuda")
        # rows 4 bytes off a 16-byte boundary take the scalar instance
        odd = torch.empty(f.numel() + 1, device=dev)[1:].view(f.shape)
        odd.copy_(f)
        shifted = gather.gather_rows(odd, idx, impl="cuda")
    _assert_same([got, older, shifted], [ref, ref, ref])


@pytest.mark.parametrize("c", [128, 256])
def test_gather_bf16_cuda_matches_plain(dev, c):
    # the bf16 instance at the bf16 paths' widths: 16-byte vectors, and
    # 2-byte elements for rows off the 16-byte alignment; bitwise (a copy),
    # NaN and infinity patterns included
    rng = np.random.default_rng(6)
    f, idx = _on(dev, rng.standard_normal((3, 700, c)).astype(np.float32),
                 rng.integers(0, 700, (3, 4100)).astype(np.int32))
    f = f.to(torch.bfloat16)
    f[0, 0, 0], f[0, 1, 0] = float("nan"), float("inf")
    idx[0, :2] = torch.tensor([0, 1], device=dev)
    launches = gather.gather_rows_bf16_cuda.launches
    with torch.inference_mode():
        got = gather.gather_rows(f, idx, impl="cuda")
        ref = gather.gather_rows(f, idx, impl="torch")
        # rows 2 bytes off every alignment take the element instance
        odd = torch.empty(f.numel() + 1, dtype=f.dtype, device=dev)[1:]
        odd = odd.view(f.shape)
        odd.copy_(f)
        shifted = gather.gather_rows(odd, idx, impl="cuda")
    assert got.dtype == torch.bfloat16
    assert gather.gather_rows_bf16_cuda.launches == launches + 2
    for g in (got, shifted):
        assert torch.equal(g.view(torch.int16), ref.view(torch.int16))


def test_gather_cuda_rejects_other_dtypes(dev):
    f = torch.zeros((1, 8, 4), dtype=torch.float16, device=dev)
    idx = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="float32"):
        with torch.inference_mode():
            gather.gather_rows_cuda(f, idx)


def test_knn_cuda_takes_bf16(dev):
    # knn casts bf16 clouds to float32 at entry, then runs the kernel
    rng = np.random.default_rng(7)
    q, s = _on(dev, cloud(rng, 2, 300), cloud(rng, 2, 500))
    q, s = q.to(torch.bfloat16), s.to(torch.bfloat16)
    with torch.inference_mode():
        got = topk_scan.knn(q, s, 9, impl="cuda")
        ref = topk_scan.knn_torch(q.float(), s.float(), 9)
    _assert_same(got, ref)


@pytest.mark.parametrize("features", [0, 16])
def test_sample_and_group_sorted_cuda_matches_plain(dev, features):
    """The sorted SA front half's kernels (K1 seeded, K2 on the original
    order, K3) against the plain versions: all five outputs bitwise."""
    from pytorch_points_tpu_torch.ops import sample_and_group_sorted

    rng = np.random.default_rng(8)
    xyz, f = _on(dev, cloud(rng, 4, 4096),
                 rng.standard_normal((4, 4096, features)).astype(np.float32)
                 if features else None)
    with torch.inference_mode():
        got = sample_and_group_sorted(xyz, f, 512, 32, 0.2, impl="cuda")
        ref = sample_and_group_sorted(xyz, f, 512, 32, 0.2, impl="torch")
    _assert_same(got, ref)


def test_remat_batchnorm_step_on_card(dev):
    """One remat step of the BatchNorm autoencoder on the kernels: loss,
    grads (within K4's summation order) and running statistics equal to
    one plain step's."""
    b = {"points": _on(dev, cloud(np.random.default_rng(9), 4, 1024))[0]}
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = PointCloudAutoencoder(128, 32, norm="batch", remat=remat)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), 0.0),
                               reconstruction_loss(emd_weight=0.0))
        loss = step(b).item()
        runs.append((loss, [p.grad.clone() for p in model.parameters()],
                     [t.clone() for t in model.buffers()]))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == l1
    for a, r in zip(g1, g0):
        assert (a - r).abs().max() <= 1e-5 * max(r.abs().max().item(), 1e-12)
    for a, r in zip(s1, s0):
        assert torch.equal(a, r)


@pytest.mark.parametrize("c", [4, 64])
def test_gather_cuda_past_32_bit_offsets(dev, c):
    # B N C above 2^31: the 64-bit index instances, rows read past 2^31
    n = 2**30 // c + 16  # 8.6 GB of features
    f = torch.empty((2, n, c), dtype=torch.float32, device=dev).uniform_()
    rng = np.random.default_rng(5)
    (idx,) = _on(dev, np.concatenate(
        [rng.integers(0, n, (2, 2048)), n - 1 - rng.integers(0, 16, (2, 64))],
        axis=1).astype(np.int32))
    with torch.inference_mode():
        got = gather.gather_rows(f, idx, impl="cuda")
        ref = gather.gather_rows(f, idx, impl="torch")
    _assert_same([got], [ref])


@pytest.mark.parametrize("k", [3, 16, 64, 65, 128])
@pytest.mark.parametrize("kind", ["random", "grid"])
def test_knn_cuda_matches_plain(dev, k, kind):
    # one pass for every k: register lists to 16, heaps past it
    rng = np.random.default_rng(4)
    q, s = _on(dev, cloud(rng, 2, 700, kind), cloud(rng, 2, 1100, kind))
    with torch.inference_mode():
        got = topk_scan.knn(q, s, k, impl="cuda")
        ref = topk_scan.knn(q, s, k, impl="torch")
    _assert_same(got, ref)


@pytest.mark.parametrize("k", [17, 70])
@pytest.mark.parametrize("c", [1, 5, 24, 96])
def test_knn_cuda_any_channels_matches_plain(dev, c, k):
    # the general-C scan: channels staged 32 at a time, summed in order;
    # grid features (k/8) give exact ties
    rng = np.random.default_rng(6)
    q = (rng.integers(0, 8, (2, 600, c)) / 8).astype(np.float32)
    s = rng.standard_normal((2, 900, c)).astype(np.float32)
    s[:, 300:] = (rng.integers(0, 8, (2, 600, c)) / 8)
    q, s = _on(dev, q, s)
    with torch.inference_mode():
        got = topk_scan.knn(q, s, k, impl="cuda")
        ref = topk_scan.knn(q, s, k, impl="torch")
    _assert_same(got, ref)


# K8 in one pass: k at the edges of the register lists (4, 8, 16), the
# shared-memory heaps and the heaps in global scratch (k = 200 and k = Ns
# past 160 keys); supports of no tile's multiple, one query, one cloud (the
# support split across a block's warps), the tie grid and a poisoned
# support (about a quarter of the rows far away, as ops.knn poisons them).
KNN_EDGE_K = (1, 3, 4, 8, 16, 17, 64, 65, 128, 200, "ns")
KNN_EDGE_SHAPES = {  # name -> (B, Nq, Ns, kind)
    "ragged": (3, 333, 1237, "random"),
    "one_query": (2, 1, 777, "random"),
    "one_cloud": (1, 2048, 513, "random"),
    "tie_grid": (2, 700, 1100, "grid"),
    "poisoned": (2, 500, 900, "random"),
}


def _knn_edge_inputs(shape):
    b, nq, ns, kind = KNN_EDGE_SHAPES[shape]
    rng = np.random.default_rng(31)
    q, s = cloud(rng, b, nq, kind), cloud(rng, b, ns, kind)
    if shape == "poisoned":
        mask = torch.from_numpy(rng.uniform(size=(b, ns)) < 0.75)
        s = poison_points(torch.from_numpy(s), mask, sign=-1.0).numpy()
    return q, s


@pytest.mark.parametrize("k", KNN_EDGE_K)
@pytest.mark.parametrize("shape", sorted(KNN_EDGE_SHAPES))
def test_knn_cuda_one_pass_edges_match_plain(dev, shape, k):
    q, s = _on(dev, *_knn_edge_inputs(shape))
    k = s.shape[1] if k == "ns" else k
    with torch.inference_mode():
        got = topk_scan.knn(q, s, k, impl="cuda")
        ref = topk_scan.knn(q, s, k, impl="torch")
    _assert_same(got, ref)


@pytest.mark.parametrize("kind", ["random", "grid"])
@pytest.mark.parametrize("k,c", [(4, 3), (16, 3), (17, 3), (65, 3), (17, 24),
                                 (65, 24)])
def test_knn_cuda_split_lists_match_plain(dev, k, c, kind):
    # few queries over a long support: each query's support splits across
    # a block's warps (a part holds at least 32 list lengths), and the
    # parts' register lists or heaps merge by key
    rng = np.random.default_rng(33)
    if kind == "grid":  # exact ties across the parts
        q = (rng.integers(0, 8, (1, 256, c)) / 8).astype(np.float32)
        s = (rng.integers(0, 8, (1, 6000, c)) / 8).astype(np.float32)
    else:
        q = rng.uniform(-1, 1, (1, 256, c)).astype(np.float32)
        s = rng.uniform(-1, 1, (1, 6000, c)).astype(np.float32)
    q, s = _on(dev, q, s)
    with torch.inference_mode():
        got = topk_scan.knn(q, s, k, impl="cuda", sorted_ok=False)
        ref = topk_scan.knn(q, s, k, impl="torch", sorted_ok=False)
    _assert_same(got, ref)


@pytest.mark.parametrize("k", [1, 3, 16, 17, 65])
@pytest.mark.parametrize("c", [1, 2, 33, 96])
def test_knn_cuda_channel_edges_match_plain(dev, c, k):
    # the any-C tile: a channel count below, at and past one staged slice
    # of 32, rows not a multiple of the 32-row register tile, grid ties
    rng = np.random.default_rng(32)
    q = (rng.integers(0, 4, (2, 333, c)) / 4).astype(np.float32)
    s = (rng.integers(0, 4, (2, 1001, c)) / 4).astype(np.float32)
    s[:, 500:] = rng.standard_normal((2, 501, c))
    q, s = _on(dev, q, s)
    with torch.inference_mode():
        got = topk_scan.knn(q, s, k, impl="cuda")
        ref = topk_scan.knn(q, s, k, impl="torch")
    _assert_same(got, ref)


# K5 and K13: ragged edges (no tile's multiple), one point on either side,
# N > M and N < M, more clouds than one.
NN_DENSE_SHAPES = {  # name -> (B, N, M)
    "n1": (2, 1, 3001),
    "m1": (2, 1000, 1),
    "ragged": (2, 1000, 3001),
    "wide": (4, 5000, 3001),
    "one_cloud": (1, 2048, 2048),
}


@pytest.mark.parametrize("kind", ["random", "grid", "masked"])
@pytest.mark.parametrize("shape", sorted(NN_DENSE_SHAPES))
def test_nn_dense_cuda_shapes_match_plain(dev, shape, kind):
    b, n, m = NN_DENSE_SHAPES[shape]
    p, q = _on(dev, *nn_inputs(kind, n, m, b=b))
    with torch.inference_mode():
        both = distance_tiles.nn_both_directions(p, q, impl="cuda")
        _assert_same(both, distance_tiles.nn_both_directions(p, q,
                                                             impl="torch"))
        one = distance_tiles.nn_one_direction(p, q, impl="cuda")
        _assert_same(one, distance_tiles.nn_one_direction(p, q,
                                                          impl="torch"))
        # both directions in one pass equal two one-direction launches
        back = distance_tiles.nn_one_direction(q, p, impl="cuda")
        _assert_same(both, (*one, *back))


def test_nn_dense_cuda_tie_grid_p_equals_q(dev):
    # every row's own point at d = +0, and the grid's exact ties around it
    p, _ = nn_inputs("grid", 3000, 8)
    (p,) = _on(dev, p)
    with torch.inference_mode():
        got = distance_tiles.nn_both_directions(p, p, impl="cuda")
        ref = distance_tiles.nn_both_directions(p, p, impl="torch")
    _assert_same(got, ref)
    assert (got[0] == 0).all() and (got[2] == 0).all()


def test_nn_dense_cuda_launch_counts(dev):
    p, q = _on(dev, *nn_inputs("random", 700, 600))
    before = (distance_tiles.nn_both_directions_cuda.launches,
              distance_tiles.nn_one_direction_cuda.launches)
    with torch.inference_mode():
        distance_tiles.nn_both_directions(p, q, impl="cuda")
        distance_tiles.nn_one_direction(p, q, impl="cuda")
    assert (distance_tiles.nn_both_directions_cuda.launches - before[0],
            distance_tiles.nn_one_direction_cuda.launches - before[1]) == (
                1, 1)


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


def _scan_inputs(dev, kind, n, m, b=2):
    """(ps, qs, d_ub, qid) on the card as the sorted chamfer gives them to
    K6's scan: sorted, padded, the band's bounds (-1 on padding and, for
    "masked", poisoned rows)."""
    p, q = _on(dev, *nn_inputs(kind, n, m, b))
    n_pad, m_pad = -(-n // 512) * 512, -(-m // 512) * 512
    if kind == "masked":
        pv, qv = (x[..., 0].abs() < 2.0e4 for x in (p, q))
        ps, _, pvs = nn_sorted.sort_by_morton_masked(p, pv)
        qs, perm_q, _ = nn_sorted.sort_by_morton_masked(q, qv)
        pp = nn_sorted._pad_poison(ps, n_pad, 1.0)
        qp = nn_sorted._pad_poison(qs, m_pad, -1.0)
        pvs = torch.nn.functional.pad(pvs, (0, n_pad - n))
        cen = nn_sorted._band_centers(pv.sum(1), qv.sum(1), n_pad // 512,
                                      m_pad // 512, 512)
        band = nn_sorted.band_min_dynamic(pp, qp, cen, impl="torch")
        d_ub = torch.where(pvs, band, -1.0)
    else:
        ps, _ = nn_sorted.sort_by_morton(p)
        qs, perm_q = nn_sorted.sort_by_morton(q)
        pp = nn_sorted._pad_poison(ps, n_pad, 1.0)
        qp = nn_sorted._pad_poison(qs, m_pad, -1.0)
        d_ub = nn_sorted.band_min(pp, qp, tbq=128, stride=4, impl="torch")
        d_ub[:, n:] = -1.0
    return pp, qp, d_ub, nn_sorted._pad_ids(perm_q, m_pad)


def _scan_with_counters(ps, qs, qid, d_ub, impl):
    b, n = d_ub.shape
    ni, nj = n // nn_sorted.TN, qs.shape[1] // nn_sorted.TM
    counts = torch.full((b, ni, 2), -1, dtype=torch.int32, device=ps.device)
    cand = torch.zeros((b, ni, nj), dtype=torch.bool, device=ps.device)
    d, i = nn_sorted.nn_scan(ps, qs, qid, d_ub, cand_out=cand, counts=counts,
                             impl=impl)
    return d, i, counts, cand


@pytest.mark.parametrize("n,m", [(600, 700), (1024, 3000), (4096, 4096)])
@pytest.mark.parametrize("kind", ["random", "grid", "masked"])
def test_nn_scan_cuda_matches_plain(dev, kind, n, m):
    # K6's scan: the mask it writes equals the reference's _cand_mask, d
    # and id equal the plain route (bitwise), the counters its own; every
    # row with a bound gets its dense NN, the others (inf, 2^30)
    ps, qs, d_ub, qid = _scan_inputs(dev, kind, n, m)
    with torch.inference_mode():
        got = _scan_with_counters(ps, qs, qid, d_ub, "cuda")
        ref = _scan_with_counters(ps, qs, qid, d_ub, "torch")
        bare = nn_sorted.nn_scan(ps, qs, qid, d_ub, impl="cuda")
        cand = nn_sorted._cand_mask(ps, qs, d_ub, nn_sorted.FT, nn_sorted.TN,
                                    nn_sorted.TM)
        dense = nn_sorted.nn_resident_torch(ps, qs, qid, cand, nn_sorted.TN,
                                            nn_sorted.TM)
    _assert_same(got, ref)
    _assert_same(bare, got[:2])
    assert torch.equal(got[3], cand)
    ok = d_ub >= 0
    assert torch.equal(got[0][ok], dense[0][ok])
    assert torch.equal(got[1][ok], dense[1][ok])
    assert (got[1][~ok] == nn_sorted.SENTINEL).all()
    assert (got[2][..., 1] <= got[2][..., 0] * nn_sorted.TN
            // nn_sorted.SCAN_WARP_ROWS).all()


def test_nn_scan_cuda_at_the_dynamic_shared_memory_edge(dev):
    # M = 2^18 q points: 4096 q-tiles, whose bitmasks bring the scan's
    # dynamic shared memory to exactly 48 KB, beside its static arrays
    p, q = _on(dev, *nn_inputs("random", 1000, 262144, 1))
    with torch.inference_mode():
        got = nn_sorted.nndistance_indexed(p, q, impl="cuda")
        ref = nn_sorted.nndistance_indexed(p, q, impl="torch")
    _assert_same(got, ref)


def test_nn_scan_cuda_one_far_row(dev):
    # one sorted row of block 0 moved far from its tile-mates: its bound
    # grows and its warp alone takes more tiles (the plain route's per-warp
    # test says which); the kernel's visits grow by just that much
    ps, qs, d_ub, qid = _scan_inputs(dev, "random", 4096, 4096)
    rows, tn, tm = nn_sorted.SCAN_WARP_ROWS, nn_sorted.TN, nn_sorted.TM

    def per_warp(ps, d_ub):  # [B, nI, warps] tiles each warp's rows pass
        return nn_sorted._cand_rows(ps, qs, d_ub, tm, tn, tm, rows).sum(3)

    with torch.inference_mode():
        before = _scan_with_counters(ps, qs, qid, d_ub, "cuda")
        warps0 = per_warp(ps, d_ub)
        far = ps.clone()
        far[:, 3 * rows + 5] = torch.tensor([2.0, -2.0, 2.0], device=dev)
        far_ub = nn_sorted.band_min(far, qs, tbq=128, stride=4, impl="torch")
        got = _scan_with_counters(far, qs, qid, far_ub, "cuda")
        ref = _scan_with_counters(far, qs, qid, far_ub, "torch")
        warps1 = per_warp(far, far_ub)
    _assert_same(got, ref)
    grew = warps1 - warps0
    assert (grew[:, 0, 3] > 0).all()
    grew[:, 0, 3] = 0
    assert (grew == 0).all()  # no other warp changed
    assert torch.equal(got[2][..., 1] - before[2][..., 1],
                       (warps1 - warps0).sum(2).to(torch.int32))


def test_nn_band_cuda_matches_plain(dev):
    p, q = _on(dev, *nn_inputs("random", 2048, 1536))
    ps, _ = nn_sorted.sort_by_morton(p)
    qs, _ = nn_sorted.sort_by_morton(q)
    rng = np.random.default_rng(9)
    (cen,) = _on(dev, rng.integers(0, 3, (2, 4)).astype(np.int32))
    with torch.inference_mode():
        for kw in (dict(tbq=128, stride=4), dict(tbq=512)):
            got = nn_sorted.band_min(ps, qs, impl="cuda", **kw)
            ref = nn_sorted.band_min(ps, qs, impl="torch", **kw)
            _assert_same([got], [ref])
        got = nn_sorted.band_min_dynamic(ps, qs, cen, impl="cuda")
        _assert_same([got], [nn_sorted.band_min_dynamic(ps, qs, cen,
                                                        impl="torch")])


def test_nn_band_dynamic_cuda_matches_plain_at_ragged_masks(dev):
    # K7: ragged valid counts push the centre windows to the clamped edge
    rng = np.random.default_rng(17)
    p, q = _on(dev, cloud(rng, 4, 5000), cloud(rng, 4, 4000))
    pm, qm = _on(dev, np.arange(5000)[None] < np.array([[5000], [3701],
                                                        [2500], [600]]),
                 np.arange(4000)[None] < np.array([[1200], [4000], [3999],
                                                   [2048]]))
    pp, qp = poison_points(p, pm, 1.0), poison_points(q, qm, -1.0)
    ps = nn_sorted._pad_poison(nn_sorted.sort_by_morton_masked(pp, pm)[0],
                               5120, 1.0)
    qs = nn_sorted._pad_poison(nn_sorted.sort_by_morton_masked(qp, qm)[0],
                               4096, -1.0)
    cen = nn_sorted._band_centers(pm.sum(1), qm.sum(1), 10, 8, 512)
    with torch.inference_mode():
        got = nn_sorted.band_min_dynamic(ps, qs, cen, impl="cuda")
        ref = nn_sorted.band_min_dynamic(ps, qs, cen, impl="torch")
        _assert_same([got], [ref])
        got = nn_sorted.nndistance_indexed_masked(pp, qp, impl="cuda")
        ref = nn_sorted.nndistance_indexed_masked(pp, qp, impl="torch")
        dense = distance_tiles.nn_both_directions(pp, qp, impl="cuda")
    _assert_same(got, ref)
    for g, r, v in zip(got, dense, (pm, pm, qm, qm)):
        assert torch.equal(g[v], r[v]) and (g[~v] == 0).all()


def _band_clouds(dev, kind, n, m, b=2):
    """Sorted clouds padded to whole 512-point tiles, on the card."""
    p, q = _on(dev, *nn_inputs(kind, n, m, b))
    ps = nn_sorted._pad_poison(nn_sorted.sort_by_morton(p)[0],
                               -(-n // 512) * 512, 1.0)
    qs = nn_sorted._pad_poison(nn_sorted.sort_by_morton(q)[0],
                               -(-m // 512) * 512, -1.0)
    return ps, qs


def _band_rows_both(fn, b, ni, dev):
    """fn(impl, counts) on the card and in its plain version: (out, the
    (warp, sub-tile) fold counts) of each."""
    outs = []
    for impl in ("cuda", "torch"):
        counts = torch.full((b, ni), -1, dtype=torch.int32, device=dev)
        outs.append((fn(impl, counts), counts))
    return outs


@pytest.mark.parametrize("tbq,stride", [(64, 1), (64, 4), (128, 1),
                                        (128, 4), (512, 1), (512, 4),
                                        (72, 1)])
@pytest.mark.parametrize("kind", ["random", "grid"])
def test_nn_band_rows_cuda_matches_plain(dev, kind, tbq, stride):
    # K6's band through the pipeline's entry: every row, ragged live counts
    # (none a multiple of a warp or a sub-tile), 0 and all; tbq = 72 gives
    # a window of 13.5 sub-tiles. Bits and the fold counter equal the plain
    # version's, and the public band_min equals the all-rows form.
    ps, qs = _band_clouds(dev, kind, 2000, 3000)
    b, n = ps.shape[:2]
    lives = (None, 2000, torch.tensor([1501, 0], dtype=torch.int32,
                                      device=dev), n)
    with torch.inference_mode():
        for live in lives:
            (got, gc), (ref, rc) = _band_rows_both(
                lambda impl, counts, live=live: nn_sorted._band_rows(
                    ps, qs, live, 512, tbq, stride, counts, impl), b, n // 512,
                dev)
            _assert_same([got, gc], [ref, rc])
            assert (gc >= 0).all()
        whole = nn_sorted.band_min(ps, qs, tbq=tbq, stride=stride,
                                   impl="cuda")
        _assert_same([whole], [nn_sorted._band_rows(ps, qs, None, 512, tbq,
                                                    stride, impl="cuda")])


@pytest.mark.parametrize("kind", ["random", "grid"])
def test_nn_band_masked_cuda_matches_plain(dev, kind):
    # K7 through the pipeline: ragged 50-100% valid counts, a wholly
    # poisoned p cloud (count 0) and q cloud (its window all poison); the
    # centres the kernel computes from the counts equal _band_centers (the
    # bounds, -1 past each count, and the fold counter are bitwise the plain
    # version's), and the masked NN still equals K5
    rng = np.random.default_rng(23)
    b, n, m = 4, 5000, 4000
    p, q = _on(dev, cloud(rng, b, n, kind), cloud(rng, b, m, kind))
    vp = np.array([[5000], [3701], [0], [2600]])
    vq = np.array([[2200], [4000], [3999], [0]])
    pm, qm = _on(dev, np.arange(n)[None] < vp, np.arange(m)[None] < vq)
    pp, qp = poison_points(p, pm, 1.0), poison_points(q, qm, -1.0)
    with torch.inference_mode():
        got = nn_sorted._band_bounds_masked(pp, qp, pm, qm, 512, 64, 512,
                                            "cuda")
        ref = nn_sorted._band_bounds_masked(pp, qp, pm, qm, 512, 64, 512,
                                            "torch")
        _assert_same(got, ref)
        sp, sq = got[:2]
        cp, cq = (x.sum(1, dtype=torch.int32) for x in (pm, qm))
        for a, o, ca, co in ((sp, sq, cp, cq), (sq, sp, cq, cp)):
            (out, gc), (plain, rc) = _band_rows_both(
                lambda impl, counts, a=a, o=o, ca=ca, co=co:
                nn_sorted._band_rows_masked(a, o, ca, co, 512, counts, impl),
                b, a.shape[1] // 512, dev)
            _assert_same([out, gc], [plain, rc])
            assert (out[2 if a is sp else 3] == -1).all()
            assert (gc[2 if a is sp else 3] == 0).all()
        nn = nn_sorted.nndistance_indexed_masked(pp, qp, impl="cuda")
        dense = distance_tiles.nn_both_directions(pp, qp, impl="cuda")
    for g, r, v in zip(nn, dense, (pm, pm, qm, qm)):
        assert torch.equal(g[v], r[v]) and (g[~v] == 0).all()


def test_nn_band_cuda_headline_matches_plain(dev):
    # both instances at the headline's B=32 N=M=16384: K6's band on every
    # row (tbq 128, stride 4), K7 on 75% and ragged valid prefixes
    rng = np.random.default_rng(29)
    b, n = 32, 16384
    p, q = _on(dev, cloud(rng, b, n), cloud(rng, b, n))
    with torch.inference_mode():
        ps, qs = nn_sorted.sort_by_morton(p)[0], nn_sorted.sort_by_morton(q)[0]
        (got, gc), (ref, rc) = _band_rows_both(
            lambda impl, counts: nn_sorted._band_rows(
                ps, qs, n, counts=counts, impl=impl), b, n // 512, dev)
        _assert_same([got, gc], [ref, rc])
        for valid in ([3 * n // 4] * b, rng.integers(n // 2, n + 1, b)):
            vp = torch.tensor(valid, dtype=torch.int32, device=dev)
            vq = vp.flip(0).contiguous()
            pm = torch.arange(n, device=dev)[None] < vp[:, None]
            qm = torch.arange(n, device=dev)[None] < vq[:, None]
            pp = nn_sorted.sort_by_morton_masked(
                poison_points(p, pm, 1.0), pm)[0]
            qp = nn_sorted.sort_by_morton_masked(
                poison_points(q, qm, -1.0), qm)[0]
            (got, gc), (ref, rc) = _band_rows_both(
                lambda impl, counts: nn_sorted._band_rows_masked(
                    pp, qp, vp, vq, counts=counts, impl=impl), b, n // 512,
                dev)
            _assert_same([got, gc], [ref, rc])


def _ring_cases(kind, b, nq, ns):
    rng = np.random.default_rng(18)
    q, s = cloud(rng, b, nq, kind), cloud(rng, b, ns, kind)
    if kind == "random":
        s[:, 100:228] = s[:, :128]  # duplicate ties
    return q, s


@pytest.mark.parametrize("k", [5, 16, 33, 100])
@pytest.mark.parametrize("kind", ["random", "grid"])
def test_knn_ring_cuda_matches_plain(dev, kind, k):
    # k = 100: each query's list of 104 entries in global scratch
    # ns=9000 pads the last chunk with the id-2^24 rows
    q, s = _on(dev, *_ring_cases(kind, 2, 3000, 9000))
    n_valid = torch.tensor([[9000], [5432]], device=dev)
    sp = poison_points(s, torch.arange(9000, device=dev)[None] < n_valid,
                       -1.0)
    with torch.inference_mode():
        for masked, sup in ((False, s), (True, sp)):
            qsp, sup4, cen, _ = topk_scan._ring_inputs(q, sup, masked)
            ref = topk_scan.knn_ring_torch(qsp, sup4, k, cen)
            if masked:
                got = topk_scan.knn_ring_masked_cuda(qsp, sup4, k, cen)
            else:
                got = topk_scan.knn_ring_cuda(qsp, sup4, k)
            _assert_same(got[:2], ref[:2])
        qsp, sup4, _, _ = topk_scan._ring_inputs(q, s, False)
        for unroll in (1, 2, 3):
            got = topk_scan.knn_ring_stats_cuda(qsp, sup4, k, unroll)
            ref = topk_scan.knn_ring_torch(qsp, sup4, k, None, unroll, True)
            _assert_same(got, ref)


def _ring_with_counts(dev, qsp, sup4, k, cen=None, stats=False, unroll=2):
    """(kernel, plain) outputs of one ring instance on the same inputs,
    each with its work counter appended."""
    got_c, ref_c = (torch.empty((qsp.shape[0], qsp.shape[1] // 32),
                                dtype=torch.int32, device=dev)
                    for _ in range(2))
    if stats:
        got = topk_scan.knn_ring_stats_cuda(qsp, sup4, k, unroll, got_c)
    elif cen is not None:
        got = topk_scan.knn_ring_masked_cuda(qsp, sup4, k, cen, got_c)
    else:
        got = topk_scan.knn_ring_cuda(qsp, sup4, k, got_c)
    ref = topk_scan.knn_ring_torch(qsp, sup4, k, cen, unroll, stats, ref_c)
    trim = 3 if stats else 2
    return [*got[:trim], got_c], [*ref[:trim], ref_c]


@pytest.mark.parametrize("k", [1, 8, 9, 17, 64, 65, 100, 385])
def test_knn_ring_cuda_list_edges_and_work_counter(dev, k):
    # the lists' edges: 8 | 9 (two register lists), 16 | 17 (registers -> a
    # heap in shared memory), 64 | 65, 384 | 385 (-> a heap in global
    # scratch); Nq = 3001 is no multiple of 32 or 512; ns = 9000 pads the
    # last chunk
    q, s = _on(dev, *_ring_cases("random", 2, 3001, 9000))
    n_valid = torch.tensor([[9000], [5432]], device=dev)
    sp = poison_points(s, torch.arange(9000, device=dev)[None] < n_valid,
                       -1.0)
    with torch.inference_mode():
        for masked, sup in ((False, s), (True, sp)):
            qsp, sup4, cen, _ = topk_scan._ring_inputs(q, sup, masked)
            _assert_same(*_ring_with_counts(dev, qsp, sup4, k, cen))
        qsp, sup4, _, _ = topk_scan._ring_inputs(q, s, False)
        for unroll in (1, 2, 3):
            got, ref = _ring_with_counts(dev, qsp, sup4, k, stats=True,
                                         unroll=unroll)
            _assert_same(got, ref)


def test_knn_ring_cuda_one_far_query_in_a_tile(dev):
    # one query of tile 0 moved to the far corner of the cloud: its warp
    # alone scans more chunks, each other warp scans what it scanned before
    q, s = _on(dev, *_ring_cases("random", 2, 2048, 16384))
    with torch.inference_mode():
        qsp, sup4, _, _ = topk_scan._ring_inputs(q, s, False)
        before, ref = _ring_with_counts(dev, qsp, sup4, 16, stats=True)
        _assert_same(before, ref)
        qsp[:, 40] = -qsp[:, 40].sign()  # warp 1 of tile 0
        got, ref = _ring_with_counts(dev, qsp, sup4, 16)
        _assert_same(got, ref)
        got, ref = _ring_with_counts(dev, qsp, sup4, 16, stats=True)
        _assert_same(got, ref)
    counts, counts0 = got[3], before[3]
    others = [w for w in range(counts.shape[1]) if w != 1]
    assert torch.equal(counts[:, others], counts0[:, others])
    assert (counts[:, 1] > counts0[:, 1]).all()
    assert (got[2][:, 0, 0] >= before[2][:, 0, 0]).all()


def test_knn_ring_cuda_matches_stream_at_scale(dev):
    # the reference's at-scale cross-checks: K9 and K10 against K8 at N=16384
    x = cloud(np.random.default_rng(19), 2, 16384)
    x[:, 1000:1128] = x[:, :128]  # forced duplicate ties
    (x,) = _on(dev, x)
    n_valid = torch.tensor([[16384], [12211]], device=dev)
    xp = poison_points(x, torch.arange(16384, device=dev)[None] < n_valid,
                       -1.0)
    with torch.inference_mode():
        _assert_same(topk_scan.knn(x, x, 16, impl="cuda"),
                     topk_scan.knn(x, x, 16, impl="cuda", sorted_ok=False))
        got = topk_scan.knn(x, xp, 16, impl="cuda", masked=True)
        _assert_same(got, topk_scan.knn(x, xp, 16, impl="cuda",
                                        sorted_ok=False))
    assert (got[1] < n_valid[:, :, None]).all()


def test_autoencoder_backward_cuda_matches_plain(dev):
    xyz, _ = autoencoder_inputs(masked=False)
    (x,) = _on(dev, xyz)
    model = PointCloudAutoencoder(npoint1=128, npoint2=32, device=dev)
    grads = {}
    for impl in ("cuda", "torch"):
        model.zero_grad(set_to_none=True)
        reconstruction_loss(emd_weight=0, impl=impl)(
            model, {"points": x}).backward()
        grads[impl] = [p.grad.clone() for p in model.parameters()]
    for got, ref in zip(grads["cuda"], grads["torch"]):
        scale = ref.abs().max().item()
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * scale)


# (kind, b, n, max_iters, pop_cap, masked): N=500 pads to 512; the masked
# case poisons ~20% of both clouds by rank, as earth_mover_distance does.
# N' = 256, 1024, 2048 and 4096 span K12's default blocks (4 columns a
# thread on 64 to 1024 threads) and K11's cluster sizes; B = 140 is more
# clouds than SMs; kind "same" (q = p, 20 sweeps a phase) leaves K12 no
# straggler.
AUCTION_CASES = {
    "normal": ("normal", 4, 512, 15, 768, False),
    "gmm": ("gmm", 4, 512, 15, 768, False),
    "grid_ties": ("grid", 4, 512, 15, 768, False),
    "padded": ("normal", 3, 500, 15, 768, False),
    "masked": ("normal", 4, 512, 15, 768, True),
    "pop8": ("normal", 4, 512, 3, 8, False),
    "pop1": ("normal", 4, 512, 3, 1, False),
    "n256": ("normal", 4, 256, 15, 768, False),
    "n1024": ("normal", 2, 1024, 15, 768, False),
    "n2048": ("normal", 2, 2048, 15, 768, False),
    "n4096": ("normal", 1, 4096, 15, 768, False),
    "b140": ("normal", 140, 256, 15, 768, False),
    "no_stragglers": ("same", 4, 512, 20, 768, False),
}


def _auction_inputs(case):
    kind, b, n, iters, pop, masked = AUCTION_CASES[case]
    rng = np.random.default_rng(13)
    if kind == "same":
        p = emd_cloud(rng, b, n, "normal")
        q = p.copy()
    else:
        p, q = emd_cloud(rng, b, n, kind), emd_cloud(rng, b, n, kind)
    if masked:
        from pytorch_points_tpu_torch.ops.emd import _poison_rank_matched

        keep = rng.permutation(n)[: n * 4 // 5]
        pm = np.isin(np.arange(n), keep)[None].repeat(b, 0)
        qm = np.isin(np.arange(n), rng.permutation(n)[: n * 4 // 5])[None]
        p = _poison_rank_matched(torch.from_numpy(p), torch.from_numpy(pm))
        q = _poison_rank_matched(torch.from_numpy(q),
                                 torch.from_numpy(qm.repeat(b, 0)))
        p, q = p.numpy(), q.numpy()
    return p, q, iters, pop


@pytest.mark.parametrize("case", sorted(AUCTION_CASES))
def test_auction_and_augment_cuda_match_plain(dev, case):
    p, q, iters, pop = _auction_inputs(case)
    p, q = _on(dev, p, q)
    out = {}
    for impl in ("cuda", "torch"):
        owner, price, pp, qp = auction._auction_owner(p, q, 0.005, iters, 256,
                                                      3, 6.0, impl=impl)
        out[impl] = (owner, price, *auction._residual_rounds(
            owner, price, pp, qp, 0.005, pop, impl=impl))
    _assert_same(out["cuda"], out["torch"])
    assert (out["cuda"][2] >= 0).all()
    if case == "no_stragglers":
        assert (out["cuda"][0] >= 0).all()


def _stragglers(n, b=2, seed=16):
    """Padded config-4-like clouds [b, n, 3] after a short K11 (2 sweeps a
    phase, plain version): many stragglers for K12."""
    rng = np.random.default_rng(seed)
    p, q = (torch.from_numpy(emd_cloud(rng, b, n, "normal")) for _ in "pq")
    owner, price, pp, qp = auction._auction_owner(
        p, q, 0.005, 2, min(n, 256), 3, 6.0, impl="torch")
    return owner, price, pp, qp


# (N', pop cap) at K12's blocks of 4 columns a thread: 128 on 32 threads,
# 768 on 256 (256 columns past N', which start scanned), 2048 on 512 and
# 4096 on 1024; 4352 past them (1024 threads, the columns in the state
# arrays in the scratch buffer), where a pop cap of 16 is reached.
AUGMENT_BLOCKS = [(128, 48), (768, 48), (2048, 48), (4096, 48), (4352, 16)]


@pytest.mark.parametrize("n,pop", AUGMENT_BLOCKS)
def test_augment_cuda_blocks_match_plain(dev, n, pop):
    owner, price, pp, qp = _on(dev, *_stragglers(n))
    assert pp.shape[1] == n
    cap = 128  # the first 128 stragglers a cloud: the plain loop is slow
    got_c = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    ref_c = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    got = auction.augment_cuda(owner, price, pp, qp, 0.005, pop, cap, got_c)
    ref = auction.augment_torch(owner, price, pp, qp, 0.005, pop, cap, ref_c)
    _assert_same((*got, got_c), (*ref, ref_c))
    assert (got_c[:, 1] > 0).any()  # the pop cap was reached


def test_auction_and_augment_cuda_counts_match_plain(dev):
    # config 4's clouds at B=4: bidder scans and sweeps a phase, pops and
    # capped stragglers a cloud, equal to the plain versions'
    rng = np.random.default_rng(5)
    p, q = _on(dev, emd_cloud(rng, 4, 2048, "normal"),
               emd_cloud(rng, 4, 2048, "normal"))
    eps_k = auction.phase_schedule(0.005, 3, 6.0)
    ladders = ([15, 15, 15], [40, 25, 15])
    hint = auction._hardness_hint(p, q)
    counts = {}
    for impl, k11, k12 in (("cuda", auction.auction_cuda,
                            auction.augment_cuda),
                           ("torch", auction.auction_torch,
                            auction.augment_torch)):
        c11 = torch.zeros((4, 2, 3), dtype=torch.int32, device=dev)
        c12 = torch.zeros((4, 2), dtype=torch.int32, device=dev)
        owner, price = k11(p, q, eps_k, ladders, hint, 256, True, c11)
        out = k12(owner, price, p, q, 0.005, 768, 4096, c12)
        counts[impl] = (owner, price, *out, c11, c12)
    _assert_same(counts["cuda"], counts["torch"])
    c11, c12 = counts["cuda"][-2:]
    assert (c11[:, 0, 0] > 2048).all() and (c11[:, 1] >= 1).all()
    assert (c12[:, 0] >= (counts["cuda"][0] < 0).sum(1)).all()


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_auction_cuda_cluster_sizes_match_plain(dev, cluster):
    # a cloud on 1 (one block), 2, 4 or 8 blocks of a cluster, each with a
    # slice of the objects: owners, prices and counters as the plain one's
    rng = np.random.default_rng(18)
    p, q = _on(dev, emd_cloud(rng, 4, 2048, "normal"),
               emd_cloud(rng, 4, 2048, "gmm"))
    eps_k = auction.phase_schedule(0.005, 3, 6.0)
    ladders = ([6, 6, 6], [6, 6, 6])
    c_got = torch.zeros((4, 2, 3), dtype=torch.int32, device=dev)
    c_ref = torch.zeros((4, 2, 3), dtype=torch.int32, device=dev)
    got = auction.auction_cuda(p, q, eps_k, ladders, None, 256, True, c_got,
                               cluster)
    ref = auction.auction_torch(p, q, eps_k, ladders, None, 256, True, c_ref)
    _assert_same((*got, c_got), (*ref, c_ref))


def test_auction_cuda_cluster_size_near_the_shared_memory_limit(dev):
    # N' = 4648: a cluster of 3 needs 232,160 bytes a block, above what a
    # block may opt into beside K11's static arrays; 2 fit. The lookup
    # skips 3 without leaving an error for the launch to report, and asks
    # once a shape. 4648 is no multiple of ti: the last 40 persons never
    # bid, and the warm start folds only the persons of whole chunks.
    rng = np.random.default_rng(19)
    p, q = _on(dev, emd_cloud(rng, 2, 4648, "normal"),
               emd_cloud(rng, 2, 4648, "normal"))
    assert auction.auction_cluster_size(2, 4648, 256) == 2
    assert auction.auction_cluster_size(2, 4648, 256) == 2
    eps_k = auction.phase_schedule(0.005, 3, 6.0)
    ladders = ([3, 3, 3], [3, 3, 3])
    ref = auction.auction_torch(p, q, eps_k, ladders, None, 256, True)
    for cluster in (0, 1):
        got = auction.auction_cuda(p, q, eps_k, ladders, None, 256, True,
                                   cluster=cluster)
        _assert_same(got, ref)


def test_augment_cuda_pop_floor(dev):
    # the measurement aid: a positive cycle count a round on K12's block for
    # N' = 128 (32 threads), 2048 (512) and 6144 (1024)
    for n in (128, 2048, 6144):
        cycles, ns = auction.augment_pop_floor(n, iters=64, device=dev)
        assert cycles > 0 and ns > 0


@pytest.mark.parametrize("hint", [False, True])
def test_auction_cuda_reads_the_hint_on_the_card(dev, hint):
    p, q, _, _ = _auction_inputs("normal")
    p, q = _on(dev, p, q)
    flag = torch.tensor(hint, device=dev)
    got = auction._auction_owner(p, q, 0.005, 2, 256, 3, 6.0, (), True, flag,
                                 (4, 3, 2), impl="cuda")
    ref = auction._auction_owner(p, q, 0.005, 2, 256, 3, 6.0, (), True, flag,
                                 (4, 3, 2), impl="torch")
    _assert_same(got[:2], ref[:2])


def test_auction_cuda_takes_nine_phases(dev):
    # past the 8 phases one launch holds: a second launch warm-starts from
    # the first one's prices
    p, q, _, _ = _auction_inputs("normal")
    p, q = _on(dev, p, q)
    flag = torch.tensor(True, device=dev)
    ladder = (4, 3, 2, 2, 2, 2, 2, 2, 3)
    got = auction._auction_owner(p, q, 0.005, 2, 256, 9, 2.0, (), True, flag,
                                 ladder, impl="cuda")
    ref = auction._auction_owner(p, q, 0.005, 2, 256, 9, 2.0, (), True, flag,
                                 ladder, impl="torch")
    _assert_same(got[:2], ref[:2])


def test_scatter_cuda_launches_two_kernels_a_call(dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    idx, upd, n = scatter_inputs("large")
    i, u = _on(dev, idx, upd)
    scatter.scatter_add(i, u, n, impl="cuda")  # builds
    torch.cuda.synchronize()
    # a trace can lose its first device items: it opens on a short spin
    # kernel, and only the items after the spin are counted
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            scatter.scatter_add(i, u, n, impl="cuda")
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        marks = [e.time_range.start for e in device
                 if "spin_kernel" in e.name]
        if marks:
            break
    assert marks, "every trace lost its opening spin kernel"
    kernels = [e for e in device if e.time_range.start > max(marks)]
    assert len(kernels) == 2, [e.name for e in kernels]


def test_auction_and_augment_cuda_scratch_path(dev):
    # state above the shared-memory budget: kept in a global scratch buffer
    rng = np.random.default_rng(14)
    p, q = _on(dev, emd_cloud(rng, 1, 6144, "normal"),
               emd_cloud(rng, 1, 6144, "normal"))
    assert auction._SMEM_MAX_BYTES < min(
        auction._build.library().ppt_auction_state_bytes(6144, 256),
        auction._build.library().ppt_augment_state_bytes(6144))
    out = {}
    for impl in ("cuda", "torch"):
        owner, price, pp, qp = auction._auction_owner(p, q, 0.005, 3, 256, 3,
                                                      6.0, impl=impl)
        out[impl] = (owner, price, *auction._residual_rounds(
            owner, price, pp, qp, 0.005, 64, impl=impl))
    _assert_same(out["cuda"], out["torch"])


def test_augment_cuda_columns_in_memory_scratch_path(dev):
    # 6144 columns on 1024 threads: past 4 columns a thread, so dist and
    # the scanned flags stay in the state arrays, in the scratch buffer; on
    # K12 alone, from many stragglers (the test above reaches it after K11)
    owner, price, pp, qp = _on(dev, *_stragglers(6144, b=1, seed=17))
    assert auction._SMEM_MAX_BYTES < auction._build.library(
        ).ppt_augment_state_bytes(6144)
    got = auction.augment_cuda(owner, price, pp, qp, 0.005, 32, 256)
    ref = auction.augment_torch(owner, price, pp, qp, 0.005, 32, 256)
    _assert_same(got, ref)


def test_emd_cuda_grads_match_plain(dev):
    rng = np.random.default_rng(15)
    p, q = _on(dev, emd_cloud(rng, 4, 1024, "normal"),
               emd_cloud(rng, 4, 1024, "normal"))
    w = torch.from_numpy(rng.standard_normal((4, 1024)).astype(np.float32))
    res = {}
    for impl in ("cuda", "torch"):
        x, y = p.clone().requires_grad_(), q.clone().requires_grad_()
        dist, assign = earth_mover_distance(x, y, impl=impl)
        (dist * w.to(dev)).sum().backward()
        res[impl] = (dist, assign, x.grad, y.grad)
    # a permutation: the scatter of the q grad is exact in both versions
    _assert_same(res["cuda"], res["torch"])


def test_emd_forward_and_backward_make_no_host_sync(dev):
    """Below the endgame's cap every person ends with an object, so the
    greedy backstop (a host loop) is skipped, and the scatter (K4) finds
    its row offsets on the card: the EMD forward, hint and ladder choice
    included, and its backward queue on the card without a sync."""
    rng = np.random.default_rng(16)
    p, q = _on(dev, emd_cloud(rng, 4, 1000, "gmm"),
               emd_cloud(rng, 4, 1000, "gmm"))
    p.requires_grad_()
    q.requires_grad_()
    auction._build.library()  # the first call builds; building syncs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dist, assign = earth_mover_distance(p, q)
        dist.sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (torch.sort(assign, 1).values
            == torch.arange(1000, device=dev, dtype=torch.int32)).all()
    assert torch.isfinite(dist).all()
    # a permutation: q's grad is minus p's, moved to the matched rows
    assert torch.equal(q.grad.gather(1, assign.long()[..., None].expand(
        -1, -1, 3)), -p.grad)


def test_config5_train_step_makes_no_host_sync(dev):
    """A config-5 step (Chamfer + 0.1 EMD at EMDLoss's pop cap) queues on
    the card, forward, backward and Adam, without a host sync: only reading
    its loss waits."""
    xyz, _ = autoencoder_inputs(masked=False)
    (x,) = _on(dev, xyz)
    model = PointCloudAutoencoder(npoint1=128, npoint2=32, device=dev)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), 1e-3),
                           reconstruction_loss(emd_kwargs={
                               "endgame_pop_cap": 384}))
    step({"points": x}).item()  # builds the kernels and Adam's state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step({"points": x})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(loss.item())


def _new_model_case(name, dev):
    """(model, inputs, loss(output)) of one of config 7's and config 8's
    modules at a card-test size: config 7's paths at their full widths
    (the upsampler from 2048 to 8192 points, so its Chamfer takes the
    sorted scan and its repulsion the ring kNN), config 8's at the sizes
    of the autoencoder's card tests."""
    rng = np.random.default_rng(17)
    if name.startswith("edgeconv"):
        f, w = _on(dev, rng.standard_normal((2, 2048, 24)).astype(np.float32),
                   rng.standard_normal((2, 2048, 96)).astype(np.float32))
        xyz, mask = _on(dev, cloud(rng, 2, 2048), rng.uniform(
            size=(2, 2048)) < 0.75)
        model = DenseEdgeConv(24, 24, device=dev)
        inputs = ((f,), dict(xyz=None if name == "edgeconv_features" else xyz,
                             mask=mask))
        return model, inputs, lambda out: (out * w).sum()
    if name == "upsampler":
        x, gt = _on(dev, cloud(rng, 2, 2048), cloud(rng, 2, 8192))
        return (PointUpsampler(device=dev), ((x,), {}),
                lambda out: chamfer_distance(out, gt)
                + 0.1 * RepulsionLoss()(out))
    xyz, mask = autoencoder_inputs(masked=True)
    x, m = _on(dev, xyz, mask)
    if name == "semseg":
        labels = torch.from_numpy(rng.integers(0, 13, xyz.shape[:2])).to(dev)
        return (PointNet2SemSeg(13, npoint1=128, npoint2=32, device=dev),
                ((x,), dict(mask=m)),
                lambda out: torch.nn.functional.cross_entropy(
                    out.reshape(-1, 13), labels.reshape(-1)))
    labels = torch.from_numpy(rng.integers(0, 40, xyz.shape[:1])).to(dev)
    return (PointNet2Classifier(40, device=dev), ((x,), dict(mask=m)),
            lambda out: torch.nn.functional.cross_entropy(out, labels))


@pytest.mark.parametrize("name", ["edgeconv_xyz", "edgeconv_features",
                                  "upsampler", "semseg", "classifier"])
def test_config7_and_8_modules_cuda_match_plain(dev, name):
    """Forward within 1e-5 of the plain versions on the card; one backward,
    each parameter grad within 1e-4 of the plain version's largest."""
    model, (args, kw), loss = _new_model_case(name, dev)
    with torch.inference_mode():
        got = model(*args, **kw, impl="cuda")
        ref = model(*args, **kw, impl="torch")
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    grads = {}
    for impl in ("cuda", "torch"):
        model.zero_grad(set_to_none=True)
        loss(model(*args, **kw, impl=impl)).backward()
        grads[impl] = [p.grad.clone() for p in model.parameters()]
    for g, r in zip(grads["cuda"], grads["torch"], strict=True):
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-4 * r.abs().max().item())


@pytest.mark.parametrize("masked", [False, True])
def test_repulsion_and_uniform_losses_cuda_match_plain(dev, masked):
    """Config 7's losses on an 8192-point cloud: the repulsion through the
    ring kNN (K9, or K10 masked) and its input grad, the uniformity's counts
    through FPS (K1) and the gather (K3), equal to the plain versions."""
    rng = np.random.default_rng(18)
    x, mask = _on(dev, cloud(rng, 2, 8192),
                  rng.uniform(size=(2, 8192)) < 0.75 if masked else None)
    out = {}
    for impl in ("cuda", "torch"):
        xi = x.clone().requires_grad_()
        rep = RepulsionLoss(impl=impl)(xi, mask)
        rep.backward()
        out[impl] = (rep.detach(), xi.grad,
                     UniformLoss(impl=impl)(x, mask))
    torch.testing.assert_close(out["cuda"][0], out["torch"][0], rtol=1e-6,
                               atol=0)
    scale = out["torch"][1].abs().max().item()
    torch.testing.assert_close(out["cuda"][1], out["torch"][1], rtol=0,
                               atol=1e-4 * scale)
    assert torch.equal(out["cuda"][2], out["torch"][2])


# ---------------------------------------------------------------------------
# The host side on the card: config 10's trainer, export, augmentation
# ---------------------------------------------------------------------------


def _masked_chamfer_loss(m, batch, impl="auto"):
    pred = m(batch["points"], batch["mask"], impl=impl)
    return chamfer_distance(pred, batch["points"], p_mask=batch["mask"],
                            q_mask=batch["mask"], impl=impl)


def test_trainer_step_cuda_matches_plain(dev, tmp_path):
    """Config 10's path at a small size: PLY files -> BucketedBatcher ->
    Prefetcher -> Trainer on the card; the first step's loss and grads on
    the kernels against the plain versions (loss rtol 1e-5, grads 1e-4 of
    each tensor's largest), then three steps with finite losses."""
    from pytorch_points_tpu_torch.data import BucketedBatcher, PlyFolderDataset
    from pytorch_points_tpu_torch.utils import Trainer
    from torch_inputs import write_ply_clouds

    ds = PlyFolderDataset(write_ply_clouds(tmp_path / "ply"))
    batcher = BucketedBatcher(ds, 2, multiple=128, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in batcher]
    model = PointCloudAutoencoder(npoint1=32, npoint2=8, device=dev)
    first = {}
    for impl in ("cuda", "torch"):
        model.zero_grad(set_to_none=True)
        loss = _masked_chamfer_loss(model, batches[0], impl)
        loss.backward()
        first[impl] = (loss.item(), [p.grad.clone()
                                     for p in model.parameters()])
    torch.testing.assert_close(first["cuda"][0], first["torch"][0],
                               rtol=1e-5, atol=0)
    for got, ref in zip(first["cuda"][1], first["torch"][1]):
        scale = ref.abs().max().item()
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * scale)
    losses = []
    tr = Trainer(model, torch.optim.Adam(model.parameters(), 1e-3),
                 _masked_chamfer_loss, ckpt_dir=str(tmp_path / "ckpt"),
                 log_every=1)
    tr.fit(iter(batches), steps=3, on_log=lambda s, v: losses.append(v))
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert (tmp_path / "ckpt" / "3").is_dir()


def test_export_forward_cuda_roundtrip(dev, tmp_path):
    """export_forward on the card records the kernels as ppt:: ops; the
    loaded program launches them and equals the eager forward bitwise."""
    from pytorch_points_tpu_torch.utils import export_forward, load_exported

    xyz, _ = autoencoder_inputs(masked=False, b=2, n=256)
    (x,) = _on(dev, xyz)
    model = PointCloudAutoencoder(npoint1=64, npoint2=16, device=dev).eval()
    with torch.no_grad():
        export_forward(model, x, path=str(tmp_path / "ae.pt2"))
        program = load_exported(str(tmp_path / "ae.pt2"))
        wrappers = (fps.fps_cuda, ballquery.ball_query_cuda,
                    gather.gather_rows_cuda, topk_scan.knn_cuda)
        before = [w.launches for w in wrappers]
        got = program(x)
        assert all(w.launches > n for w, n in zip(wrappers, before))
        assert torch.equal(got, model(x))


def test_augment_with_a_cuda_generator(dev):
    """Augmentation and random_sample draw on the card from a CUDA
    generator: the same seed gives the same draw, padding is untouched,
    and a CPU generator cannot drive a CUDA tensor."""
    from pytorch_points_tpu_torch.data import augment
    from pytorch_points_tpu_torch.ops import random_sample

    (x,) = _on(dev, cloud(np.random.default_rng(3), 4, 256))
    mask = (torch.arange(256, device=dev)[None] < 200).expand(4, 256)

    def gen(seed=0):
        return torch.Generator(device=dev).manual_seed(seed)

    for fn in (lambda g: augment.jitter(g, x, mask=mask),
               lambda g: augment.rotate(g, x, mask=mask),
               lambda g: augment.random_scale(g, x, mask=mask),
               lambda g: augment.random_dropout(g, x, 0.9, mask=mask)[1],
               lambda g: random_sample(x, 64, g, mask=mask)[0]):
        out = fn(gen())
        assert out.is_cuda and torch.equal(out, fn(gen()))
        if out.shape == x.shape:
            assert torch.equal(out[~mask], x[~mask])
    r = augment.rotate(gen(), x)
    torch.testing.assert_close(r.norm(dim=-1), x.norm(dim=-1), rtol=1e-5,
                               atol=1e-6)
    _, keep = augment.random_dropout(gen(), x, 1.0, mask=mask)
    assert keep.any(dim=1).all() and not (keep & ~mask).any()
    with pytest.raises(RuntimeError):
        augment.jitter(torch.Generator().manual_seed(0), x)


def test_emd_unequal_valid_counts_on_the_card(dev):
    """Masks with unequal valid counts (30 against 35 of 40): the greedy
    backstop runs, and the card gives the CPU's assignment (held to the
    reference by test_torch_emd.py)."""
    rng = np.random.default_rng(5)
    p = rng.uniform(-1, 1, (1, 40, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (1, 40, 3)).astype(np.float32)
    pm, qm = np.arange(40)[None] < 30, np.arange(40)[None] < 35
    want = earth_mover_distance(*(torch.from_numpy(a) for a in (p, q)),
                                p_mask=torch.from_numpy(pm),
                                q_mask=torch.from_numpy(qm))
    got = earth_mover_distance(*_on(dev, p, q), p_mask=_on(dev, pm)[0],
                               q_mask=_on(dev, qm)[0])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert (got[1][0, :30] < 40).all()


def test_nndistance_sharded_world1_runs_k13(dev, tmp_path):
    """World 1 over NCCL: the sharded NN launches K13 twice and equals the
    one-device K5 bit for bit."""
    import torch.distributed as dist

    from pytorch_points_tpu_torch.parallel import make_mesh, nndistance_sharded

    rng = np.random.default_rng(6)
    p, q = _on(dev, emd_cloud(rng, 2, 700, "grid"),
               emd_cloud(rng, 2, 900, "grid"))
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh({"points": 1})
        k13 = distance_tiles.nn_one_direction_cuda.launches
        got = nndistance_sharded(p, q, mesh)
        launches = distance_tiles.nn_one_direction_cuda.launches - k13
    finally:
        dist.destroy_process_group()
    want = distance_tiles.nn_both_directions(p, q)
    assert launches == 2
    _assert_same(got, want)


def test_gloo_collectives_on_cuda_tensors(dev, tmp_path):
    """Two ranks on one card over gloo: the gathers, sums and the
    host-staged ring shift the parallel ops use, their autograd rules, and
    the sharded NN and ring against the one-device K5."""
    from torch_parallel_ranks import Ranks

    world = 2
    ranks = Ranks(tmp_path, {}, world=world, deadline=120.0,
                  mode="cuda").results
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["gather"][:, 0, 0], [1.0, 2.0])
        np.testing.assert_array_equal(out["gather_u8"][:, 0, 0], [1, 2])
        np.testing.assert_array_equal(out["psum"], np.full((3, 2), 3.0))
        prev = (r - 1) % world + 1
        np.testing.assert_array_equal(out["ring"][0], np.full((3, 2), prev))
        np.testing.assert_array_equal(out["ring"][1],
                                      np.full((3, 2), 10 * prev))
        whole, loss, grad = out["autograd"]
        np.testing.assert_array_equal(whole[::3, 0], [1.0, 2.0])
        # loss = sum over ranks s of (s + 1) * sum(whole): its gradient on
        # each rank's shard is 1 + 2
        assert loss == 3 * 6 * 3.0
        np.testing.assert_array_equal(grad, np.full((3, 2), 3.0))
        assert out["nn_equal"] == [True] * 4
        assert out["ring_equal"] == [True] * 4
        assert out["nn_k13_launches"] == 2


def test_span_clock_is_the_trace_clock(dev):
    """The span recorder stamps on the clock of the profiler's runtime
    calls: inside one span, a kernel, 5 ms of host sleep, a second kernel,
    in five rounds under one profiler. In the closest round the span opens
    within 50 us before the first launch call (the rest is the op's own
    dispatch); in every round the gap before the second kernel is labelled
    by the span (the host was behind) and every device item falls under
    the span."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from pytorch_points_tpu_torch.utils import profiling

    x = torch.zeros(1 << 16, device=dev)
    x.add_(1)
    x.mul_(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            for _ in range(5):
                with profiling.op_scope("clock"):
                    x.add_(1)
                    time.sleep(0.005)
                    x.mul_(2)
                torch.cuda.synchronize()
    evs = profiling.events(prof)
    launches = sorted(e.start_ns for e in evs
                      if not e.device and e.name.startswith("cudaLaunch"))
    assert len(rec.spans) == 5 and len(launches) == 10
    leads = [launch - span.start_ns
             for launch, span in zip(launches[::2], rec.spans)]
    assert all(lead >= 0 for lead in leads), leads
    assert min(leads) < 50_000, leads
    att = profiling.attribute(evs, rec.spans)
    assert att.unattributed_s == 0
    assert att.device_s("ppt.clock") == pytest.approx(att.busy_s)
    long = [g for g in att.gaps if g[1] > 0.004]
    assert len(long) == 5 and all(g[0] == "ppt.clock" for g in long), (
        att.gaps)
