"""Seeded numpy inputs shared by the port's tests (numpy only, so the tests
that run on the card need no JAX)."""

import numpy as np

FPS_CASES = {
    "random": dict(n=300, k=40, kind="random"),
    "masked": dict(n=300, k=40, kind="random", masked=True),
    "seed": dict(n=300, k=40, kind="random", seed=True),
    "tie_grid": dict(n=256, k=48, kind="grid"),
    "k_gt_valid": dict(n=64, k=40, kind="random", valid=20),
}


def cloud(rng, b, n, kind="random"):
    if kind == "grid":  # many exact distance ties
        return (rng.integers(0, 8, (b, n, 3)) / 8).astype(np.float32)
    return rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)


def emd_cloud(rng, b, n, kind):
    """[B,N,3] f32 clouds for the EMD tests: "grid" (the dyadic grid k/64,
    every distance exact in f32, many ties), "normal", "uniform" or "gmm"
    (8 gaussian clusters of spread 0.15, as bench.py draws them)."""
    if kind == "grid":
        return (rng.integers(-64, 65, (b, n, 3)) / 64).astype(np.float32)
    if kind == "normal":
        return rng.standard_normal((b, n, 3)).astype(np.float32)
    if kind == "uniform":
        return rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    centers = rng.uniform(-1, 1, (b, 8, 3))
    which = rng.integers(0, 8, (b, n))
    return (centers[np.arange(b)[:, None], which]
            + 0.15 * rng.standard_normal((b, n, 3))).astype(np.float32)


def valid_mask(rng, b, n, frac=0.75):
    return rng.uniform(size=(b, n)) < frac


def fps_inputs(case, b=2):
    """(xyz, k, mask or None, seed_idx or None) for FPS_CASES[case]."""
    cfg = FPS_CASES[case]
    rng = np.random.default_rng(1)
    xyz = cloud(rng, b, cfg["n"], cfg["kind"])
    mask = seed = None
    if cfg.get("masked"):
        mask = valid_mask(rng, b, cfg["n"])
    if "valid" in cfg:
        mask = np.broadcast_to(np.arange(cfg["n"]) < cfg["valid"],
                               (b, cfg["n"])).copy()
    if cfg.get("seed"):
        seed = rng.integers(0, cfg["n"], (b,)).astype(np.int32)
    return xyz, cfg["k"], mask, seed


def bq_inputs(masked):
    """(support, centroids, mask or None) with zero-hit rows (centroids far
    away) and saturated rows (centroids in the dense middle) at radius 0.2,
    nsample 8."""
    rng = np.random.default_rng(2)
    b, n, p = 2, 300, 40
    xyz = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    cen = xyz[:, rng.choice(n, p, replace=False)].copy()
    cen[:, :4] = 5.0
    cen[:, 4:8] = 0.5
    mask = valid_mask(rng, b, n) if masked else None
    return xyz, cen, mask


BQ_EDGE_NSAMPLES = (1, 31, 32, 33, 64)
BQ_EDGE_N = 333  # not a multiple of 32, nor of the kernel's 4-point loads


def bq_edge_inputs(nsample, masked, n=BQ_EDGE_N, radius=0.2):
    """(support [5,n,3], centroids [5,8,3], mask or None) in [0,1]^3 for the
    ball query's step edges at ``nsample``. Centroid 0 of each cloud sits
    at (2,2,2), away from the cloud, and its hits are planted: clouds 0-3
    put its nsample-th hit at point 63, 95, 127 (the last of a 32-point
    chunk; 127 also ends the kernel's 128-point step) and n - 1 (the last
    point), each with up to 3 more hits after it; cloud 4 gives it
    nsample - 1 hits only. Centroid 1 is far from everything (zero hits),
    centroid 2 in the middle of the cloud, the rest support points.
    ``masked``: 25% of the points invalid, planted hits included."""
    rng = np.random.default_rng(50 + nsample)
    b, p = 5, 8
    xyz = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    cen = xyz[:, rng.choice(n, p, replace=False)].copy()
    cen[:, 0], cen[:, 1], cen[:, 2] = 2.0, -5.0, 0.5
    for bi, target in enumerate((63, 95, 127, n - 1, None)):
        last = n - 1 if target is None else target
        hits = list(rng.choice(last, nsample - 1, replace=False))
        if target is not None:
            hits.append(target)
            after = np.arange(target + 1, n)
            hits += list(rng.choice(after, min(3, len(after)), replace=False))
        off = rng.uniform(-1, 1, (len(hits), 3)) * radius / 2
        xyz[bi, hits] = (2.0 + off).astype(np.float32)
    mask = valid_mask(rng, b, n) if masked else None
    return xyz, cen, mask


def autoencoder_inputs(masked, b=2, n=512):
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < 0.75 if masked else None
    return xyz, mask


SCATTER_CASES = {
    # idx [B,K] in [0, n) unless stated, updates [B,K,C]
    "random": dict(b=2, k=4096, n=500, c=3),
    "wide": dict(b=2, k=4096, n=512, c=128),
    "duplicates": dict(b=2, k=3000, n=40, c=3),  # ~75 updates per row
    "empty_rows": dict(b=2, k=300, n=2000, c=5),  # most rows get nothing
    "permutation": dict(b=2, k=1000, n=1000, c=2),
    "out_of_range": dict(b=2, k=500, n=100, c=3),  # some idx < 0 or >= n
    "long_row": dict(b=2, k=8192, n=500, c=3),  # 4096 updates into row 7
    "large": dict(b=2, k=65536, n=16384, c=3),  # two radix passes of 7 bits
    "all_out_of_range": dict(b=2, k=300, n=50, c=3),  # every idx dropped
    "many_rows": dict(b=1, k=131072, n=140000, c=2),  # three radix passes
}


def scatter_inputs(case):
    """(idx int32 [B,K], updates f32 [B,K,C], n) for SCATTER_CASES[case]."""
    cfg = SCATTER_CASES[case]
    rng = np.random.default_rng(11)
    b, k, n, c = cfg["b"], cfg["k"], cfg["n"], cfg["c"]
    if case == "permutation":
        idx = np.stack([rng.permutation(n) for _ in range(b)])
    elif case == "out_of_range":
        idx = rng.integers(-20, n + 20, (b, k))
    elif case == "long_row":
        idx = rng.integers(0, n, (b, k))
        idx[:, rng.permutation(k)[:4096]] = 7
    elif case == "all_out_of_range":
        idx = np.where(rng.uniform(size=(b, k)) < 0.5,
                       rng.integers(-9, 0, (b, k)), rng.integers(n, 2 * n,
                                                                 (b, k)))
    else:
        idx = rng.integers(0, n, (b, k))
    upd = rng.standard_normal((b, k, c)).astype(np.float32)
    return idx.astype(np.int32), upd, n


def nn_inputs(kind, n, m, b=2):
    """(p [B,N,3], q [B,M,3]) f32: "random" uniform, "grid" (many exact
    distance ties) or "masked" (about 25% of each cloud poisoned, p on the
    +x side and q on the -x side, as nndistance poisons them)."""
    rng = np.random.default_rng(12)
    p = cloud(rng, b, n, "grid" if kind == "grid" else "random")
    q = cloud(rng, b, m, "grid" if kind == "grid" else "random")
    if kind == "masked":
        big = 2.0e4  # core.masking.BIG_COORD
        for x, sign in ((p, 1.0), (q, -1.0)):
            bad = ~valid_mask(rng, b, x.shape[1])
            x[bad] = 0.0
            x[..., 0] = np.where(
                bad, sign * (big + 4.0 * np.arange(x.shape[1])), x[..., 0])
    return p, q


def write_ply_clouds(root, count=8, lo=96, hi=128, seed=5):
    """``count`` binary PLY clouds of ``lo`` to ``hi`` points (uniform in
    [-1, 1]^3) under ``root``, written by the port's ``save_ply``; returns
    ``root``."""
    import os

    from pytorch_points_tpu_torch.utils import pc_utils

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i, n in enumerate(rng.integers(lo, hi + 1, count)):
        pc_utils.save_ply(rng.uniform(-1, 1, (int(n), 3)).astype(np.float32),
                          os.path.join(root, f"cloud_{i:03d}.ply"))
    return str(root)
