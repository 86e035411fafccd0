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


def autoencoder_inputs(masked, b=2, n=512):
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < 0.75 if masked else None
    return xyz, mask
