#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. build: compile ``pytorch_points_tpu_torch/csrc/*.cu`` with nvcc (into
   ``build/pytorch_points_tpu_torch/``) and print the build time and the
   card's name and power limit;
2. kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the card, at every shape the main paths give it (the headline's FPS
   16384 -> 2048, ball query at P=2048, group gather and backward scatters
   included), with 75%-valid masked and tie-grid
   cases: FPS, ball query, gather, kNN, dense NN (K5) and the Morton-pruned
   band and resident NN (K6) with indices identical and values bitwise
   equal, K6 also against K5 on the same clouds; the scatter (K4) within
   the bound of two f32 summation orders of the plain version (which uses
   atomics on the card), bitwise equal across two launches and bitwise
   exact for a permutation write. Kernel and plain times from CUDA events;
3. serve: a full-width PointCloudAutoencoder (random weights from a seeded
   torch.Generator) answers B=16 N=2048 requests, B=32 N=16384 requests and
   masked requests under inference_mode. Every output must be finite and
   match the same model on the plain versions (impl="torch") to 1e-5;
4. train: the same model, config 5 without its EMD term (chamfer loss, Adam
   at 1e-3), takes steps at B=16 N=2048. The first step's parameter grads
   must match the plain versions' within TRAIN_GRAD_TOL of each tensor's
   largest grad, and every loss must be finite;
5. headline: FPS 16384 -> 2048, ball query (r=0.2, ns=32), group and the
   Morton-pruned chamfer, forward and backward at B=32 (the JAX package's
   graded headline loss); value and grad must match the plain versions, for
   the loss and for its group term alone (which the loss weighs by 1e-6).

Phases 3-5 are the main paths. Each sets every kernel's launch count to 0
just before it runs and reads them just after, and fails if a kernel of its
path was never launched.

6. profile: one call of each main path, traced with torch.profiler after
   its untraced timing: wall ms, device busy ms and idle share per call,
   and the largest device items. It checks nothing; its launches are not
   counted.

TF32 is switched off for matmuls and cuDNN so the port computes in float32
as the JAX reference does. The script imports no JAX. Without a CUDA device,
or outside a checkout, it exits non-zero and prints no result. Its last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
SERVE_TOL = 1e-5
SLICE = dict(b=16, n=2048)  # the serving path's request shape
LARGE = dict(b=32, n=16384)
NPOINT1, NPOINT2, RADIUS1, RADIUS2, NSAMPLE = 512, 128, 0.2, 0.4, 32
HEAD = dict(b=32, n=16384, p=2048)  # the headline loss (bench.py)
TRAIN_STEPS, HEAD_CALLS = 10, 5
TRAIN_GRAD_TOL = 1e-4  # of each tensor's largest grad: scatter sum order
HEAD_GRAD_TOL = 1e-4
HEAD_GROUP_WEIGHT = 1e-6  # the group term's weight in the headline loss
SUM_ORDER_EPS = 2.0**-24  # unit roundoff of float32
PROFILE_TOP = 12

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "fps": ("pytorch_points_tpu_torch/csrc/fps.cu",
            "pytorch_points_tpu/kernels/fps.py:40"),
    "ball_query": ("pytorch_points_tpu_torch/csrc/ballquery.cu",
                   "pytorch_points_tpu/kernels/ballquery.py:143"),
    "gather": ("pytorch_points_tpu_torch/csrc/gather.cu",
               "pytorch_points_tpu/kernels/gather.py:84"),
    "knn": ("pytorch_points_tpu_torch/csrc/knn.cu",
            "pytorch_points_tpu/kernels/topk_scan.py:71"),
    "scatter": ("pytorch_points_tpu_torch/csrc/scatter.cu",
                "pytorch_points_tpu/kernels/scatter.py:129"),
    "nn_dense": ("pytorch_points_tpu_torch/csrc/nn_dense.cu",
                 "pytorch_points_tpu/kernels/distance_tiles.py:78"),
    "nn_band": ("pytorch_points_tpu_torch/csrc/nn_sorted.cu",
                "pytorch_points_tpu/kernels/nn_sorted.py:151"),
    "nn_resident": ("pytorch_points_tpu_torch/csrc/nn_sorted.cu",
                    "pytorch_points_tpu/kernels/nn_sorted.py:387"),
}
SERVE_KERNELS = ("fps", "ball_query", "gather", "knn")
TRAIN_KERNELS = (*SERVE_KERNELS, "scatter", "nn_dense")
HEAD_KERNELS = ("fps", "ball_query", "gather", "scatter", "nn_band",
                "nn_resident")


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn) -> float:
    """Mean device time of one call (CUDA events around a run of calls,
    after a warm-up call), with the run sized to take ~0.2 s."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(50, max(3, 0.2 / max(time.perf_counter() - t0, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cloud(rng, b, n):
    return rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)


def head_pred(rng):
    """The headline's prediction cloud, [B,N,3] f32 inside (-0.97, 0.99)."""
    return (rng.uniform(-1, 1, (HEAD["b"], HEAD["n"], 3)) * 0.98
            + 0.01).astype(np.float32)


def kernel_cases(torch, rng, dev):
    """(kernel, label, fn(impl) -> outputs) at the serving path's shapes."""
    from pytorch_points_tpu_torch.kernels import ballquery, fps, gather
    from pytorch_points_tpu_torch.ops import grouping

    def t(a):
        return torch.from_numpy(a).to(dev)

    cases = []
    for tag, shp in (("B16_N2048", SLICE), ("B32_N16384", LARGE)):
        b, n = shp["b"], shp["n"]
        xyz = t(cloud(rng, b, n))
        cen = fps.furthest_point_sample(xyz, NPOINT1, impl="torch")[1]
        idx, _ = ballquery.ball_query(xyz, cen, RADIUS1, NSAMPLE,
                                      impl="torch")
        flat = idx.reshape(b, -1)
        cases += [
            ("fps", f"sa1 {tag} k={NPOINT1}",
             lambda impl, x=xyz: fps.furthest_point_sample(x, NPOINT1,
                                                           impl=impl)),
            ("ball_query", f"sa1 {tag} P={NPOINT1} r={RADIUS1}",
             lambda impl, x=xyz, c=cen: ballquery.ball_query(
                 x, c, RADIUS1, NSAMPLE, impl=impl)),
            ("gather", f"sa1 xyz {tag} K={flat.shape[1]} C=3",
             lambda impl, x=xyz, i=flat: gather.gather_rows(x, i, impl=impl)),
            ("knn", f"fp1 {tag} Nq={n} Ns={NPOINT1} k=3",
             lambda impl, x=xyz, c=cen: grouping.knn(x, c, 3, impl=impl)),
        ]
    b, n = SLICE["b"], SLICE["n"]
    xyz = t(cloud(rng, b, n))
    mask = t(rng.uniform(size=(b, n)) < 0.75)
    cen = fps.furthest_point_sample(xyz, NPOINT1, mask, impl="torch")[1]
    xyz2 = cen[:, :NPOINT1]
    cen2 = fps.furthest_point_sample(xyz2, NPOINT2, impl="torch")[1]
    idx2, _ = ballquery.ball_query(xyz2, cen2, RADIUS2, NSAMPLE, impl="torch")
    f1 = t(rng.standard_normal((b, NPOINT1, 128)).astype(np.float32))
    smask = t(rng.uniform(size=(b, NPOINT1)) < 0.75)
    cases += [
        ("fps", "sa1 B16_N2048 75%-valid mask",
         lambda impl: fps.furthest_point_sample(xyz, NPOINT1, mask,
                                                impl=impl)),
        ("ball_query", "sa1 B16_N2048 75%-valid mask",
         lambda impl: ballquery.ball_query(xyz, cen, RADIUS1, NSAMPLE, mask,
                                           impl=impl)),
        ("ball_query", f"sa2 B16 N={NPOINT1} P={NPOINT2} r={RADIUS2}",
         lambda impl: ballquery.ball_query(xyz2, cen2, RADIUS2, NSAMPLE,
                                           impl=impl)),
        ("gather", f"sa2 features B16 K={NPOINT2 * NSAMPLE} C=128",
         lambda impl: gather.gather_rows(f1, idx2.reshape(b, -1),
                                         impl=impl)),
        ("knn", f"fp2 B16 Nq={NPOINT1} Ns={NPOINT2} k=3",
         lambda impl: grouping.knn(xyz2, cen2, 3, impl=impl)),
        ("knn", "fp1 B16_N2048 75%-valid support mask",
         lambda impl: grouping.knn(xyz, cen, 3, support_mask=smask,
                                   impl=impl)),
    ]
    return cases


def scatter_bound(torch, idx, upd, n):
    """Per-element bound on two f32 summation orders of a row's k updates,
    2 k 2^-24 sum|u|: the kernel sums in ascending k, the plain version
    (index_add_) with atomics on the card. 0 for a permutation write."""
    from pytorch_points_tpu_torch.kernels import scatter

    count = scatter.scatter_add(idx, torch.ones_like(upd), n, impl="torch")
    abs_sum = scatter.scatter_add(idx, upd.abs(), n, impl="torch")
    return torch.where(count > 1, 2 * count * SUM_ORDER_EPS * abs_sum, 0.0)


def training_kernel_cases(torch, rng, dev):
    """(kernel, label, fn(impl) -> outputs, bound or None) for the kernels
    of the training paths: K5 at config 5's shape; K6, and K1, K2 and K3 at
    the headline's; K4 at the backward scatters of both. bound None:
    bitwise equal."""
    from pytorch_points_tpu_torch.core.masking import poison_points
    from pytorch_points_tpu_torch.kernels import (
        ballquery,
        distance_tiles,
        fps,
        gather,
        nn_sorted,
        scatter,
    )

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    b, n = SLICE["b"], SLICE["n"]
    p, q = t(cloud(rng, b, n)), t(cloud(rng, b, n))
    pm, qm = (t(rng.uniform(size=(b, n)) < 0.75) for _ in range(2))
    pp, qp = poison_points(p, pm, 1.0), poison_points(q, qm, -1.0)
    gp, gq = (t(rng.integers(0, 8, (b, n, 3)) / 8).float() for _ in range(2))
    cases = [
        ("nn_dense", f"chamfer B16 N=M={n}",
         lambda impl: distance_tiles.nn_both_directions(p, q, impl=impl),
         None),
        ("nn_dense", f"chamfer B16 N=M={n} 75%-valid poisoned",
         lambda impl: distance_tiles.nn_both_directions(pp, qp, impl=impl),
         None),
        ("nn_dense", f"chamfer B16 N=M={n} tie grid",
         lambda impl: distance_tiles.nn_both_directions(gp, gq, impl=impl),
         None),
    ]

    hb, hn = HEAD["b"], HEAD["n"]
    hp, hq = t(cloud(rng, hb, hn)), t(cloud(rng, hb, hn))
    ps, _ = nn_sorted.sort_by_morton(hp)
    qs, perm_q = nn_sorted.sort_by_morton(hq)
    d_ub = nn_sorted.band_min(ps, qs, tb=nn_sorted.TB, tbq=nn_sorted.TBQ,
                              stride=nn_sorted.STRIDE, impl="torch")
    cand = nn_sorted._cand_mask(ps, qs, d_ub, nn_sorted.FT, nn_sorted.TN,
                                nn_sorted.TM)
    print(f"K6 at B={hb} N=M={hn}: candidate tile pairs "
          f"{cand.float().mean().item()!r} of all")
    cases += [
        ("nn_band", f"headline B{hb} N=M={hn} tbq=128 stride=4",
         lambda impl: nn_sorted.band_min(
             ps, qs, tb=nn_sorted.TB, tbq=nn_sorted.TBQ,
             stride=nn_sorted.STRIDE, impl=impl), None),
        ("nn_resident", f"headline B{hb} N=M={hn} tn=512 tm=64",
         lambda impl: nn_sorted.nn_resident(ps, qs, perm_q, cand,
                                            impl=impl), None),
    ]

    xyz = t(cloud(rng, b, n))
    cen = fps.furthest_point_sample(xyz, NPOINT1, impl="torch")[1]
    idx1 = ballquery.ball_query(xyz, cen, RADIUS1, NSAMPLE,
                                impl="torch")[0].reshape(b, -1)
    xyz2 = cen[:, :NPOINT1]
    cen2 = fps.furthest_point_sample(xyz2, NPOINT2, impl="torch")[1]
    idx2 = ballquery.ball_query(xyz2, cen2, RADIUS2, NSAMPLE,
                                impl="torch")[0].reshape(b, -1)
    u1 = t(rng.standard_normal((b, idx1.shape[1], 3)).astype(np.float32))
    u2 = t(rng.standard_normal((b, idx2.shape[1], 128)).astype(np.float32))
    perm = t(np.stack([rng.permutation(hn) for _ in range(hb)]))
    idx3 = torch.cat([perm, t(rng.integers(0, hn, (hb, hn)))], 1)
    idx3, perm = idx3.to(torch.int32), perm.to(torch.int32)
    u3 = t(rng.standard_normal((hb, 2 * hn, 3)).astype(np.float32))
    u4 = t(rng.standard_normal((hb, hn, 2)).astype(np.float32))
    # the headline's own FPS, ball query, group gather and their backward
    # scatters, on a cloud drawn as phase 5 draws its prediction
    hp = t(head_pred(rng))
    hfps, hc = fps.furthest_point_sample(hp, HEAD["p"], impl="torch")
    hidx = ballquery.ball_query(hp, hc, RADIUS1, NSAMPLE,
                                impl="torch")[0].reshape(hb, -1)
    hk = hidx.shape[1]
    cases += [
        ("fps", f"headline B{hb} N={hn} k={HEAD['p']}",
         lambda impl: fps.furthest_point_sample(hp, HEAD["p"], impl=impl),
         None),
        ("ball_query", f"headline B{hb} N={hn} P={HEAD['p']} r={RADIUS1}",
         lambda impl: ballquery.ball_query(hp, hc, RADIUS1, NSAMPLE,
                                           impl=impl), None),
        ("gather", f"headline group B{hb} K={hk} C=3",
         lambda impl: gather.gather_rows(hp, hidx, impl=impl), None),
    ]
    u5 = t(rng.standard_normal((hb, hk, 3)).astype(np.float32))
    u6 = t(rng.standard_normal((hb, HEAD["p"], 3)).astype(np.float32))
    for label, (i, u, m) in {
        f"group backward B16 K={idx1.shape[1]} n={n} C=3": (idx1, u1, n),
        f"sa2 features B16 K={idx2.shape[1]} n={NPOINT1} C=128":
            (idx2, u2, NPOINT1),
        f"chamfer backward B{hb} K={2 * hn} n={hn} C=3": (idx3, u3, hn),
        f"permutation write B{hb} n={hn} C=2": (perm, u4, hn),
        f"headline group backward B{hb} K={hk} n={hn} C=3": (hidx, u5, hn),
        f"headline FPS coords backward B{hb} K={HEAD['p']} n={hn} C=3":
            (hfps, u6, hn),
    }.items():
        cases.append((
            "scatter", label,
            lambda impl, i=i, u=u, m=m: scatter.scatter_add(i, u, m,
                                                            impl=impl),
            scatter_bound(torch, i, u, m)))
    return cases


def check_k6_equals_k5(torch, dev):
    """The pruned indexed path against the dense kernel on the same clouds,
    at the headline shape: indices identical, distances bitwise."""
    from pytorch_points_tpu_torch.kernels import distance_tiles, nn_sorted

    rng = np.random.default_rng(SEED + 4)
    p, q = (torch.from_numpy(cloud(rng, HEAD["b"], HEAD["n"])).to(dev)
            for _ in range(2))
    with torch.inference_mode():
        got = nn_sorted.nndistance_indexed(p, q, impl="cuda")
        dense = distance_tiles.nn_both_directions(p, q, impl="cuda")
        for g, r in zip(got, dense):
            if g.dtype != r.dtype or not torch.equal(g, r):
                fail("K6 (nndistance_indexed) differs from K5 at the "
                     "headline shape")
        ms = cuda_ms(torch, lambda: nn_sorted.nndistance_indexed(
            p, q, impl="cuda"))
        sums_ms = cuda_ms(torch, lambda: nn_sorted.nndistance_sums(
            p, q, impl="cuda"))
        dense_ms = cuda_ms(torch, lambda: distance_tiles.nn_both_directions(
            p, q, impl="cuda"))
    print(f"K6 == K5 at B={HEAD['b']} N=M={HEAD['n']} (bitwise). Whole "
          f"paths: nndistance_indexed {ms!r} ms, nndistance_sums "
          f"{sums_ms!r} ms, dense K5 both directions {dense_ms!r} ms")


def phase_kernels(torch, dev):
    print("== phase 2: each kernel vs its plain PyTorch version "
          "(indices identical, values bitwise; the scatter within its "
          "summation-order bound)")
    rng = np.random.default_rng(SEED)
    stats = {name: {"max_abs_err": 0.0} for name in KERNELS}
    with torch.inference_mode():
        cases = [(*c, None) for c in kernel_cases(torch, rng, dev)]
        cases += training_kernel_cases(torch, rng, dev)
        for name, label, fn, bound in cases:
            got, ref = fn("cuda"), fn("torch")
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = 0.0
            for g, r in zip(got, ref):
                if g.dtype != r.dtype or g.shape != r.shape:
                    fail(f"{name} [{label}]: {g.dtype}{tuple(g.shape)} vs "
                         f"plain {r.dtype}{tuple(r.shape)}")
                if g.dtype.is_floating_point:
                    err = max(err, (g - r).abs().max().item())
                if bound is None and not torch.equal(g, r):
                    fail(f"{name} [{label}]: kernel differs from plain "
                         f"(max abs err {err})")
            if bound is not None:
                if not ((got[0] - ref[0]).abs() <= bound).all():
                    fail(f"{name} [{label}]: kernel outside the "
                         f"summation-order bound of plain (max abs err "
                         f"{err})")
                if not torch.equal(got[0], fn("cuda")):
                    fail(f"{name} [{label}]: two launches differ")
            verdict = "equal" if bound is None else "within bound, repeatable"
            ms = cuda_ms(torch, lambda: fn("cuda"))
            plain_ms = cuda_ms(torch, lambda: fn("torch"))
            print(f"{name:11s} {label:46s} {verdict}  max_abs_err={err!r}  "
                  f"kernel {ms!r} ms  plain {plain_ms!r} ms")
            s = stats[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            if "ms" not in s:  # the JSON line reports each kernel's 1st case
                s["ms"], s["plain_ms"] = ms, plain_ms
    check_k6_equals_k5(torch, dev)
    return stats


def drive(wrappers, required, path, run):
    """Run one main path with every launch count set to 0 just before and
    read just after; fail if a kernel of the path was never launched."""
    for w in wrappers.values():
        w.launches = 0
    run()
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"launches during {path}: {launches}")
    for name in required:
        if launches[name] <= 0:
            fail(f"{path} never launched the {name} kernel")
    return launches


def requests(rng):
    """(shape tag, xyz [B,N,3] f32, mask [B,N] bool or None)."""
    reqs = [("B16_N2048", cloud(rng, **SLICE), None) for _ in range(8)]
    reqs += [("B32_N16384", cloud(rng, **LARGE), None) for _ in range(3)]
    b, n = SLICE["b"], SLICE["n"]
    for _ in range(3):
        lengths = rng.integers(3 * n // 4, n + 1, size=b)
        mask = np.arange(n)[None, :] < lengths[:, None]
        xyz = np.where(mask[..., None], cloud(rng, b, n), 0.0)
        reqs.append(("B16_N2048_masked", xyz.astype(np.float32), mask))
    return reqs


def phase_serve(torch, dev, wrappers):
    from pytorch_points_tpu_torch.models import PointCloudAutoencoder

    print("== phase 3: serve a full-width PointCloudAutoencoder")
    gen = torch.Generator().manual_seed(SEED)
    model = PointCloudAutoencoder(NPOINT1, NPOINT2, device=dev,
                                  generator=gen).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters, npoint {NPOINT1}/{NPOINT2}, "
          f"radius {RADIUS1}/{RADIUS2}, nsample {NSAMPLE}, LayerNorm, f32")
    reqs = requests(np.random.default_rng(SEED + 1))

    def answer(xyz, mask, impl="auto"):
        x = torch.from_numpy(xyz).to(dev)
        m = None if mask is None else torch.from_numpy(mask).to(dev)
        return model(x, m, impl=impl).cpu()

    with torch.inference_mode():
        for tag in dict.fromkeys(r[0] for r in reqs):  # warm-up, uncounted
            _, xyz, mask = next(r for r in reqs if r[0] == tag)
            answer(xyz, mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        outs, lat = [], {}

        def serve():
            for tag, xyz, mask in reqs:
                t0 = time.perf_counter()
                outs.append(answer(xyz, mask))  # .cpu() waits for the card
                lat.setdefault(tag, []).append(
                    (time.perf_counter() - t0) * 1e3)

        launches = drive(wrappers, SERVE_KERNELS, "serve", serve)
        peak = torch.cuda.max_memory_allocated(dev)

        worst = {}
        for (tag, xyz, mask), out in zip(reqs, outs):
            if out.shape != xyz.shape or not torch.isfinite(out).all():
                fail(f"{tag}: bad output {tuple(out.shape)} / non-finite")
            if mask is not None and (out.numpy()[~mask] != 0).any():
                fail(f"{tag}: masked rows are not zero")
            err = (out - answer(xyz, mask, impl="torch")).abs().max().item()
            worst[tag] = max(worst.get(tag, 0.0), err)
            if err > SERVE_TOL:
                fail(f"{tag}: kernels vs plain versions differ by {err}")
    for tag, ms in lat.items():
        print(f"serve {tag:18s} median {statistics.median(ms)!r} ms over "
              f"{len(ms)} requests (numpy in -> numpy out); "
              f"max |kernels - plain| = {worst[tag]!r}")
    print(f"peak device memory during serve: {peak} bytes")

    def request(tag):
        _, xyz, mask = next(r for r in reqs if r[0] == tag)
        with torch.inference_mode():
            return answer(xyz, mask)

    return launches, {f"serve {tag}": functools.partial(request, tag)
                      for tag in lat}


def grad_gap(got, ref):
    """max |got - ref| / max |ref| over the pairs of tensors (0/0 -> 0)."""
    worst = 0.0
    for g, r in zip(got, ref, strict=True):
        scale = r.abs().max().item()
        diff = (g - r).abs().max().item()
        worst = max(worst, diff / scale if scale else diff)
    return worst


def phase_train(torch, dev, wrappers):
    from pytorch_points_tpu_torch.models import PointCloudAutoencoder
    from pytorch_points_tpu_torch.parallel import (
        make_train_step,
        reconstruction_loss,
    )

    b, n = SLICE["b"], SLICE["n"]
    print(f"== phase 4: train the full-width PointCloudAutoencoder, config 5 "
          f"without EMD (chamfer, Adam lr 1e-3), B={b} N={n}")
    gen = torch.Generator().manual_seed(SEED)
    model = PointCloudAutoencoder(NPOINT1, NPOINT2, device=dev, generator=gen)
    rng = np.random.default_rng(SEED + 2)
    batches = [{"points": torch.from_numpy(cloud(rng, b, n)).to(dev)}
               for _ in range(TRAIN_STEPS)]
    first = {}
    for impl in ("cuda", "torch"):  # the first step's grads, uncounted
        model.zero_grad(set_to_none=True)
        loss = reconstruction_loss(impl=impl)(model, batches[0])
        loss.backward()
        first[impl] = (loss.item(),
                       [p.grad.detach().clone() for p in model.parameters()])
    gap = grad_gap(first["cuda"][1], first["torch"][1])
    print(f"first step: loss kernels {first['cuda'][0]!r} plain "
          f"{first['torch'][0]!r}; parameter grads max |kernels - plain| / "
          f"max |plain| = {gap!r} (bar {TRAIN_GRAD_TOL})")
    if gap > TRAIN_GRAD_TOL or abs(first["cuda"][0] - first["torch"][0]) > (
            1e-6 * abs(first["torch"][0])):
        fail("train: first-step loss or grads differ from the plain versions")
    model.zero_grad(set_to_none=True)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), 1e-3),
                           reconstruction_loss())
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def train():
        for batch in batches:
            t0 = time.perf_counter()
            losses.append(step(batch).item())  # .item() waits for the card
            times.append((time.perf_counter() - t0) * 1e3)

    launches = drive(wrappers, TRAIN_KERNELS, "train", train)
    if not np.isfinite(losses).all():
        fail(f"train: non-finite loss {losses}")
    print(f"train losses: {losses}")
    print(f"train median {statistics.median(times)!r} ms/step over "
          f"{len(times)} steps (first step {times[0]!r} ms); peak device "
          f"memory {torch.cuda.max_memory_allocated(dev)} bytes")
    return launches, {f"train step B={b} N={n}":
                      lambda: step(batches[0]).item()}


def headline_terms(pred, gt, impl):
    """The JAX package's graded headline (bench.py) in two terms: the
    chamfer distance, and the FPS + ball query + group term (the mean
    squared offset of each group from its centroid)."""
    from pytorch_points_tpu_torch.ops import (
        ball_query,
        chamfer_distance,
        furthest_point_sample_and_gather,
        group_points,
    )

    cen, _ = furthest_point_sample_and_gather(pred, HEAD["p"], impl=impl)
    nidx, _ = ball_query(pred, cen, RADIUS1, NSAMPLE, impl=impl)
    centered = group_points(pred, nidx, impl) - cen[:, :, None, :]
    return chamfer_distance(pred, gt, impl=impl), (centered**2).mean()


def phase_headline(torch, dev, wrappers):
    from pytorch_points_tpu_torch.ops import chamfer_path

    b, n, p = HEAD["b"], HEAD["n"], HEAD["p"]
    print(f"== phase 5: headline FPS {n}->{p} + ball query (r={RADIUS1}, "
          f"ns={NSAMPLE}) + group + chamfer, forward and backward, B={b}")
    rng = np.random.default_rng(SEED + 3)
    gt = torch.from_numpy(cloud(rng, b, n)).to(dev)
    pred = torch.from_numpy(head_pred(rng)).to(dev)
    path = chamfer_path(pred, gt, reduction="mean")
    print(f"chamfer_path: {path}")
    if path != "sorted_loss":
        fail(f"headline: chamfer took the {path} path, not sorted_loss")

    def values_and_grads(impl):
        """(loss, group term) and their grads in pred. The loss weighs the
        group term by 1e-6, so its grad is held on its own, at weight 1."""
        x = pred.clone().requires_grad_()
        cd, group = headline_terms(x, gt, impl)
        loss = cd + HEAD_GROUP_WEIGHT * group
        g_group, = torch.autograd.grad(group, x, retain_graph=True)
        g_loss, = torch.autograd.grad(loss, x)
        return (loss.item(), group.item()), (g_loss, g_group)

    v_k, g_k = values_and_grads("cuda")  # uncounted: held against plain
    v_p, g_p = values_and_grads("torch")
    for what, vk, vp, gk, gp in zip(("loss", "group term"), v_k, v_p, g_k,
                                    g_p, strict=True):
        gap = grad_gap([gk], [gp])
        print(f"headline {what}: kernels {vk!r} plain {vp!r}; pred grad max "
              f"|kernels - plain| / max |plain| = {gap!r} "
              f"(bar {HEAD_GRAD_TOL})")
        if not (np.isfinite(vk) and torch.isfinite(gk).all()
                and gk.shape == pred.shape):
            fail(f"headline {what}: non-finite value or grad")
        if gap > HEAD_GRAD_TOL or abs(vk - vp) > 1e-6 * abs(vp):
            fail(f"headline {what}: value or grad differs from the plain "
                 "versions")
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def call():
        x = pred.clone().requires_grad_()
        cd, group = headline_terms(x, gt, "auto")
        loss = cd + HEAD_GROUP_WEIGHT * group
        loss.backward()
        return loss.item()  # waits for the forward

    def headline():
        for _ in range(HEAD_CALLS):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)

    launches = drive(wrappers, HEAD_KERNELS, "headline", headline)
    print(f"headline median {statistics.median(times)!r} ms per call "
          f"(value and grad) over {len(times)} calls: {times}; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev)} bytes")
    return launches, {f"headline B={b} N={n} P={p}": call}


def profile_path(torch, label, fn, calls=5):
    """Untraced wall ms per call (after 3 warm-up calls), then a
    torch.profiler trace of ``calls`` calls: device busy ms per call (the
    sum of the kernels' and copies' own times), the device's idle share of
    the untraced wall time, and the largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # device items only; a record_function range (Adam's step) also shows
    # on the device as a user annotation over kernels counted on their own
    items = sorted((e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation),
                   key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in items) / 1e3 / calls
    print(f"profile {label}: wall {wall!r} ms/call untraced; device busy "
          f"{busy!r} ms/call; device idle share {1 - busy / wall!r}; "
          f"{sum(e.count for e in items) / calls!r} device items/call")
    for e in items[:PROFILE_TOP]:
        print(f"  {e.self_device_time_total / 1e3 / calls:10.4f} ms/call "
              f"{e.count / calls:7.1f}/call  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (ROOT / "pytorch_points_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pytorch_points_tpu_torch.kernels import (
        _build,
        ballquery,
        distance_tiles,
        fps,
        gather,
        nn_sorted,
        scatter,
        topk_scan,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")

    print("== phase 1: build")
    t0 = time.perf_counter()
    _build.library()
    print(f"built kernels in {time.perf_counter() - t0!r} s into "
          f"{_build.BUILD_DIR.relative_to(ROOT)}")

    wrappers = {"fps": fps.fps_cuda, "ball_query": ballquery.ball_query_cuda,
                "gather": gather.gather_rows_cuda, "knn": topk_scan.knn_cuda,
                "scatter": scatter.scatter_add_cuda,
                "nn_dense": distance_tiles.nn_one_direction_cuda,
                "nn_band": nn_sorted.band_min_cuda,
                "nn_resident": nn_sorted.nn_resident_cuda}
    stats = phase_kernels(torch, dev)
    paths, calls = [], {}
    for phase in (phase_serve, phase_train, phase_headline):
        counts, fns = phase(torch, dev, wrappers)
        paths.append(counts)
        calls.update(fns)
    print("== phase 6: profile one call of each main path")
    for label, fn in calls.items():
        profile_path(torch, label, fn)

    # launches: the sum over the three main paths' runs (each printed above)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(counts[name] for counts in paths), **stats[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
