#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. build: compile ``pytorch_points_tpu_torch/csrc/*.cu`` with nvcc (into
   ``build/pytorch_points_tpu_torch/``) and print the build time and the
   card's name and power limit;
2. kernel vs plain: each CUDA kernel (FPS, ball query, gather, kNN) against
   its plain PyTorch version on the card, at the serving path's shapes plus
   one 75%-valid masked case: indices identical and values bitwise equal;
   kernel and plain times from CUDA events;
3. serve: a full-width PointCloudAutoencoder (random weights from a seeded
   torch.Generator) answers B=16 N=2048 requests, B=32 N=16384 requests and
   masked requests under inference_mode. Every output must be finite, match
   the same model on the plain versions (impl="torch") to 1e-5, and every
   kernel's launch count must grow during this phase.

TF32 is switched off for matmuls and cuDNN so the port computes in float32
as the JAX reference does. The script imports no JAX. Without a CUDA device,
or outside a checkout, it exits non-zero and prints no result. Its last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "fps": ("pytorch_points_tpu_torch/csrc/fps.cu",
            "pytorch_points_tpu/kernels/fps.py:40"),
    "ball_query": ("pytorch_points_tpu_torch/csrc/ballquery.cu",
                   "pytorch_points_tpu/kernels/ballquery.py:143"),
    "gather": ("pytorch_points_tpu_torch/csrc/gather.cu",
               "pytorch_points_tpu/kernels/gather.py:84"),
    "knn": ("pytorch_points_tpu_torch/csrc/knn.cu",
            "pytorch_points_tpu/kernels/topk_scan.py:71"),
}


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


def phase_kernels(torch, dev):
    print("== phase 2: each kernel vs its plain PyTorch version "
          "(indices identical, values bitwise)")
    rng = np.random.default_rng(SEED)
    stats = {name: {"max_abs_err": 0.0} for name in KERNELS}
    with torch.inference_mode():
        for name, label, fn in kernel_cases(torch, rng, dev):
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
                if not torch.equal(g, r):
                    fail(f"{name} [{label}]: kernel differs from plain "
                         f"(max abs err {err})")
            ms = cuda_ms(torch, lambda: fn("cuda"))
            plain_ms = cuda_ms(torch, lambda: fn("torch"))
            print(f"{name:10s} {label:44s} equal  max_abs_err={err!r}  "
                  f"kernel {ms!r} ms  plain {plain_ms!r} ms")
            s = stats[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            if "ms" not in s:  # the JSON line reports the first (B=16) case
                s["ms"], s["plain_ms"] = ms, plain_ms
    return stats


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
        for w in wrappers.values():
            w.launches = 0
        outs, lat = [], {}
        for tag, xyz, mask in reqs:
            t0 = time.perf_counter()
            outs.append(answer(xyz, mask))  # .cpu() waits for the card
            lat.setdefault(tag, []).append(
                (time.perf_counter() - t0) * 1e3)
        launches = {name: w.launches for name, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"launches during serve: {launches}")
        for name, count in launches.items():
            if count <= 0:
                fail(f"serve never launched the {name} kernel")

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
    return launches


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
        fps,
        gather,
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
                "gather": gather.gather_rows_cuda, "knn": topk_scan.knn_cuda}
    stats = phase_kernels(torch, dev)
    launches = phase_serve(torch, dev, wrappers)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **stats[name]}
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
