"""Host-clock timing helpers (counterpart of the JAX ``utils/benchmark.py``).

``measure`` enqueues ``iters`` calls back to back (the device runs its
queue in order), syncs once at the end and subtracts the calibrated cost of
one sync, giving the amortized host wall time a call. Device-side timing
with CUDA events is a separate tool; this is the reference's measure.
"""

from __future__ import annotations

import time

import numpy as np
import torch

_SYNC_LATENCY: float | None = None


def _first_tensor(result):
    if isinstance(result, torch.Tensor):
        return result
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for item in result:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def device_sync(result) -> None:
    """Wait for the device of ``result``'s first tensor (and everything
    queued on it before); a no-op for CPU tensors."""
    t = _first_tensor(result)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def sync_latency() -> float:
    """Calibrated cost of one :func:`device_sync` (cached): the median of
    five syncs after a small op, on the card when there is one."""
    global _SYNC_LATENCY
    if _SYNC_LATENCY is None:
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        x = torch.ones((8, 128), device=dev)
        device_sync(x + 1.0)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            device_sync(x + 1.0)
            ts.append(time.perf_counter() - t0)
        _SYNC_LATENCY = float(np.median(ts))
    return _SYNC_LATENCY


def measure(fn, *args, iters: int = 5, warmup: int = 2,
            repeats: int = 1) -> float:
    """Amortized wall seconds per call of ``fn(*args)``.

    Enqueues ``iters`` calls back to back, syncs once, subtracts the fixed
    sync latency; a block too short to resolve above it is retried with 8
    times the calls (up to 4 tries). ``repeats > 1`` times that block
    ``repeats`` times and returns the median per-call estimate.
    """
    lat = sync_latency()
    for _ in range(warmup):
        device_sync(fn(*args))
    total = 0.0
    for _ in range(4):
        t0 = time.perf_counter()
        r = None
        for _ in range(iters):
            r = fn(*args)
        device_sync(r)
        total = time.perf_counter() - t0
        if total - lat > max(lat, 0.02):  # resolvable above sync noise
            break
        iters *= 8  # too fast to resolve: amortize over more calls
    samples = [max(total - lat, 1e-9) / iters]
    for _ in range(repeats - 1):
        t0 = time.perf_counter()
        r = None
        for _ in range(iters):
            r = fn(*args)
        device_sync(r)
        samples.append(max(time.perf_counter() - t0 - lat, 1e-9) / iters)
    return float(np.median(samples))
