"""Tracing and profiling (counterpart of the JAX ``utils/profiling.py``).

  * :func:`annotate` marks host-side phases (steps, data loading) on the
    trace timeline, and as an NVTX range on the card;
  * :func:`op_scope` is the reference's per-op scope, ``ppt.<name>``;
  * :func:`trace` captures a torch.profiler trace of CPU and CUDA activity
    around any block and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def annotate(name: str):
    """Host-side timeline annotation: a ``record_function`` range, and an
    NVTX range when a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def op_scope(name: str):
    """Scope of one op on the trace: ``record_function("ppt.<name>")``."""
    return record_function(f"ppt.{name}")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU, and CUDA when a card is present)
    and write a Chrome trace (``trace_<pid>_<ns>.json``, viewable in
    Perfetto or chrome://tracing) into ``log_dir``. Yields the profiler,
    whose ``key_averages()`` summarize the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
