"""Builds ``csrc/*.cu`` into one shared library and binds it with ctypes.

The kernels have a plain C interface: pointers and the stream travel as
``c_void_p``, sizes as ``c_int``, and every entry point returns
``cudaGetLastError()`` after its launch, which :func:`check` turns into an
exception. nvcc compiles them at first use, one process per source, all
started together, then links them, into ``build/pytorch_points_tpu_torch/``
beside the package, keyed by a hash of the sources and flags, so a second
process reuses the build. A failed build raises; nothing falls back to the
plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pytorch_points_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # xyz, mask, seed, b, n, k, out_idx, out_xyz, scratch, stream
    "ppt_fps": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    # sup, qry, b, n, p, nsample, r2, out_idx, out_cnt, stream
    "ppt_ball_query": [_P, _P, _I, _I, _I, _I, _F, _P, _P, _P],
    # features, idx, b, n, k, c, out, stream
    "ppt_gather_rows": [_P, _P, _I, _I, _I, _I, _P, _P],
    # qry, sup, b, nq, ns, k, out_d, out_i, stream
    "ppt_knn": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    # updates, order, offsets, rows, c, out, stream
    "ppt_scatter_rows": [_P, _P, _P, _I, _I, _P, _P],
    # p, q, b, n, m, out_d, out_i, stream
    "ppt_nn_dense": [_P, _P, _I, _I, _I, _P, _P, _P],
    # ps, qsub, centers, b, ni, mq, tb, tbq, out, stream
    "ppt_nn_band": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # ps, qs, qid, cand, b, ni, nj, tn, tm, out_d, out_i, stream
    "ppt_nn_resident": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side and wait for all of them; raise with
    the output of the first that failed. On any error, those still running
    are killed."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outs = [proc.communicate()[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = BUILD_DIR / f"libppt_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        try:
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                      for src, o in zip(sources, objs)])
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
            os.replace(tmp, so)
        finally:
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ppt_error_string.argtypes = [_I]
    lib.ppt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = library().ppt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> None:
    """Check a kernel argument: CUDA, dtype, shape (None = any), contiguous,
    and no gradient expected: the kernels are forward-only, and gradients
    come from the ops' autograd Functions, which pass detached tensors."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{name}: the CUDA kernels are forward-only; call the op in "
            "pytorch_points_tpu_torch.ops (an autograd Function), or run "
            "under torch.no_grad()/inference_mode()"
        )


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
