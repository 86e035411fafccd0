"""Builds ``csrc/*.cu`` into one shared library and binds it with ctypes.

The kernels have a plain C interface: pointers and the stream travel as
``c_void_p``, sizes as ``c_int``, and every entry point returns
``cudaGetLastError()`` after its launch, which :func:`check` turns into an
exception. A wrapper binds its entry point once, at import, with
:func:`entry`, which resolves the ctypes function at its first call; the
per-call path is then :func:`require`, ``torch.empty``, :func:`stream`
and the ctypes call. nvcc compiles the sources at first use, one process
per source, all started together, then links them, into
``build/pytorch_points_tpu_torch/`` beside the package, keyed by a hash of
the sources and flags, so a second process reuses the build. A failed
build raises; nothing falls back to the plain versions.
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
_FA, _IA = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # xyz, mask, seed, b, n, k, out_idx, out_xyz, scratch, stream
    "ppt_fps": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    # n, iters, out (3 int64), stream
    "ppt_fps_step_floor": [_I, _I, _P, _P],
    # sup, qry, b, n, p, nsample, r2, scratch, out_idx, out_cnt, counts,
    # stream
    "ppt_ball_query": [_P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P],
    # sup, qry, p0, b, n, p, nsample, r2, scratch, out_idx, out_cnt, out_g,
    # counts, stream
    "ppt_ball_query_coords": [_P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P,
                              _P, _P],
    # features, idx, b, n, k, c, out, stream
    "ppt_gather_rows": [_P, _P, _I, _I, _I, _I, _P, _P],
    "ppt_gather_rows_bf16": [_P, _P, _I, _I, _I, _I, _P, _P],
    # qry, sup, b, nq, ns, c, k, lists, out_d, out_i, stream
    "ppt_knn": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "ppt_knn_scratch_keys": [_I, _I, _I, _P],
    # qry, sup, centers, b, q_pad, m_pad, k, k_pad, unroll, boxes, out_d,
    # out_i, counts, stats, codes, lists, stream
    "ppt_knn_ring": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P, _P, _P],
    # idx, updates, b, k, n, c, scratch, out, stream
    "ppt_scatter_add": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    # p, q, b, n, m, both, keys, d1, i1, d2, i2, stream
    "ppt_nn_dense": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # pp, qp, codes, count, b, n_rows, n_cols, tn, tm, k_max, keys, d1, i1,
    # d2, i2, stream
    "ppt_nn_worklist": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P, _P, _P],
    # ps, q, centers, vp, vq, b, ni, m, stride, mq, tb, tbq, live, out,
    # counts, stream
    "ppt_nn_band": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                    _P, _P],
    # ps, qs, qid, d_ub, b, ni, nj, tn, tm, scratch, out_d, out_i, cand_out,
    # counts, stream
    "ppt_nn_scan": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                    _P],
    # n, ti -> bytes of one cloud's state
    "ppt_auction_state_bytes": [_I, _I],
    # b, n, ti -> blocks a cloud's cluster takes (1: none)
    "ppt_auction_cluster": [_I, _I, _I],
    # p, q, b, n, ti, phases, eps (host), budgets (host), hint, warm_start,
    # out_owner, out_price, counts, cluster, scratch, scratch_stride, stream
    "ppt_auction": [_P, _P, _I, _I, _I, _I, _FA, _IA, _P, _I, _P, _P, _P, _I,
                    _P, _I, _P],
    # n -> bytes of one cloud's state
    "ppt_augment_state_bytes": [_I],
    # p, q, owner_in, price_in, b, n, eps, pop_cap, cap, out_owner,
    # out_price, counts, scratch, scratch_stride, stream
    "ppt_augment": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P, _P, _P, _P, _I,
                    _P],
    # n (K12's block for n columns), iters, out (3 int64), stream
    "ppt_augment_pop_floor": [_I, _I, _P, _P],
    # x, gamma, beta, rows, c, eps, out_a, out_mean, out_rstd, stream
    "ppt_layer_norm_relu_fwd": [_P, _P, _P, _I, _I, _F, _P, _P, _P, _P],
    # da, x, mean, rstd, gamma, beta, rows, c, scratch, scratch_blocks,
    # out_dx, out_dgamma, out_dbeta, stream
    "ppt_layer_norm_relu_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P,
                                _P, _P, _P],
    # -> the backward's scratch blocks an SM
    "ppt_layer_norm_relu_scratch_blocks_per_sm": [],
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


class entry:
    """A kernel entry point, bound at import and resolved in the library
    at its first call (so importing a wrapper builds nothing)."""

    __slots__ = ("name", "fn")

    def __init__(self, name: str):
        self.name, self.fn = name, None

    def __call__(self, *args) -> int:
        if self.fn is None:
            self.fn = getattr(library(), self.name)
        return self.fn(*args)


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = library().ppt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> None:
    """Check a kernel argument: CUDA, dtype, shape (None = any), contiguous,
    and no gradient expected: the kernels are forward-only, and gradients
    come from the ops' autograd Functions, which pass detached tensors.
    One test for a good argument; the errors are told apart only after it
    fails."""
    if (t.is_cuda and t.dtype == dtype and t.is_contiguous()
            and len(shape) == t.dim()
            and all(s is None or s == d for s, d in zip(shape, t.shape))
            and not (t.requires_grad and torch.is_grad_enabled())):
        return
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    raise RuntimeError(
        f"{name}: the CUDA kernels are forward-only; call the op in "
        "pytorch_points_tpu_torch.ops (an autograd Function), or run "
        "under torch.no_grad()/inference_mode()"
    )


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device, read without
    building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def int32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous int32 tensor, itself when it is one already
    (a check costs less than a no-op ``to``)."""
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
