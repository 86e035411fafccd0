"""ctypes binding for the native host-side library (``csrc/ppt_native.cpp``,
counterpart of the JAX ``_native/``).

The library is compiled with g++ at its first use (``_native.build``),
into ``BUILD_DIR``.
When that fails, every entry point returns None and the numpy fallbacks in
``utils/pc_utils.py`` take over, with the same results; :func:`available`
says which path runs.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pytorch_points_tpu_torch._native.build import BUILD_DIR, build_library
from pytorch_points_tpu_torch.misc.logger import get_logger

__all__ = ["BUILD_DIR", "available", "fps", "grid_subsample",
           "read_ply_xyz"]
log = get_logger(__name__)
_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, RuntimeError) as err:
        log.warning("native library unavailable, numpy fallbacks run: %s",
                    err)
        _LIB = False
        return False
    lib.ply_vertex_count.restype = ctypes.c_long
    lib.ply_vertex_count.argtypes = [ctypes.c_char_p]
    lib.ply_read_xyz.restype = ctypes.c_int
    lib.ply_read_xyz.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.fps.restype = None
    lib.fps.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                        ctypes.c_void_p]
    lib.grid_subsample.restype = ctypes.c_long
    lib.grid_subsample.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                   ctypes.c_float, ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the native library is built and loaded (building it at the
    first call)."""
    return bool(_load())


def read_ply_xyz(path: str):
    """Fast binary-PLY xyz reader; None if the layout is not binary
    little-endian with float x, y, z first, or the library is unbuilt."""
    lib = _load()
    if not lib:
        return None
    n = lib.ply_vertex_count(path.encode())
    if n < 0:
        return None
    out = np.empty((n, 3), np.float32)
    if lib.ply_read_xyz(path.encode(), out.ctypes.data) != 0:
        return None
    return out


def _check_cloud(xyz: np.ndarray) -> np.ndarray:
    xyz = np.ascontiguousarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or xyz.shape[0] < 1:
        raise ValueError(f"expected a [N>=1, 3] cloud, got {xyz.shape}")
    return xyz


def fps(xyz: np.ndarray, k: int):
    """Host FPS (seed index 0, lowest-index ties); None if unbuilt."""
    lib = _load()
    if not lib:
        return None
    xyz = _check_cloud(xyz)
    if k < 1:
        raise ValueError(f"fps needs k >= 1, got {k}")
    out = np.empty(k, np.int32)
    lib.fps(xyz.ctypes.data, xyz.shape[0], k, out.ctypes.data)
    return out


def grid_subsample(xyz: np.ndarray, cell: float):
    """Voxel-grid downsample to per-cell centroids; None if unbuilt."""
    lib = _load()
    if not lib:
        return None
    xyz = _check_cloud(xyz)
    if not cell > 0:
        raise ValueError(f"grid_subsample needs cell > 0, got {cell}")
    m = lib.grid_subsample(xyz.ctypes.data, xyz.shape[0], cell, None)
    out = np.empty((m, 3), np.float32)
    lib.grid_subsample(xyz.ctypes.data, xyz.shape[0], cell, out.ctypes.data)
    return out
