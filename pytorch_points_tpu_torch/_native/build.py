"""Build the native host-side library from the repository's
``csrc/ppt_native.cpp``: ``python -m pytorch_points_tpu_torch._native.build``.

The output goes into ``build/pytorch_points_tpu_torch/`` beside the
package, keyed by a hash of the source and flags, so a second process
reuses it. The flags are the source's Makefile's without ``-march=native``
(a build directory may be copied to another host) and with FMA contraction
off, so the library's FPS rounds as the numpy fallback does.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "csrc" / "ppt_native.cpp"
BUILD_DIR = _ROOT / "build" / "pytorch_points_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off",
             "-shared")


def build_library() -> Path:
    """Compile the library if this source and these flags have not been
    built yet; returns its path. Raises RuntimeError when no compiler is
    found or the compile fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"libppt_native_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    return so


def main():
    print(build_library())
    return 0


if __name__ == "__main__":
    sys.exit(main())
