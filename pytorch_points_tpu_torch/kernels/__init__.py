"""Hand-written CUDA kernels (``csrc/*.cu``) and their plain PyTorch versions.

Each kernel module holds a plain version (``*_torch``), a launcher
(``*_cuda``, with a ``launches`` counter) and a dispatching entry point that
takes ``impl``. Importing a module builds nothing: the kernels are compiled
at their first launch (``_build.library``).
"""

# Ops whose CUDA kernel has landed; dispatch.resolve refuses the others on
# CUDA tensors rather than fall back to the plain version.
AVAILABLE = frozenset({"fps", "ball_query", "gather", "knn", "scatter",
                       "nn_dense", "nn_band", "nn_resident"})
