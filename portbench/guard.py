"""The benchmark runs the port alone: no JAX, no JAX package.

A module counts by its top-level name (the part before the first dot),
compared whole: ``pytorch_points_tpu_torch`` is the port, while
``pytorch_points_tpu`` is the JAX package.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pytorch_points_tpu",
                       "bench"})


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names in ``modules`` (``sys.modules`` by default)
    that the benchmark may not load."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in modules}
                  & FORBIDDEN)


def require_clean(when: str) -> None:
    """Exit with code 3, naming what was found on standard error, if a
    forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded {when}: "
              f"{', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
