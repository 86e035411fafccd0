"""The port's benchmark: one command runs one cell once (``run.py``).

Cells are listed in ``BENCHMARK.json`` at the checkout's root; each
configuration, traffic mix, metric reader, layer pattern, work count and
cell's limits is a file of its own here (``spec.py`` says where). Nothing
here imports JAX or the JAX package; ``reference/`` imports nothing of
the port either.
"""
