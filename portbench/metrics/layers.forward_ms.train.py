"""Self device milliseconds a training step spends in the forwards of the
port's SA, FP and edge-conv layers (``layers.sa``, ``layers.fp``,
``layers.edgeconv``): their MLPs, norms and concatenations, without the op
spans inside them (portbench/spans.py, stretch b)."""

from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    return s.self_ms(*spans.LAYERS) if s else None
