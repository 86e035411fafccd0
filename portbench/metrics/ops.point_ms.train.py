"""Device milliseconds a training step spends under the spans of the
port's point ops, forward and backward: ``ppt.fps``, ``ball_query``,
``group``, ``knn``, ``three_nn``, ``three_interpolate``, ``gather`` and
``scatter_add``, each item once (portbench/spans.py, stretch b)."""

from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    return s.device_ms(*spans.op_spans(spans.POINT_OPS)) if s else None
