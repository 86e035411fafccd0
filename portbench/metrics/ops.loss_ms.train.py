"""Device milliseconds a training step spends under the spans of the
port's losses, forward and backward: ``ppt.chamfer``, ``ppt.nndistance``
and ``ppt.emd`` (portbench/spans.py, stretch b)."""

from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    return s.device_ms(*spans.op_spans(spans.LOSS_OPS)) if s else None
