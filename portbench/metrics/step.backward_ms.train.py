"""Device milliseconds a training step spends under the port's
``train.backward`` span, the ``ppt.*.backward`` spans that autograd's
device thread opens beneath it included (portbench/spans.py, stretch b)."""

from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    return s.device_ms("train.backward") if s else None
