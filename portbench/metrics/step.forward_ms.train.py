"""Device milliseconds a training step spends under the port's
``train.forward`` span: the loss's forward, every op and layer in it
(portbench/spans.py, stretch b)."""

from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    return s.device_ms("train.forward") if s else None
