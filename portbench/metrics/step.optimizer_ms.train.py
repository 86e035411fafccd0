"""Device milliseconds a training step spends under the port's
``train.optimizer`` span: ``torch.optim.Adam``'s update
(portbench/spans.py, stretch b)."""

from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    return s.device_ms("train.optimizer") if s else None
