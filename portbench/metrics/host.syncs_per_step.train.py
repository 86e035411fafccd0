"""Synchronising runtime calls a training step makes inside its spans
(``cuda*Synchronize``, and memcpy calls that copy device to host), from
the traced stretch of the port's spans (portbench/spans.py, stretch b)."""

from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    if not (s and s.card and s.has("train.step")):
        return None
    return sum(1 for _, _, label in s.att.syncs if label) / s.steps
