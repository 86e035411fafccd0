"""Host milliseconds the port takes to issue one training step: the median
of the ``train.step`` span's duration over steps that each start after a
synchronise, on an empty launch queue (portbench/spans.py, stretch a)."""

import statistics

from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    if not (s and s.card and s.issue_s):
        return None
    return 1e3 * statistics.median(s.issue_s)
