"""Device milliseconds a training step spends in LayerNorm forward and
backward (patterns/norm), from the traced stretch."""


def read(ctx):
    t = ctx.trace
    s = t.seconds_matching(ctx.pattern("norm"))
    return 1e3 * s / t.steps if s > 0 else None
