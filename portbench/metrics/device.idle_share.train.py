"""Share of the traced window in which no device item ran, training:
one minus the union of the device items' intervals over the window."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
