"""Share of the chip's float32 peak that a request's forward reaches:
the forward's Linear operations (work/linear) over the mean time from a
request's start to its output on the host, over the peak."""


def read(ctx):
    if ctx.peaks is None:
        return None
    flops, _ = ctx.work("linear")
    s = ctx.driver.service_s
    return 100.0 * flops / s / ctx.peaks["f32_flops_per_s"] if s > 0 else None
