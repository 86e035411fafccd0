"""The EMD kernels' share of their roofline: the least time the work an
exact EMD needs (work/emd) takes on the chip, over the device time a
step spends in K11 and K12 (patterns/emd)."""


def read(ctx):
    if ctx.peaks is None:
        return None
    t = ctx.trace
    s = t.seconds_matching(ctx.pattern("emd")) / t.steps
    if s <= 0:
        return None
    return 100.0 * ctx.roofline(*ctx.work("emd")) / s
