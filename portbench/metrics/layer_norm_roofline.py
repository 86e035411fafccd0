"""The fused LayerNorm+ReLU's share of its byte bound: the least time one
step's norms need at the card's HBM rate (work/norm), over the device time
a step spends in the items that patterns/norm names."""


def read(ctx):
    if ctx.peaks is None:
        return None
    t = ctx.trace
    s = t.seconds_matching(ctx.pattern("norm")) / t.steps
    if s <= 0:
        return None
    return 100.0 * ctx.roofline(*ctx.work("norm")) / s
