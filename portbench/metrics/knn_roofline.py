"""The kNN scan's share of its roofline: the least time one kNN graph of
a forward's input takes on the chip (work/knn), over the device time a
step spends in K8 (patterns/knn)."""


def read(ctx):
    if ctx.peaks is None:
        return None
    t = ctx.trace
    s = t.seconds_matching(ctx.pattern("knn")) / t.steps
    if s <= 0:
        return None
    return 100.0 * ctx.roofline(*ctx.work("knn")) / s
