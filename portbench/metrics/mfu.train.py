"""Share of the chip's float32 peak that the whole training step's Linear
work reaches over the measured window: operations a step (work/linear)
times steps, over the window's seconds and the peak (peaks.json)."""


def read(ctx):
    if ctx.peaks is None:
        return None
    flops, _ = ctx.work("linear")
    d = ctx.driver
    if not d.steps:
        return None
    return 100.0 * flops * d.steps / d.window_s / ctx.peaks["f32_flops_per_s"]
