"""Device items (kernels, copies, fills) a training step issues, from the
traced stretch: what the host launches through the ops and the kernel
wrappers."""


def read(ctx):
    t = ctx.trace
    return t.device_items / t.steps if t.device_items else None
