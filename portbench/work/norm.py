"""The bytes the LayerNorm+ReLU pairs of one training step need, whatever
computes them: for each norm's (rows, C) in a forward (the reference's
``norm_shapes``), 20 bytes an element (forward: x read, a written;
backward: da and x read, dx written, float32) and 8 a row (mean and rstd
written once, read once). Returns (0, bytes)."""

from portbench import spec


def count(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    ref = spec.reference(cfg["reference"])
    shapes = ref.norm_shapes(cfg, tr["batch"], tr["points"])
    return 0, sum(rows * (20 * c + 8) for rows, c in shapes)
