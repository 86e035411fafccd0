"""Operations of every Linear in one step of the cell, from the shapes
that the configuration and the traffic fix: 2 * rows * in * out for a
forward, three times that for a training step (the backward's two
products); recomputation is not counted. Returns (flops, 0)."""

from portbench import spec


def count(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    ref = spec.reference(cfg["reference"])
    shapes = ref.linear_shapes(cfg, tr["batch"], tr["points"])
    fwd = sum(2 * rows * cin * cout for rows, cin, cout in shapes)
    return (3 * fwd if tr["kind"] == "train" else fwd), 0
