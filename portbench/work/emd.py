"""The work an exact EMD of a step needs, whatever computes it: each of
the B * N^2 pair costs once at 8 flops (3 differences, 3 squares, 2
adds), both clouds read once and the assignment written once (float32
coordinates, 4-byte indices). Returns (flops, bytes)."""


def count(ctx):
    tr = ctx.cell.traffic
    b, n = tr["batch"], tr["points"]
    return 8 * b * n * n, b * n * (2 * 3 * 4 + 4)
