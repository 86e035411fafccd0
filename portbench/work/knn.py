"""The work one kNN graph of a forward's input needs, whatever computes
it: B * N * N squared distances over C = 3 channels at 3C - 1 flops each,
the cloud read once (as queries and as support) and the k + 1 nearest
written once (a 4-byte distance and a 4-byte index each). The model's
edge convolutions share this one graph. Returns (flops, bytes)."""


def count(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    b, n, c, k = tr["batch"], tr["points"], 3, cfg["k"] + 1
    return b * n * n * (3 * c - 1), b * n * (2 * c * 4 + k * 8)
