"""Plain reference of the 3PU-style upsampler (``pu_3pu``).

A Linear lift of the coordinates; two densely connected edge convolutions
on the input's coordinate kNN graph (k nearest besides the point itself;
edge features (centre, neighbour - centre), each conv reading the
concatenation of everything before it, a max over the neighbours); each
point's features repeated ``ratio`` times with the grid codes (cos, sin)
of 2 pi j / ratio; an expansion MLP and a coordinate head (Linear ->
LayerNorm -> ReLU, the last Linear bare); the output is each input point
repeated ``ratio`` times plus the head. Parameters are a dict whose names
are the port's module paths; all sizes come from the configuration file.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ops
from portbench.reference.pn2_ae import _mlp_spec, mlp


def _edge_spec(prefix, cin, growth, dense_n):
    spec = [(f"{prefix}.first.weight", (growth, 2 * cin), "linear"),
            (f"{prefix}.first.bias", (growth,), "bias")]
    c = cin + growth
    for i in range(dense_n - 1):
        spec += [(f"{prefix}.convs.{i}.weight", (growth, c), "linear"),
                 (f"{prefix}.convs.{i}.bias", (growth,), "bias")]
        c += growth
    return spec


def _channels(cfg):
    c0 = cfg["channels"]
    c1 = c0 + cfg["dense_n"] * cfg["growth_rate"]
    c2 = c1 + cfg["dense_n"] * cfg["growth_rate"]
    return c0, c1, c2


def param_spec(cfg):
    c0, c1, c2 = _channels(cfg)
    g, dn = cfg["growth_rate"], cfg["dense_n"]
    spec = [("lift.weight", (c0, 3), "linear"), ("lift.bias", (c0,), "bias")]
    spec += _edge_spec("edge1", c0, g, dn)
    spec += _edge_spec("edge2", c1, g, dn)
    spec += _mlp_spec("expand", [c2 + 2, *cfg["expand"]])
    spec += _mlp_spec("head", cfg["head"], act_last=False)
    return spec


def edge_conv(params, prefix, f, idx, dense_n, tf32):
    nbrs = ops.gather_rows(f, idx)
    center = f[:, :, None, :]
    x = center.expand_as(nbrs)
    y = torch.relu(ops.linear(torch.cat([x, nbrs - center], dim=-1),
                              params[f"{prefix}.first.weight"],
                              params[f"{prefix}.first.bias"], tf32))
    h = torch.cat([x, y], dim=-1)
    for i in range(dense_n - 1):
        y = torch.relu(ops.linear(h, params[f"{prefix}.convs.{i}.weight"],
                                  params[f"{prefix}.convs.{i}.bias"], tf32))
        h = torch.cat([h, y], dim=-1)
    return torch.amax(h, dim=2)


def grid_codes(ratio, device):
    a = 2 * math.pi * torch.arange(ratio, dtype=torch.float32,
                                   device=device) / ratio
    return torch.stack([torch.cos(a), torch.sin(a)], dim=-1)


def forward(params, xyz, cfg, tf32=False):
    """[B,N,3] -> [B,N*ratio,3]."""
    r, k, dn = cfg["ratio"], cfg["k"], cfg["dense_n"]
    _, idx = ops.knn(xyz, xyz, k + 1)
    idx = idx[..., 1:]
    f = ops.linear(xyz, params["lift.weight"], params["lift.bias"], tf32)
    f = edge_conv(params, "edge1", f, idx, dn, tf32)
    f = edge_conv(params, "edge2", f, idx, dn, tf32)
    b, n, _ = f.shape
    codes = grid_codes(r, f.device).repeat(n, 1)
    child = torch.cat([f.repeat_interleave(r, dim=1),
                       codes[None].expand(b, -1, -1)], dim=-1)
    h = mlp(params, "expand", child, len(cfg["expand"]), tf32)
    head = cfg["head"]
    offsets = mlp(params, "head", h, len(head) - 1, tf32, act_last=False)
    return xyz.repeat_interleave(r, dim=1) + offsets


def linear_shapes(cfg, b, n):
    c0, c1, c2 = _channels(cfg)
    g, dn, k, r = (cfg["growth_rate"], cfg["dense_n"], cfg["k"],
                   cfg["ratio"])
    out = [(b * n, 3, c0)]
    for cin in (c0, c1):
        rows = b * n * k
        out.append((rows, 2 * cin, g))
        c = cin + g
        for _ in range(dn - 1):
            out.append((rows, c, g))
            c += g
    ws = [c2 + 2, *cfg["expand"]]
    out += [(b * n * r, ci, co) for ci, co in zip(ws[:-1], ws[1:])]
    head = cfg["head"]
    out += [(b * n * r, ci, co) for ci, co in zip(head[:-1], head[1:])]
    return out
