"""Plain reference of the PointNet++ SSG autoencoder (``pn2_ae``).

SA levels (FPS from point 0, ball query, grouped coordinates centred on
their centroid and concatenated before the features, a shared MLP of
Linear -> LayerNorm -> ReLU, a max over the group), a group-all level, FP
levels (three nearest by inverse squared distance, the skip features
first, the same MLP) and a coordinate head whose last Linear has no norm
and no activation; the reconstruction is the input plus the head.
Parameters are a dict whose names are the port's module paths. All sizes
come from the configuration file.
"""

from __future__ import annotations

import torch

from portbench.reference import ops


def _mlp_spec(prefix: str, widths, act_last: bool = True):
    out = []
    for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        out.append((f"{prefix}.layers.{i}.weight", (cout, cin), "linear"))
        out.append((f"{prefix}.layers.{i}.bias", (cout,), "bias"))
        if act_last or i < len(widths) - 2:
            out.append((f"{prefix}.norms.{i}.weight", (cout,), "norm_scale"))
            out.append((f"{prefix}.norms.{i}.bias", (cout,), "bias"))
    return out


def _widths(cfg):
    sa = cfg["sa"]
    sa_in = [3]
    for level in sa[:-1]:
        sa_in.append(level["mlp"][-1] + 3)
    fp_in = []
    skips = [level["mlp"][-1] for level in sa[:-1]][::-1]  # 256, 128
    below = sa[-1]["mlp"][-1]
    for i, widths in enumerate(cfg["fp"]):
        skip = skips[i] if i < len(skips) else 0
        fp_in.append(below + skip)
        below = widths[-1]
    return sa_in, fp_in


def param_spec(cfg):
    """[(name, shape, kind)] in a fixed order; kind is "linear" (a weight,
    fan-in its last axis), "bias" or "norm_scale"."""
    sa_in, fp_in = _widths(cfg)
    spec = []
    for i, level in enumerate(cfg["sa"]):
        spec += _mlp_spec(f"encoder.sa{i + 1}.mlp", [sa_in[i], *level["mlp"]])
    for i, widths in enumerate(cfg["fp"]):
        name = f"fp{len(cfg['fp']) - i}.mlp"
        spec += _mlp_spec(name, [fp_in[i], *widths])
    spec += _mlp_spec("head", cfg["head"], act_last=False)
    return spec


def mlp(params, prefix, x, n_layers, tf32, act_last=True):
    for i in range(n_layers):
        x = ops.linear(x, params[f"{prefix}.layers.{i}.weight"],
                       params[f"{prefix}.layers.{i}.bias"], tf32)
        if i == n_layers - 1 and not act_last:
            break
        x = torch.relu(ops.layer_norm(x, params[f"{prefix}.norms.{i}.weight"],
                                      params[f"{prefix}.norms.{i}.bias"]))
    return x


def forward(params, xyz, cfg, tf32=False):
    """[B,N,3] -> reconstruction [B,N,3]."""
    xyzs, feats = [xyz], [None]
    for i, level in enumerate(cfg["sa"]):
        x, f = xyzs[-1], feats[-1]
        n_layers = len(level["mlp"])
        if level.get("group_all"):
            grouped = x[:, None]
            if f is not None:
                grouped = torch.cat([grouped, f[:, None]], -1)
            new_xyz = x.new_zeros((x.shape[0], 1, 3))
        else:
            idx = ops.fps(x, level["npoint"])
            new_xyz = ops.gather_rows(x, idx)
            nbr = ops.ball_query(x, new_xyz, level["radius"], level["nsample"])
            grouped = ops.gather_rows(x, nbr) - new_xyz[:, :, None, :]
            if f is not None:
                grouped = torch.cat([grouped, ops.gather_rows(f, nbr)], -1)
        h = mlp(params, f"encoder.sa{i + 1}.mlp", grouped, n_layers, tf32)
        xyzs.append(new_xyz)
        feats.append(h.amax(dim=2))
    g = feats[-1]
    n_fp = len(cfg["fp"])
    for i, widths in enumerate(cfg["fp"]):
        hi = len(xyzs) - 2 - i  # the level propagated onto
        x_hi, x_lo, f_hi = xyzs[hi], xyzs[hi + 1], feats[hi]
        if x_lo.shape[1] == 1:
            interp = g.expand(g.shape[0], x_hi.shape[1], g.shape[-1])
        else:
            dist, idx = ops.knn(x_hi, x_lo, 3)
            interp = ops.three_interpolate(g, idx,
                                           ops.interpolation_weights(dist))
        if f_hi is not None:
            interp = torch.cat([f_hi, interp], dim=-1)
        g = mlp(params, f"fp{n_fp - i}.mlp", interp, len(widths), tf32)
    head = cfg["head"]
    return xyz + mlp(params, "head", g, len(head) - 1, tf32, act_last=False)


def linear_shapes(cfg, b, n):
    """[(rows, in, out)] of every Linear in one forward of ``b`` clouds of
    ``n`` points."""
    sa_in, fp_in = _widths(cfg)
    out = []
    counts = [n]
    for i, level in enumerate(cfg["sa"]):
        if level.get("group_all"):
            rows, pts = b * counts[-1], 1
        else:
            rows, pts = b * level["npoint"] * level["nsample"], level["npoint"]
        widths = [sa_in[i], *level["mlp"]]
        out += [(rows, ci, co) for ci, co in zip(widths[:-1], widths[1:])]
        counts.append(pts)
    for i, widths in enumerate(cfg["fp"]):
        rows = b * counts[len(counts) - 2 - i]
        ws = [fp_in[i], *widths]
        out += [(rows, ci, co) for ci, co in zip(ws[:-1], ws[1:])]
    head = cfg["head"]
    out += [(b * n, ci, co) for ci, co in zip(head[:-1], head[1:])]
    return out
