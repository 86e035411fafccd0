"""Plain reference of PointNet++ MSG part segmentation
(``pn2_partseg_msg``): Qi et al. 2017, arXiv:1706.02413, section 3.3, as
the authors' ``models/pointnet2_part_seg_msg_one_hot.py`` builds it for
ShapeNet-Part (points with normals, a one-hot shape category, 50 parts).

SA levels with multi-scale grouping: FPS from point 0, then for each
radius a ball query around the same centroids, the grouped coordinates
centred on their centroid, the grouped features, a shared MLP of Linear
-> LayerNorm -> ReLU and a max over the group; the scales' outputs
concatenated. A group-all level, FP levels (three nearest by inverse
squared distance, the same MLP), then ``fc1`` (Linear, LayerNorm, ReLU),
dropout and ``fc2`` (the logits). Parameters are a dict whose names are
the port's module paths; all sizes come from the configuration file.

Departures from the authors' code:

* LayerNorm (eps 1e-6) where they use BatchNorm, as in the package's other
  models;
* the package's order of concatenation: the centred coordinates before the
  grouped features (theirs: features first), and in FP the skip features
  before the interpolated ones (theirs: interpolated first); FP1's skip is
  [one-hot category, xyz, normals], as theirs;
* the dropout mask is drawn as ``torch.rand(...) >= p`` from the caller's
  generator, so that the program and the reference share it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import ops
from portbench.reference.pn2_ae import _mlp_spec, mlp


def _widths(cfg):
    """Input widths of the SA levels' MLPs and of the FP levels."""
    cin, sa_in, outs = cfg["in_features"], [], []
    for level in cfg["sa"]:
        sa_in.append(cin + 3)
        cin = (level["mlp"][-1] if level.get("group_all")
               else sum(m[-1] for m in level["mlps"]))
        outs.append(cin)
    skips = [*outs[:-1][::-1], cfg["num_categories"] + 3 + cfg["in_features"]]
    fp_in, below = [], outs[-1]
    for skip, widths in zip(skips, cfg["fp"]):
        fp_in.append(skip + below)
        below = widths[-1]
    return sa_in, fp_in


def param_spec(cfg):
    """[(name, shape, kind)] in a fixed order; kind is "linear" (a weight,
    fan-in its last axis), "bias" or "norm_scale"."""
    sa_in, fp_in = _widths(cfg)
    spec = []
    for i, level in enumerate(cfg["sa"]):
        if level.get("group_all"):
            spec += _mlp_spec(f"sa{i + 1}.mlp", [sa_in[i], *level["mlp"]])
        else:
            for s, widths in enumerate(level["mlps"]):
                spec += _mlp_spec(f"sa{i + 1}.mlps.{s}", [sa_in[i], *widths])
    for i, widths in enumerate(cfg["fp"]):
        spec += _mlp_spec(f"fp{len(cfg['fp']) - i}.mlp", [fp_in[i], *widths])
    head = cfg["head"]
    spec += _mlp_spec("fc1", head[:2])
    spec += _mlp_spec("fc2", head[1:], act_last=False)
    return spec


def _ball_query(x, centroids, radius, nsample):
    """``ops.ball_query`` for any ``nsample``: past the cloud's size every
    row is short, so its further slots repeat its first hit."""
    k = min(nsample, x.shape[1])
    idx = ops.ball_query(x, centroids, radius, k)
    return torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1],
                                               nsample - k)], -1)


def _sa(params, i, x, f, level, tf32):
    """One SA level: (new_xyz [B,P,3], features [B,P,C])."""
    name = f"sa{i + 1}"
    if level.get("group_all"):
        grouped = torch.cat([x[:, None], f[:, None]], -1)
        h = mlp(params, f"{name}.mlp", grouped, len(level["mlp"]), tf32)
        return x.new_zeros((x.shape[0], 1, 3)), h.amax(dim=2)
    new_xyz = ops.gather_rows(x, ops.fps(x, level["npoint"]))
    pooled = []
    for s, (radius, nsample, widths) in enumerate(zip(
            level["radii"], level["nsamples"], level["mlps"])):
        nbr = _ball_query(x, new_xyz, radius, nsample)
        grouped = torch.cat([ops.gather_rows(x, nbr) - new_xyz[:, :, None, :],
                             ops.gather_rows(f, nbr)], -1)
        h = mlp(params, f"{name}.mlps.{s}", grouped, len(widths), tf32)
        pooled.append(h.amax(dim=2))
    return new_xyz, torch.cat(pooled, -1)


def _fp(params, name, x_hi, x_lo, f_hi, f_lo, n_layers, tf32):
    if x_lo.shape[1] == 1:
        interp = f_lo.expand(f_lo.shape[0], x_hi.shape[1], f_lo.shape[-1])
    else:
        dist, idx = ops.knn(x_hi, x_lo, 3)
        interp = ops.three_interpolate(f_lo, idx,
                                       ops.interpolation_weights(dist))
    return mlp(params, name, torch.cat([f_hi, interp], -1), n_layers, tf32)


def forward(params, batch, cfg, tf32=False, dropout_generator=None):
    """batch {"points" [B,N,3], "normals" [B,N,3], "category" [B]} ->
    logits [B,N,num_classes]; dropout as in training, its mask drawn from
    ``dropout_generator``."""
    xyz, normals = batch["points"], batch["normals"]
    xyzs, feats = [xyz], [normals]
    for i, level in enumerate(cfg["sa"]):
        x, f = _sa(params, i, xyzs[-1], feats[-1], level, tf32)
        xyzs.append(x)
        feats.append(f)
    onehot = F.one_hot(batch["category"].long(), cfg["num_categories"])
    feats[0] = torch.cat([onehot[:, None, :].to(xyz.dtype).expand(
        -1, xyz.shape[1], -1), xyz, normals], -1)
    g = feats[-1]
    n_fp = len(cfg["fp"])
    for i, widths in enumerate(cfg["fp"]):
        hi = len(xyzs) - 2 - i
        g = _fp(params, f"fp{n_fp - i}.mlp", xyzs[hi], xyzs[hi + 1],
                feats[hi], g, len(widths), tf32)
    h = mlp(params, "fc1", g, 1, tf32)
    p = cfg["dropout"]
    if p > 0:
        keep = torch.rand(h.shape, generator=dropout_generator,
                          device=h.device) >= p
        h = torch.where(keep, h * (1.0 / (1.0 - p)), 0.0)
    return mlp(params, "fc2", h, 1, tf32, act_last=False)


def linear_shapes(cfg, b, n):
    """[(rows, in, out)] of every Linear in one forward of ``b`` clouds of
    ``n`` points."""
    sa_in, fp_in = _widths(cfg)
    out, counts = [], [n]
    for i, level in enumerate(cfg["sa"]):
        if level.get("group_all"):
            scales = [(b * counts[-1], level["mlp"])]
            counts.append(1)
        else:
            scales = [(b * level["npoint"] * ns, widths) for ns, widths in
                      zip(level["nsamples"], level["mlps"])]
            counts.append(level["npoint"])
        for rows, widths in scales:
            ws = [sa_in[i], *widths]
            out += [(rows, ci, co) for ci, co in zip(ws[:-1], ws[1:])]
    for i, widths in enumerate(cfg["fp"]):
        rows = b * counts[len(counts) - 2 - i]
        ws = [fp_in[i], *widths]
        out += [(rows, ci, co) for ci, co in zip(ws[:-1], ws[1:])]
    head = cfg["head"]
    out += [(b * n, ci, co) for ci, co in zip(head[:-1], head[1:])]
    return out


def norm_shapes(cfg, b, n):
    """[(rows, C)] of every LayerNorm in one forward of ``b`` clouds of
    ``n`` points: each Linear's output but the logits'."""
    return [(rows, cout) for rows, _, cout in linear_shapes(cfg, b, n)[:-1]]
