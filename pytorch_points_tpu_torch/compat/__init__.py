"""Reference-compatible API surface, channels-first (counterpart of the JAX
``compat/__init__.py``).

The port's native layout is channels-last [B, N, C]. These wrappers keep
the reference's ``pytorch_points.network.operations`` signatures:
channels-first [B, C, N] tensors, ``NCHW`` flags, the reference's argument
order and returned tuples. Each transposes around the port's own op, so
each is a thin wrapper over its kernel (FPS K1, ball query K2, gather K3,
scatter K4 in the backwards, kNN K8, nearest neighbour K5/K6).

``load_jax_params`` carries a JAX model's weights into its port;
``torch_bridge`` imports reference Conv+BatchNorm weights into a
``SharedMLP``.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch import ops as _ops
from pytorch_points_tpu_torch.compat import torch_bridge
from pytorch_points_tpu_torch.compat.jax_params import load_jax_params


def _swap(x: torch.Tensor) -> torch.Tensor:
    """[B, C, N] <-> [B, N, C]."""
    return x.transpose(1, 2)


def _nchw(grouped: torch.Tensor) -> torch.Tensor:
    """[B, P, S, C] -> [B, C, P, S]."""
    return grouped.permute(0, 3, 1, 2)


def furthest_point_sample(xyz, npoint: int, NCHW: bool = True):
    """Reference: returns (sampled_xyz, idx); xyz is [B,3,N] when NCHW."""
    pts = _swap(xyz) if NCHW else xyz
    idx = _ops.furthest_point_sample(pts, npoint)
    sampled = _ops.gather_points(pts, idx)
    return (_swap(sampled) if NCHW else sampled), idx


def gather_points(features, idx):
    """features [B,C,N], idx [B,K] -> [B,C,K]."""
    return _swap(_ops.gather_points(_swap(features), idx))


def group_points(features, idx):
    """features [B,C,N], idx [B,P,S] -> [B,C,P,S]."""
    return _nchw(_ops.group_points(_swap(features), idx))


def ball_query(radius: float, nsample: int, xyz, new_xyz):
    """Reference arg order (radius, nsample, support, centers); both
    [B,N,3]/[B,P,3] channels-last as in the PointNet++ wrappers.
    Returns idx [B,P,nsample]."""
    idx, _ = _ops.ball_query(xyz, new_xyz, radius, nsample)
    return idx


def group_knn(k: int, query, points, unique: bool = True, NCHW: bool = True):
    """Reference: returns (grouped_points [B,C,P,k], idx, distances)."""
    q = _swap(query) if NCHW else query
    s = _swap(points) if NCHW else points
    grouped, idx, dist = _ops.group_knn(k, q, s, unique=unique)
    return (_nchw(grouped) if NCHW else grouped), idx, dist


def three_nn(unknown, known):
    """[B,n,3], [B,m,3] -> (dist [B,n,3] squared, idx)."""
    return _ops.three_nn(unknown, known)


def three_interpolate(features, idx, weight):
    """features [B,C,m], idx/weight [B,n,3] -> [B,C,n]."""
    return _swap(_ops.three_interpolate(_swap(features), idx, weight))


def nndistance(pred, gt):
    """[B,N,3], [B,M,3] -> (dist1, idx1, dist2, idx2), squared distances."""
    return _ops.nndistance(pred, gt)


def sample_and_group(xyz, points, npoint: int, nsample: int, radius: float,
                     use_xyz: bool = True):
    """Reference NCHW sample_and_group: xyz [B,3,N], points [B,C,N] or None.

    Returns (new_xyz [B,3,P], new_points [B,C',P,S], idx, grouped_xyz
    [B,3,P,S])."""
    f = _swap(points) if points is not None else None
    new_xyz, new_feats, idx, grouped_xyz = _ops.sample_and_group(
        _swap(xyz), f, npoint, nsample, radius, use_xyz=use_xyz)
    return _swap(new_xyz), _nchw(new_feats), idx, _nchw(grouped_xyz)


def normalize_point_batch(pc, NCHW: bool = True):
    """Reference: (pc, centroid, furthest_distance), same layout in/out."""
    x = _swap(pc) if NCHW else pc
    out, centroid, furthest = _ops.normalize_point_batch(x)
    if NCHW:
        return _swap(out), _swap(centroid), furthest
    return out, centroid, furthest


def batch_normals(xyz, nn_size: int = 20, NCHW: bool = True):
    """Reference: PCA normals; xyz [B,3,N] when NCHW."""
    x = _swap(xyz) if NCHW else xyz
    n = _ops.batch_normals(x, k=nn_size)
    return _swap(n) if NCHW else n


__all__ = ["ball_query", "batch_normals", "furthest_point_sample",
           "gather_points", "group_knn", "group_points", "load_jax_params",
           "nndistance", "normalize_point_batch", "sample_and_group",
           "three_interpolate", "three_nn", "torch_bridge"]
