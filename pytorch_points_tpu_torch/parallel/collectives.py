"""Collectives over one axis of a device mesh, and their autograd rules
(the port's counterparts of ``jax.lax.all_gather``, ``psum`` and
``ppermute`` inside ``shard_map``).

Every rank is one process. A tensor is either *replicated* (the same value
on every rank of the axis) or *sharded* (each rank holds its own slice).
Gradients keep that distinction: a replicated tensor's cotangent is the
same on every rank, a sharded tensor's is its rank's slice. So each rank
runs ``backward`` of the same replicated loss, and three rules follow:

* :func:`psum` (sharded partial sums -> replicated total): backward is the
  identity;
* :func:`pvary` (a replicated tensor entering work that differs by rank,
  as ``shard_map`` sees a ``P()`` input): identity forward, backward the
  sum of every rank's partial cotangent;
* :func:`all_gather` (shards -> the replicated whole): backward takes the
  rank's own slice of the replicated cotangent. A gathered tensor that
  then feeds rank-local work goes through :func:`pvary` too, and the two
  make the backward a reduce-scatter.

Gloo takes CUDA tensors for its gathers, sums and broadcasts, but its
send and recv write the device pointer to a socket: :func:`ring_shift`
stages CUDA tensors through host memory on a gloo group, the compute
staying on the card. NCCL takes every one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis``."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}: "
                         f"{mesh.mesh_dim_names}")
    return mesh.get_group(axis)


def gather_raw(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: [W, *x.shape]. No
    gradient."""
    w = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((w * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.reshape(w, *x.shape)


def psum_raw(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor). No gradient."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def ring_shift(tensors, group):
    """Send each tensor to the next rank of the axis and receive the
    previous rank's (``ppermute`` with ``s -> s + 1``). No gradient."""
    w = dist.get_world_size(group)
    if w == 1:
        return list(tensors)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % w)
    prv = dist.get_global_rank(group, (me - 1) % w)
    on_gloo = dist.get_backend(group) == "gloo"
    staged = [t.is_cuda and on_gloo for t in tensors]
    send = [t.cpu() if s else t.contiguous() for t, s in zip(tensors, staged)]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) if s else r
            for r, t, s in zip(recv, tensors, staged)]


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_raw(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.me = dim, dist.get_rank(group)
        ctx.size = x.shape[dim]
        parts = gather_raw(x.movedim(dim, 0), group)  # [W, n, ...]
        return parts.flatten(0, 1).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.me * ctx.size
        return g.narrow(ctx.dim, lo, ctx.size), None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the axis, differentiable (backward: the identity)."""
    return _PSum.apply(x, group)


def pvary(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated tensor about to enter rank-local work: the same tensor,
    whose gradient is summed over the axis. Without grad, ``x`` itself."""
    if not x.requires_grad:
        return x
    return _PVary.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The shards of every rank concatenated along ``dim`` in rank order
    (equal shard sizes), differentiable (backward: the rank's slice)."""
    return _AllGather.apply(x, group, dim)
