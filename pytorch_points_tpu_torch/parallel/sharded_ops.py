"""Point-sharded ops (counterpart of the JAX ``parallel/sharded_ops.py``).

Each rank of the mesh's points axis is one process with one device; the
collectives and their gradient rules are in ``parallel/collectives.py``.

**One convention for every op.** An argument that the JAX function's
``in_specs`` shard over the points axis is passed as the rank's local
shard: its contiguous slice, in rank order, which is also global index
order, every rank's of the same size (the ops that communicate check the
sizes and raise ValueError on every rank; the query-sharded ops, ball
query, group, three_nn, three_interpolate and kNN, need no communication
at all, as in the reference). A replicated argument (``P()``) is
passed whole, the same on every rank. Outputs follow ``out_specs`` the
same way: a sharded output is the rank's slice, a replicated one the
whole. Indices are always global. Where the JAX function reshards inside
(``sample_and_group_sharded``: FPS takes the cloud by points, the ball
query takes it whole), the port all-gathers what XLA would have gathered.
A mask is sharded like its cloud.

Gradients: every rank runs ``backward`` of the same replicated loss (a
sum over shards goes through ``collectives.psum``); a replicated input's
gradient is then whole on every rank, a sharded input's its slice.

The kernels on the card: the NN scans are K13 (``nn_one_direction``) and
K5 (the ring's ``nn_both_directions``), the ball query K2, the gathers K3
with their K4 scatter backwards, kNN and three_nn K8. The sharded FPS and
the sharded auction are plain torch on the device, as their JAX bodies are
XLA.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pytorch_points_tpu_torch import ops
from pytorch_points_tpu_torch.kernels import distance_tiles
from pytorch_points_tpu_torch.kernels.gather import gather_rows
from pytorch_points_tpu_torch.ops.emd import _poison_rank_matched
from pytorch_points_tpu_torch.ops.grouping import _per_radius
from pytorch_points_tpu_torch.ops.pairwise import pairwise_sqdist
from pytorch_points_tpu_torch.ops.scatter_impl import scatter_add_auto
from pytorch_points_tpu_torch.parallel.collectives import (
    all_gather,
    axis_group,
    gather_raw,
    psum,
    psum_raw,
    pvary,
    ring_shift,
)

_BIG = 2**30
_NEG = -1e30


def _axis(mesh, axis: str, *shards: torch.Tensor):
    """(group, W, rank) of ``mesh``'s ``axis``. Checks that every rank's
    shard of each tensor in ``shards`` has the same size along dim 1 (one
    small all-gather): unequal shards raise ValueError on every rank."""
    group = axis_group(mesh, axis)
    w, me = dist.get_world_size(group), dist.get_rank(group)
    sizes = torch.tensor([s.shape[1] for s in shards],
                         device=shards[0].device)
    every = gather_raw(sizes, group).cpu()  # [W, len(shards)]
    if not bool((every == every[0]).all()):
        raise ValueError(
            f"the {axis!r} axis needs equal shards on its {w} ranks (a "
            f"point count divisible by {w}); shard sizes by rank: "
            f"{every.t().tolist()}")
    return group, w, me


def _lowest(values: torch.Tensor, ids: torch.Tensor, dim: int,
            largest: bool = False):
    """(extreme value, the lowest id among the entries attaining it) along
    ``dim``: the reference's two-level argmin/argmax tie rule."""
    v = values.amax(dim) if largest else values.amin(dim)
    best = torch.where(values == v.unsqueeze(dim), ids, _BIG).amin(dim)
    return v, best


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum((a - b)^2, -1) over three channels, ((dx*dx + dy*dy) + dz*dz)."""
    d = a - b
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


# ---------------------------------------------------------------------------
# Nearest neighbours with q sharded (K13), and the ring (K5)
# ---------------------------------------------------------------------------


class _NNSharded(torch.autograd.Function):
    """Forward: direction 1 against the local q shard (K13), global indices,
    the minimum over ranks (ties to the lowest rank, so to the lowest
    index); direction 2 of the local q against the whole p (K13). Backward:
    ``ops/chamfer.py``'s rule, direction 1 on the rows this rank's shard
    won, so p's gradient is a partial sum (``pvary`` adds the ranks')."""

    @staticmethod
    def forward(ctx, p, q, group):
        p, q = p.detach(), q.detach()
        w, me = dist.get_world_size(group), dist.get_rank(group)
        m_loc = q.shape[1]
        d_loc, i_loc = distance_tiles.nn_one_direction(p, q)
        i_loc = i_loc + me * m_loc
        # one gather: the distance's bits and the global index side by side
        both = gather_raw(torch.stack([d_loc, i_loc.view(torch.float32)]),
                          group)  # [W, 2, B, N]
        all_d, all_i = both[:, 0], both[:, 1].view(torch.int32)
        ranks = torch.arange(w, device=p.device)[:, None, None]
        d1, best = _lowest(all_d, ranks, 0)
        i1 = all_i.gather(0, best[None]).squeeze(0)
        d2, i2 = distance_tiles.nn_one_direction(q, p)
        ctx.save_for_backward(p, q, i1, i2)
        ctx.lo = me * m_loc
        ctx.mark_non_differentiable(i1, i2)
        return d1, i1, d2, i2

    @staticmethod
    def backward(ctx, g1, _, g2, __):
        p, q, i1, i2 = ctx.saved_tensors
        m_loc = q.shape[1]
        li = i1 - ctx.lo
        own = (li >= 0) & (li < m_loc)
        li = torch.where(own, li, 0)
        diff1 = p - gather_rows(q, li)
        gp = torch.where(own[..., None], 2.0 * g1[..., None] * diff1, 0.0)
        gq = scatter_add_auto(li, -gp, m_loc)
        diff2 = q - gather_rows(p, i2)
        gq = gq + 2.0 * g2[..., None] * diff2
        gp = gp + scatter_add_auto(i2, -2.0 * g2[..., None] * diff2,
                                   p.shape[1])
        return gp, gq, None


def nndistance_sharded(p, q, mesh, *, points_axis: str = "points"):
    """Bidirectional nndistance with q sharded over the points axis.

    Args:
      p: [B, N, 3], replicated.
      q: [B, M/W, 3], this rank's shard.

    Returns (dist1 [B,N], idx1 [B,N], dist2 [B,M/W], idx2 [B,M/W]):
    direction 1 replicated (global q indices), direction 2 the rank's
    shard; differentiable in the distances."""
    group, _, _ = _axis(mesh, points_axis, q)
    p, q = p.to(torch.float32), q.to(torch.float32)
    return _NNSharded.apply(pvary(p, group), q, group)


def chamfer_sharded(p, q, mesh, *, points_axis: str = "points"):
    """Mean bidirectional chamfer with q sharded over the points axis: a
    replicated scalar."""
    group = axis_group(mesh, points_axis)
    d1, _, d2, _ = nndistance_sharded(p, q, mesh, points_axis=points_axis)
    m = d2.shape[1] * dist.get_world_size(group)
    return (d1.mean(-1) + psum(d2.sum(-1), group) / m).mean()


def nndistance_ring(p, q, mesh, *, points_axis: str = "points"):
    """Fully sharded bidirectional nndistance by a ring pass: both clouds
    are the rank's shards ([B,N/W,3], [B,M/W,3]). Each of W steps matches
    the resident p shard against the visiting q shard (K5) and updates the
    local direction-1 minimum and the direction-2 minimum that travels with
    the q shard; shards visit out of index order, so a tie goes to the
    lower global index.

    Returns (dist1, idx1, dist2, idx2), each the rank's shard of its
    cloud, global indices. No gradient."""
    group, w, me = _axis(mesh, points_axis, p, q)
    p = p.detach().to(torch.float32)
    q_cur = q.detach().to(torch.float32)
    b, n_loc, _ = p.shape
    m_loc = q_cur.shape[1]
    dev = p.device
    d1 = torch.full((b, n_loc), float("inf"), device=dev)
    i1 = torch.zeros((b, n_loc), dtype=torch.int32, device=dev)
    d2 = torch.full((b, m_loc), float("inf"), device=dev)
    i2 = torch.zeros((b, m_loc), dtype=torch.int32, device=dev)
    for t in range(w):
        owner = (me - t) % w  # the visiting shard left rank me - t
        ld1, li1, ld2, li2 = distance_tiles.nn_both_directions(p, q_cur)
        li1 = li1 + owner * m_loc
        li2 = li2 + me * n_loc
        take1 = (ld1 < d1) | ((ld1 == d1) & (li1 < i1))
        d1, i1 = torch.where(take1, ld1, d1), torch.where(take1, li1, i1)
        take2 = (ld2 < d2) | ((ld2 == d2) & (li2 < i2))
        d2, i2 = torch.where(take2, ld2, d2), torch.where(take2, li2, i2)
        # after W rotations the travelling minima are home
        q_cur, d2, i2 = ring_shift([q_cur, d2, i2], group)
    return d1, i1, d2, i2


# ---------------------------------------------------------------------------
# Sampling and grouping
# ---------------------------------------------------------------------------


def furthest_point_sample_sharded(xyz, k: int, mesh, mask=None, *,
                                  points_axis: str = "points"):
    """FPS with the cloud sharded over the points axis: ``xyz`` [B,N/W,3]
    and ``mask`` [B,N/W] are the rank's shards.

    Each step takes the local argmax (lowest local index), gathers every
    rank's (value, global index), keeps the lowest global index among the
    maxima, and sums the winner's coordinates over the ranks (one rank
    holds them, the others add zeros). Index-identical to the one-device
    FPS; plain torch on the device, as the reference's body is XLA.

    Returns [B, k] int32 global indices, replicated."""
    group, _, me = _axis(mesh, points_axis, xyz)
    x = xyz.detach().to(torch.float32)
    b, n_loc, _ = x.shape
    dev = x.device
    if mask is None:
        mind = torch.full((b, n_loc), 1e10, device=dev)
    else:
        mind = torch.where(mask, 1e10, float("-inf")).to(torch.float32)
    iota = torch.arange(n_loc, device=dev)
    out = torch.empty((b, k), dtype=torch.long, device=dev)
    sel = None
    for j in range(k):
        if j > 0:
            mind = torch.minimum(mind, _sqdist(x, sel[:, None, :]))
        mloc, aloc = _lowest(mind, iota, 1, largest=True)
        # float64 carries the f32 maximum and the index exactly
        cand = torch.stack([mloc.double(), (aloc + me * n_loc).double()], -1)
        every = gather_raw(cand, group)  # [W, B, 2]
        _, gidx = _lowest(every[..., 0], every[..., 1], 0, largest=True)
        gidx = gidx.long()
        loc = gidx - me * n_loc
        here = (loc >= 0) & (loc < n_loc)
        c = x.gather(1, loc.clamp(0, n_loc - 1)[:, None, None].expand(b, 1, 3))
        sel = psum_raw(torch.where(here[:, None], c[:, 0], 0.0), group)
        out[:, j] = gidx
    return out.to(torch.int32)


def ball_query_sharded(xyz, centroids, radius: float, nsample: int, mesh,
                       mask=None, *, points_axis: str = "points"):
    """Ball query with the centroids sharded over the points axis: ``xyz``
    [B,N,3] and ``mask`` replicated, ``centroids`` [B,P/W,3] the rank's
    shard. No communication. Returns (idx [B,P/W,nsample], cnt [B,P/W])."""
    axis_group(mesh, points_axis)
    return ops.ball_query(xyz, centroids, radius, nsample, mask=mask)


def group_points_sharded(features, idx, mesh, *,
                         points_axis: str = "points"):
    """Neighbourhood gather with the queries sharded: ``features`` [B,N,C]
    replicated, ``idx`` [B,P/W,S] the rank's shard -> [B,P/W,S,C]. The
    forward needs no communication; the features' gradient is summed over
    the ranks."""
    group = axis_group(mesh, points_axis)
    return ops.group_points(pvary(features, group), idx)


def three_nn_sharded(unknown, known, mesh, *, points_axis: str = "points"):
    """three_nn with the dense cloud sharded: ``unknown`` [B,N/W,3] the
    rank's shard, ``known`` [B,M,3] replicated. Returns (dist [B,N/W,3],
    idx [B,N/W,3])."""
    group = axis_group(mesh, points_axis)
    return ops.three_nn(unknown, pvary(known, group))


def three_interpolate_sharded(features, idx, weight, mesh, *,
                              points_axis: str = "points"):
    """Feature interpolation with the target rows sharded: ``features``
    [B,M,C] replicated, ``idx``/``weight`` [B,N/W,3] the rank's shards ->
    [B,N/W,C]. The features' gradient is summed over the ranks."""
    group = axis_group(mesh, points_axis)
    return ops.three_interpolate(pvary(features, group), idx, weight)


def knn_sharded(query, support, k: int, mesh, support_mask=None, *,
                points_axis: str = "points"):
    """kNN with the queries sharded: ``query`` [B,Nq/W,3] the rank's shard,
    ``support`` and ``support_mask`` replicated. Returns (dist, idx)
    [B,Nq/W,k], equal to the one-device ``ops.knn`` on the shard."""
    group = axis_group(mesh, points_axis)
    return ops.knn(query, pvary(support, group), k,
                   support_mask=support_mask)


def sample_and_group_sharded(xyz, features, npoint: int, nsample: int,
                             radius: float, mesh, *, use_xyz: bool = True,
                             normalize_radius: bool = False, mask=None,
                             points_axis: str = "points"):
    """The SA front end (FPS -> ball query -> group -> centre) over the
    points axis: ``xyz`` [B,N/W,3], ``features`` [B,N/W,C] (or None) and
    ``mask`` [B,N/W] are the rank's shards. FPS runs on the shards; the
    cloud, features and mask are then gathered whole, and the query stages
    take the rank's slice of the npoint centroids.

    Returns (new_xyz [B,npoint,3] replicated, new_features
    [B,npoint/W,nsample,C'], idx [B,npoint/W,nsample], grouped_xyz
    [B,npoint/W,nsample,3]), the last three the rank's slices; equal to
    ``ops.sample_and_group`` (ball query grouping only)."""
    group = axis_group(mesh, points_axis)  # FPS checks the shards
    w, me = dist.get_world_size(group), dist.get_rank(group)
    if npoint % w:
        raise ValueError(f"npoint {npoint} does not split over the "
                         f"{points_axis!r} axis's {w} ranks")
    idx_fps = furthest_point_sample_sharded(xyz, npoint, mesh, mask,
                                            points_axis=points_axis)
    xyz_all = all_gather(xyz.to(torch.float32), group)
    mask_all = None
    if mask is not None:
        mask_all = gather_raw(mask.to(torch.uint8), group)  # [W, B, N/W]
        mask_all = mask_all.transpose(0, 1).reshape(xyz_all.shape[:2]).bool()
    new_xyz = ops.gather_points(xyz_all, idx_fps)
    p_loc = npoint // w
    cen = pvary(new_xyz, group)[:, me * p_loc:(me + 1) * p_loc]
    idx, _ = ops.ball_query(xyz_all, cen, radius, nsample, mask=mask_all)
    grouped_xyz = ops.group_points(pvary(xyz_all, group), idx)
    centered = grouped_xyz - cen[:, :, None, :]
    if normalize_radius:
        centered = _per_radius(centered, radius)
    if features is None:
        return new_xyz, centered, idx, grouped_xyz
    f_all = pvary(all_gather(features, group), group)
    grouped_features = ops.group_points(f_all, idx)
    new_features = (torch.cat([centered, grouped_features], dim=-1)
                    if use_xyz else grouped_features)
    return new_xyz, new_features, idx, grouped_xyz


# ---------------------------------------------------------------------------
# The auction EMD with the target's objects sharded
# ---------------------------------------------------------------------------


def _top2(net: torch.Tensor):
    """``jax.lax.top_k(net, 2)``: values descending, equal values in
    ascending index order ([B,N,M] -> [B,N,2] values, [B,N,2] indices)."""
    iota = torch.arange(net.shape[-1], device=net.device)
    v1, i1 = _lowest(net, iota, -1, largest=True)
    rest = net.scatter(-1, i1[..., None], float("-inf"))
    v2, i2 = _lowest(rest, iota, -1, largest=True)
    return torch.stack([v1, v2], -1), torch.stack([i1, i2], -1)


def _set_where(x: torch.Tensor, slot: torch.Tensor, value: torch.Tensor):
    """``x.at[b, slot].set(value, mode="drop")`` with ``slot`` [B] and
    ``slot == x.shape[1]`` dropped."""
    wide = torch.cat([x, x[:, :1]], 1)
    wide.scatter_(1, slot[:, None], value[:, None].to(x.dtype))
    return wide[:, :-1]


def _auction_sharded(p, q, eps: float, max_iters: int, group):
    """One rank's part of the flat-eps Jacobi auction with the objects (q)
    sharded, then the greedy completion: ``p`` [B,N,3] whole, ``q``
    [B,N/W,3] the rank's shard. Person state (the assignment) is
    replicated and advanced alike on every rank; object state (price,
    owner) stays with its shard. An iteration gathers every rank's top-2
    candidates and sums two per-person masks; a completion step gathers
    every rank's best free object.

    Assignment-identical to the reference's sharded body: the merge keeps
    top_k's value-then-lowest-index order, and the completion picks the
    (max benefit, min index) free object. Plain torch on the device, as
    the reference is XLA. Returns (assign [B,N] int64 global indices,
    auction iterations, completion steps)."""
    w, me = dist.get_world_size(group), dist.get_rank(group)
    b, n, _ = p.shape
    m_loc = q.shape[1]
    dev = p.device
    person_ids = torch.arange(n, device=dev).expand(b, n)
    assign = torch.full((b, n), -1, dtype=torch.long, device=dev)
    owner_loc = torch.full((b, m_loc), -1, dtype=torch.long, device=dev)
    price_loc = torch.zeros((b, m_loc), device=dev)
    neg = torch.tensor(_NEG, device=dev)
    it = 0
    while it < max_iters and bool((assign < 0).any()):
        net = -pairwise_sqdist(p, q) - price_loc[:, None, :]
        t2v, t2i = _top2(net)
        p_best = price_loc.gather(1, t2i[..., 0])  # [B, N]
        # one gather: f32 values, indices and prices, all exact in float64
        cand = torch.cat([t2v.double(), (t2i + me * m_loc).double(),
                          p_best[..., None].double()], -1)
        every = gather_raw(cand, group)  # [W, B, N, 5]
        av, ag, ap = every[..., :2], every[..., 2:4], every[..., 4]
        cv = av.permute(1, 2, 0, 3).reshape(b, n, 2 * w)
        cg = ag.permute(1, 2, 0, 3).reshape(b, n, 2 * w)
        v1, g1 = _lowest(cv, cg, -1, largest=True)
        v2 = torch.where(cg == g1[..., None], _NEG, cv).amax(-1)
        win0 = (av[..., 0] == v1) & (ag[..., 0] == g1)
        price1 = torch.where(win0, ap, 0.0).sum(0).float()
        v1, v2, g1 = v1.float(), v2.float(), g1.long()
        bidding = assign < 0
        bid = torch.where(bidding, price1 + (v1 - v2) + eps, neg)
        tloc = g1 - me * m_loc
        in_shard = (tloc >= 0) & (tloc < m_loc)
        tclip = tloc.clamp(0, m_loc - 1)
        slot = torch.where(in_shard & bidding, tloc, m_loc)
        best_loc = torch.full((b, m_loc + 1), _NEG, device=dev).scatter_reduce(
            1, slot, bid, "amax")[:, :m_loc]
        is_win = bidding & in_shard & (bid >= best_loc.gather(1, tclip))
        wslot = torch.where(is_win, tloc, m_loc)
        winner_loc = torch.full((b, m_loc + 1), n, device=dev).scatter_reduce(
            1, wslot, person_ids, "amin")[:, :m_loc]
        has_bid = winner_loc < n
        price_loc = torch.where(has_bid, best_loc, price_loc)
        prev_owner = torch.where(has_bid, owner_loc, -1)
        evict_slot = torch.where(prev_owner >= 0, prev_owner, n)
        evict = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
        evict.scatter_(1, evict_slot, 1)
        won_here = is_win & (winner_loc.gather(1, tclip) == person_ids)
        flags = psum_raw(torch.stack([evict[:, :n], won_here.int()]), group)
        assign = torch.where(flags[0] > 0, -1, assign)
        assign = torch.where(flags[1] > 0, g1, assign)
        owner_loc = torch.where(has_bid, winner_loc.clamp_max(n - 1),
                                owner_loc)
        it += 1

    iota_g = torch.arange(m_loc, device=dev) + me * m_loc
    barange = torch.arange(b, device=dev)
    steps = 0
    while bool((assign < 0).any()):
        unassigned = assign < 0
        do = unassigned.any(1)
        pi = torch.where(unassigned, person_ids, n).amin(1)
        pi = torch.where(do, pi, 0)  # the first unassigned person
        row = -_sqdist(p[barange, pi][:, None, :], q)  # [B, m_loc]
        masked = torch.where(owner_loc < 0, row, neg)
        mloc, aloc = _lowest(masked, iota_g, 1, largest=True)
        every = gather_raw(torch.stack([mloc.double(), aloc.double()], -1),
                           group)  # [W, B, 2]
        _, oj = _lowest(every[..., 0], every[..., 1], 0, largest=True)
        oj = oj.long()
        assign = _set_where(assign, torch.where(do, pi, n), oj)
        ojl = oj - me * m_loc
        o_slot = torch.where(do & (ojl >= 0) & (ojl < m_loc), ojl, m_loc)
        owner_loc = _set_where(owner_loc, o_slot, pi)
        steps += 1
    return assign, it, steps


class _EMDSharded(torch.autograd.Function):
    """Forward: the sharded auction on the detached clouds, then the
    matched squared distances against the gathered q. Backward, as the
    reference's ``_emd_sharded_bwd``: gp = 2 g (p - q[assign]) whole on
    every rank, gq the rank's slice of scatter_add(assign, -gp)."""

    @staticmethod
    def forward(ctx, p, q, eps, max_iters, group):
        p, q = p.detach(), q.detach()
        assign, it, steps = _auction_sharded(p, q, eps, max_iters, group)
        earth_mover_distance_sharded.stats = {"iterations": it,
                                              "completion_steps": steps}
        b, n, _ = p.shape
        q_all = gather_raw(q, group).transpose(0, 1).reshape(b, n, 3)
        diff = p - q_all.gather(1, assign[..., None].expand(b, n, 3))
        dx, dy, dz = diff.unbind(-1)
        ctx.save_for_backward(assign, diff)
        ctx.lo, ctx.m_loc = dist.get_rank(group) * q.shape[1], q.shape[1]
        assign = assign.to(torch.int32)
        ctx.mark_non_differentiable(assign)
        return (dx * dx + dy * dy) + dz * dz, assign

    @staticmethod
    def backward(ctx, g, _):
        assign, diff = ctx.saved_tensors
        gp = 2.0 * g[..., None] * diff
        gq = scatter_add_auto(assign, -gp, diff.shape[1])
        return gp, gq[:, ctx.lo:ctx.lo + ctx.m_loc], None, None, None


def earth_mover_distance_sharded(p, q, mesh, eps: float = 0.005,
                                 max_iters: int = 45, p_mask=None,
                                 q_mask=None, *, points_axis: str = "points"):
    """Auction EMD with the target cloud's objects sharded over the points
    axis: ``p`` [B,N,3] and ``p_mask`` replicated, ``q`` [B,N/W,3] and
    ``q_mask`` the rank's shards.

    The assignment is the reference's flat-eps Jacobi auction
    (``max_iters`` iterations, no eps-scaling phases) with greedy
    completion, not the one-device EMD's K11/K12. Masks follow
    ``ops.earth_mover_distance``: equal valid counts, invalid slots
    rank-matched to each other at distance 0 (the q shards' ranks counted
    globally), masked outputs (0, 0).

    Returns (dist [B,N], assign [B,N] int32), replicated; gradients flow
    along the matched pairs only. ``earth_mover_distance_sharded.stats``
    holds the last call's auction iterations and completion steps."""
    group, w, me = _axis(mesh, points_axis, q)
    p, q = p.to(torch.float32), q.to(torch.float32)
    if p.ndim != 3 or q.ndim != 3 or p.shape[1] != q.shape[1] * w \
            or p.shape[0] != q.shape[0]:
        raise ValueError(f"EMD needs equal-shape [B,N,3] clouds, got "
                         f"{tuple(p.shape)} vs {w} shards of "
                         f"{tuple(q.shape)}")
    pp = _poison_rank_matched(p, p_mask)
    if q_mask is not None:
        # the invalid slots of the shards before this one
        counts = gather_raw((~q_mask).sum(1), group)  # [W, B]
        q = _poison_rank_matched(q, q_mask, counts[:me].sum(0))
    dist_, assign = _EMDSharded.apply(pp, q, float(eps), int(max_iters),
                                      group)
    if p_mask is not None:
        dist_ = torch.where(p_mask, dist_, 0.0)
        assign = torch.where(p_mask, assign, 0)
    return dist_, assign


earth_mover_distance_sharded.stats = {}
