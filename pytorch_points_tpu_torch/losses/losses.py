"""Loss callables (counterpart of the JAX ``losses/losses.py``): Chamfer,
EMD, SMAPE, the point and mesh Laplacian losses, the normal loss, the
point and mesh edge-length losses, repulsion and uniformity. Each is a
frozen dataclass: configuration in the constructor, the loss in
``__call__``; ``impl`` selects the kernels' route (kernels.dispatch).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pytorch_points_tpu_torch import geo
from pytorch_points_tpu_torch.ops import (
    earth_mover_distance,
    furthest_point_sample,
    gather_points,
    group_points,
    knn,
    nndistance,
    pairwise_sqdist,
)


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


@dataclasses.dataclass(frozen=True)
class ChamferLoss:
    """Bidirectional Chamfer loss with optional trimming.

    ``threshold`` zeroes per-point distances at or above it;
    ``percentage < 1`` keeps only that fraction of the smallest per-point
    distances in each direction (of the *valid* count when masked).
    """

    threshold: float | None = None
    percentage: float = 1.0
    one_sided: bool = False
    reduction: str = "mean"
    impl: str = "auto"

    def __call__(self, pred, gt, pred_mask=None, gt_mask=None):
        d1, _, d2, _ = nndistance(pred, gt, pred_mask, gt_mask,
                                  impl=self.impl)

        def direction(d, mask):
            if self.threshold is not None:
                d = torch.where(d < self.threshold, d, 0.0)
            if self.percentage < 1.0:
                n = d.shape[-1]
                if mask is not None:
                    # masked points sort to the end as +inf
                    d = torch.where(mask, d, torch.inf)
                    keep = torch.clamp_min(
                        (mask.sum(-1) * self.percentage).to(torch.int32), 1)
                    d_sorted = torch.sort(d, dim=-1).values
                    sel = torch.arange(n, device=d.device) < keep[..., None]
                    kept = torch.where(
                        sel, torch.where(torch.isinf(d_sorted), 0.0,
                                         d_sorted), 0.0)
                    return kept.sum(-1) / keep
                keep = max(1, int(n * self.percentage))
                return torch.sort(d, dim=-1).values[..., :keep].mean(-1)
            if mask is not None:
                return (torch.where(mask, d, 0.0).sum(-1)
                        / torch.clamp_min(mask.sum(-1), 1))
            return d.mean(-1)

        loss = direction(d1, pred_mask)
        if not self.one_sided:
            loss = loss + direction(d2, gt_mask)
        return _reduce(loss, self.reduction)


@dataclasses.dataclass(frozen=True)
class EMDLoss:
    """Auction-EMD loss (mean matched squared distance).

    Training operating point: ``endgame_pop_cap`` defaults to 384 here
    (vs 768 on the raw op and the metrics). On the correlated pairs a train
    step feeds the loss, 384 stays close to the Hungarian optimum at a
    lower endgame cost; the op's 768 buys assignment fidelity that matters
    when EMD is the *measurement*.

    MEASURED WORST CASE of this default (the JAX reference's 8-element
    Hungarian oracle; the port computes the same assignments): on UNCORRELATED standard-normal cloud pairs -- unlike
    anything a converging model emits, but exactly what a randomly
    initialized generator's first steps look like -- pop cap 384 measured
    **+3.2% mean / +5.03% max** over the optimum, i.e. the max can exceed
    the library's 5% near-optimality bar. If your training pairs are
    near-random (or you use this class as a *metric*), pass
    ``endgame_pop_cap=768``, which measured +1.35% / +2.05% on the same
    clouds.
    """

    eps: float = 0.005
    max_iters: int = 15
    phases: int = 3
    endgame_pop_cap: int = 384
    reduction: str = "mean"
    impl: str = "auto"

    def __call__(self, pred, gt, pred_mask=None, gt_mask=None):
        dist, _ = earth_mover_distance(
            pred, gt, eps=self.eps, max_iters=self.max_iters,
            phases=self.phases, impl=self.impl,
            endgame_pop_cap=self.endgame_pop_cap, p_mask=pred_mask,
            q_mask=gt_mask,
        )
        if pred_mask is None:
            per = dist.mean(-1)
        else:  # masked slots carry dist 0; mean over the VALID count
            per = dist.sum(-1) / torch.clamp_min(pred_mask.sum(-1), 1)
        return _reduce(per, self.reduction)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


@dataclasses.dataclass(frozen=True)
class SmapeLoss:
    """Symmetric mean absolute percentage error |x-y| / (|x|+|y|+eps)."""

    eps: float = 1e-8
    reduction: str = "mean"

    def __call__(self, pred, gt):
        e = (pred - gt).abs() / (pred.abs() + gt.abs() + self.eps)
        return _reduce(e, self.reduction)


@dataclasses.dataclass(frozen=True)
class PointLaplacianLoss:
    """Compare the graph-Laplacian coordinates of two clouds under the
    *reference cloud's* kNN neighbourhoods (detail preservation):
    ``metric`` "l2" (squared) or "l1" of the difference, or of the
    magnitudes alone with ``use_norm``."""

    k: int = 8
    metric: str = "l2"  # l2 | l1
    use_norm: bool = False  # compare magnitudes only
    reduction: str = "mean"
    impl: str = "auto"

    def __call__(self, gt, pred, gt_mask=None):
        lap_gt, idx = geo.point_laplacian(gt, self.k, mask=gt_mask,
                                          impl=self.impl)
        lap_pred, _ = geo.point_laplacian(pred, self.k, idx=idx,
                                          impl=self.impl)
        if self.use_norm:
            a, b = _norm(lap_gt), _norm(lap_pred)
        else:
            a, b = lap_gt, lap_pred
        diff = (a - b).abs() if self.metric == "l1" else (a - b) ** 2
        if gt_mask is not None:
            diff = torch.where(gt_mask[..., None] if diff.dim() == 3
                               else gt_mask, diff, 0.0)
        return _reduce(diff, self.reduction)


@dataclasses.dataclass(frozen=True)
class MeshLaplacianLoss:
    """Laplacian comparison (or magnitude) on meshes of one topology: the
    uniform Laplacian (``faces_or_edges`` edges) or the cotangent one
    (faces). With ``compare`` and ``verts_ref``, the squared change of the
    Laplacian; otherwise its squared magnitude (smoothing)."""

    uniform: bool = True
    compare: bool = True
    reduction: str = "mean"
    impl: str = "auto"

    def __call__(self, verts, faces_or_edges, verts_ref=None):
        lap_fn = geo.uniform_laplacian if self.uniform else geo.cot_laplacian
        lap = lap_fn(verts, faces_or_edges, impl=self.impl)
        if self.compare and verts_ref is not None:
            lap_ref = lap_fn(verts_ref, faces_or_edges, impl=self.impl)
            return _reduce((lap - lap_ref) ** 2, self.reduction)
        return _reduce(lap**2, self.reduction)


@dataclasses.dataclass(frozen=True)
class NormalLoss:
    """1 - |cos| between the normals of matched (nearest) points: each
    prediction point's nearest ground-truth point (the dense or sorted
    NN), its normal gathered (K3)."""

    reduction: str = "mean"
    impl: str = "auto"

    def __call__(self, pred, pred_normals, gt, gt_normals):
        _, idx, _, _ = nndistance(pred, gt, impl=self.impl)
        matched = gather_points(gt_normals, idx, self.impl)
        cos = (pred_normals * matched).sum(-1)
        denom = torch.clamp_min(_norm(pred_normals) * _norm(matched), 1e-12)
        return _reduce(1.0 - (cos / denom).abs(), self.reduction)


@dataclasses.dataclass(frozen=True)
class PointEdgeLengthLoss:
    """Penalise the change of kNN edge lengths between two clouds, under
    the first cloud's neighbourhoods (self excluded)."""

    k: int = 8
    metric: str = "l2"
    reduction: str = "mean"
    impl: str = "auto"

    def __call__(self, gt, pred):
        _, idx = knn(gt, gt, self.k + 1, impl=self.impl)
        idx = idx[..., 1:]
        d_gt = _norm(group_points(gt, idx, self.impl) - gt[:, :, None, :])
        d_pred = _norm(group_points(pred, idx, self.impl)
                       - pred[:, :, None, :])
        diff = ((d_gt - d_pred).abs() if self.metric == "l1"
                else (d_gt - d_pred) ** 2)
        return _reduce(diff, self.reduction)


@dataclasses.dataclass(frozen=True)
class MeshEdgeLengthLoss:
    """Penalise mesh edge-length deviation: from ``verts_ref``'s lengths,
    or else from each mesh's mean edge length."""

    reduction: str = "mean"
    impl: str = "auto"

    def __call__(self, verts, edges, verts_ref=None):
        el = geo.edge_lengths(verts, edges, impl=self.impl)
        if verts_ref is not None:
            target = geo.edge_lengths(verts_ref, edges, impl=self.impl)
            return _reduce((el - target) ** 2, self.reduction)
        return _reduce((el - el.mean(-1, keepdim=True)) ** 2,
                       self.reduction)


@dataclasses.dataclass(frozen=True)
class RepulsionLoss:
    """3PU-style repulsion: push kNN neighbours apart below radius h.

    loss = mean_i mean_j eta(d_ij) w(d_ij), eta(d) = -d, w(d) = exp(-d^2 /
    h^2), over each point's k nearest other points; minimised when
    neighbours spread out. Differentiable through the kNN distances in both
    roles of ``xyz`` (query and support), the neighbour set held constant.
    """

    k: int = 4
    h: float = 0.03
    reduction: str = "mean"
    impl: str = "auto"

    def __call__(self, xyz, mask=None):
        dist2, _ = knn(xyz, xyz, self.k + 1, support_mask=mask,
                       impl=self.impl)
        dist2 = dist2[..., 1:]  # drop self
        d = torch.sqrt(torch.clamp_min(dist2, 1e-12))
        loss = -d * torch.exp(-dist2 / (self.h**2))
        if mask is not None:
            loss = torch.where(mask[..., None], loss, 0.0)
        return _reduce(loss, self.reduction)


@dataclasses.dataclass(frozen=True)
class UniformLoss:
    """PU-GAN-style uniformity: the chi^2 of each FPS centre's in-ball count
    against the expected count n p, at several ball radii sqrt(p), averaged
    over the radii.

    The counts are exact, uncapped, as the reference's since its round 2
    (``nsample`` is kept for its API and limits nothing); the original
    library capped them at nsample (PARITY.md). Every term is a count, so
    the loss has no gradient. The [B, npoint, N] distance plane is taken
    in chunks along N, as the reference takes them.
    """

    npoint: int = 256
    radii: tuple[float, ...] = (0.004, 0.006, 0.008, 0.010, 0.012)
    nsample: int = 32
    reduction: str = "mean"
    impl: str = "auto"

    def __call__(self, xyz, mask=None):
        xyz = xyz.detach()
        if mask is not None:  # the expected count is of the valid points
            n = mask.sum(1).to(torch.float32)[:, None]
        else:
            n = xyz.shape[1]
        fidx = furthest_point_sample(xyz, self.npoint, mask=mask,
                                     impl=self.impl)
        centers = gather_points(xyz, fidx, impl=self.impl)
        big_n = xyz.shape[1]
        cs = max(256, min(big_n,
                          (32 << 20) // (4 * xyz.shape[0] * self.npoint)))
        cnts = [0] * len(self.radii)
        for s in range(0, big_n, cs):
            d2 = pairwise_sqdist(centers, xyz[:, s : s + cs])
            if mask is not None:
                d2 = torch.where(mask[:, None, s : s + cs], d2, torch.inf)
            for ri, p in enumerate(self.radii):
                r = math.sqrt(p)  # p = disk-area fraction
                cnts[ri] = cnts[ri] + (d2 < r * r).sum(-1)
        total = 0.0
        for cnt, p in zip(cnts, self.radii):
            expected = n * p
            chi2 = (cnt.to(torch.float32) - expected) ** 2 / expected
            total = total + _reduce(chi2, self.reduction)
        return total / len(self.radii)
