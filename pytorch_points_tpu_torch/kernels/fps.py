"""Furthest point sampling with emitted coordinates (kernel K1).

CUDA kernel: ``csrc/fps.cu``, which replaces the TPU kernel
``pytorch_points_tpu/kernels/fps.py::_fps_kernel``. The header note there
says what bounds it on the card and how the design meets it: each cloud
on chip (coordinates in shared memory, running minima in registers) in one
block, bucketed into Morton cells so that a warp skips a step's fold when
its bounding box lies beyond its points' running minima; one barrier a
step. Past 16,384 points a cloud takes the streaming kernel.
"""

from __future__ import annotations

import torch

from pytorch_points_tpu_torch.kernels import _build, dispatch

_ppt_fps = _build.entry("ppt_fps")
_ppt_fps_step_floor = _build.entry("ppt_fps_step_floor")

# The largest cloud the kernel keeps on chip, on one block (192 KB of
# coordinates in shared memory). Larger clouds take the streaming kernel
# (running min in a scratch buffer).
BLOCK_POINTS = 16384


def fps_torch(xyz: torch.Tensor, k: int, mask: torch.Tensor | None = None,
              seed_idx: torch.Tensor | None = None):
    """Plain version: [B,N,3] f32 -> (idx [B,k] int32, coords [B,k,3]).

    Same arithmetic and tie rule as the kernel: d = (dx*dx + dy*dy) + dz*dz,
    argmax = the lowest index attaining the max, no min-fold at step 0.
    """
    b, n, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    if mask is None:
        mind = torch.full((b, n), 1e10, dtype=torch.float32,
                          device=xyz.device)
    else:
        mind = torch.where(mask, 1e10, float("-inf")).to(torch.float32)
    if seed_idx is not None:
        mind[torch.arange(b, device=xyz.device), seed_idx.long()] = 2e10
    iota = torch.arange(n, device=xyz.device)
    idx = torch.empty((b, k), dtype=torch.long, device=xyz.device)
    sel = None
    for j in range(k):
        if j > 0:
            sx, sy, sz = (c.gather(1, sel) for c in (x, y, z))
            dx, dy, dz = x - sx, y - sy, z - sz
            mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        m = mind.amax(dim=1, keepdim=True)
        sel = torch.where(mind == m, iota, n).amin(dim=1, keepdim=True)
        idx[:, j : j + 1] = sel
    coords = xyz.gather(1, idx[..., None].expand(b, k, 3))
    return idx.to(torch.int32), coords


def fps_cuda(xyz: torch.Tensor, k: int, mask: torch.Tensor | None = None,
             seed_idx: torch.Tensor | None = None):
    """Launch the CUDA kernel: same contract as :func:`fps_torch`.

    Clouds of up to :data:`BLOCK_POINTS` points stay on chip, one block a
    cloud; larger ones take the streaming kernel."""
    b, n, _ = xyz.shape
    _build.require(xyz, "fps xyz", torch.float32, (b, n, 3))
    if mask is not None:
        _build.require(mask, "fps mask", torch.bool, (b, n))
    if seed_idx is not None:
        _build.require(seed_idx, "fps seed_idx", torch.int32, (b,))
    if n < 1 or k < 1:
        raise ValueError(f"fps needs N >= 1 and k >= 1, got N={n} k={k}")
    idx = torch.empty((b, k), dtype=torch.int32, device=xyz.device)
    coords = torch.empty((b, k, 3), dtype=torch.float32, device=xyz.device)
    scratch = None
    if n > BLOCK_POINTS:
        scratch = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    err = _ppt_fps(
        xyz.data_ptr(), _build.ptr(mask), _build.ptr(seed_idx), b, n, k,
        idx.data_ptr(), coords.data_ptr(),
        _build.ptr(scratch), _build.stream(xyz),
    )
    _build.check(err, "ppt_fps")
    fps_cuda.launches += 1
    return idx, coords


fps_cuda.launches = 0


@torch.library.custom_op("ppt::fps", mutates_args=())
def _fps_op(xyz: torch.Tensor, k: int, mask: torch.Tensor | None,
            seed_idx: torch.Tensor | None) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """K1 as one op for a traced program (kernels.dispatch.traced)."""
    if xyz.is_cuda:
        return fps_cuda(xyz, k, mask, seed_idx)
    return fps_torch(xyz, k, mask, seed_idx)


@_fps_op.register_fake
def _(xyz, k, mask, seed_idx):
    b = xyz.shape[0]
    return (xyz.new_empty((b, k), dtype=torch.int32),
            xyz.new_empty((b, k, 3)))


def fps_step_floor(n: int, iters: int = 4096,
                   device: str | torch.device = "cuda"):
    """(cycles, ns) of one empty step on the block :func:`fps_cuda` takes
    for clouds of ``n`` points: the warp reductions, the slot stores, the
    barrier, the reduction over every slot and the winner's coordinates,
    each step depending on the one before, from clock64 and %globaltimer
    around ``iters`` of them on the card. k times it is K1's latency
    bound. A measurement aid, not a kernel of any path."""
    out = torch.zeros(3, dtype=torch.int64, device=device)
    err = _ppt_fps_step_floor(n, iters, out.data_ptr(), _build.stream(out))
    _build.check(err, "ppt_fps_step_floor")
    cycles, ns, _ = out.tolist()
    return cycles / iters, ns / iters


def furthest_point_sample(xyz: torch.Tensor, k: int,
                          mask: torch.Tensor | None = None,
                          seed_idx: torch.Tensor | None = None,
                          emit_coords: bool = False, impl: str = "auto"):
    """[B,N,3] -> idx [B,k] int32, or (idx, coords [B,k,3] f32) with
    ``emit_coords=True``, as the reference returns them.

    The coordinates are bitwise equal to gathering ``xyz`` at ``idx`` (the
    kernel writes them as it selects). ``mask`` ([B,N] bool) marks valid
    points; masked points are never selected while a valid one is left.
    ``seed_idx`` ([B] int32) forces the first selection per cloud.
    """
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"expected [B,N,3], got {tuple(xyz.shape)}")
    xyz = xyz.to(torch.float32)
    traced = dispatch.traced(impl)
    if dispatch.resolve(impl, xyz, "fps") == "cuda" or traced:
        if seed_idx is not None:
            seed_idx = seed_idx.to(torch.int32).contiguous()
        launch = _fps_op if traced else fps_cuda
        idx, coords = launch(xyz.contiguous(), k,
                             None if mask is None else mask.contiguous(),
                             seed_idx)
    else:
        idx, coords = fps_torch(xyz, k, mask, seed_idx)
    return (idx, coords) if emit_coords else idx
