"""Inputs and weights drawn from a run's seed, on the run's device.

Clouds are points on the surfaces of random shapes, as ShapeNet's are:
each cloud is one to three parts (a sphere, a box, a cylinder with its
caps, or a torus), each part under its own random linear map and shift,
the whole centred and scaled into the unit sphere. Batch ``i`` of a pool
comes from its own generator, seeded from (seed, stream, i), so any batch
can be drawn again alone. Weights come from one generator and one uniform
draw for the whole model.
"""

from __future__ import annotations

import math
import time

import torch

_GOLDEN = 0x9E3779B97F4A7C15
STREAM_DATA, STREAM_WEIGHTS, STREAM_ARRIVALS, STREAM_SAMPLE = 1, 2, 3, 4


def mix(seed: int, stream: int, i: int = 0) -> int:
    """A 63-bit generator seed from a run's seed (any whole number), a
    stream id and an index."""
    h = (int(seed) * _GOLDEN + stream * 0x632BE59BD9B4E019 + i) % (1 << 64)
    h ^= h >> 29
    h = (h * 0xBF58476D1CE4E5B9) % (1 << 64)
    return h >> 1


def generator(device, seed: int, stream: int, i: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, stream, i))


def _rotations(g, m, device):
    """[m,3,3] random rotations: Gram-Schmidt on two Gaussian vectors,
    the third their cross product."""
    a = torch.randn((m, 2, 3), generator=g, device=device)
    e1 = a[:, 0] / a[:, 0].norm(dim=-1, keepdim=True)
    v = a[:, 1] - (a[:, 1] * e1).sum(-1, keepdim=True) * e1
    e2 = v / v.norm(dim=-1, keepdim=True)
    return torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=-1)


def surface_clouds(b: int, n: int, device, seed: int, i: int,
                   max_parts: int = 3) -> torch.Tensor:
    """[b,n,3] float32 clouds of batch ``i`` for ``seed``."""
    device = torch.device(device)
    g = generator(device, seed, STREAM_DATA, i)
    parts = torch.randint(1, max_parts + 1, (b, 1), generator=g,
                          device=device)
    kind = torch.randint(0, 4, (b, max_parts), generator=g, device=device)
    scale = 0.3 + 0.7 * torch.rand((b, max_parts, 3), generator=g,
                                   device=device)
    shift = torch.rand((b, max_parts, 3), generator=g, device=device) - 0.5
    rot = _rotations(g, b * max_parts, device).reshape(b, max_parts, 3, 3)
    u, v, w, s = torch.rand((4, b, n), generator=g, device=device)
    part = torch.minimum((s * parts).long(), parts - 1)  # [b,n]

    two_pi = 2.0 * math.pi
    # sphere
    z = 2.0 * u - 1.0
    rxy = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    sphere = torch.stack([rxy * torch.cos(two_pi * v),
                          rxy * torch.sin(two_pi * v), z], -1)
    # box: a face from w, the point on it from (u, v)
    face = torch.minimum((w * 6).long(), torch.tensor(5, device=device))
    axis, sign = face // 2, (face % 2).float() * 2.0 - 1.0
    a, c = 2.0 * u - 1.0, 2.0 * v - 1.0
    box = torch.stack([
        torch.where(axis == 0, sign, a),
        torch.where(axis == 1, sign, torch.where(axis == 0, a, c)),
        torch.where(axis == 2, sign, c)], -1)
    # cylinder: the side for w < 0.7, else a cap
    side = w < 0.7
    rr = torch.where(side, torch.ones_like(u), torch.sqrt(u))
    ang = two_pi * torch.where(side, u, v)
    cz = torch.where(side, 2.0 * v - 1.0, torch.where(w < 0.85, -1.0, 1.0))
    cyl = torch.stack([rr * torch.cos(ang), rr * torch.sin(ang), cz], -1)
    # torus, R = 1, r = 0.35
    th, ph = two_pi * u, two_pi * v
    ring = 1.0 + 0.35 * torch.cos(ph)
    torus = torch.stack([ring * torch.cos(th), ring * torch.sin(th),
                         0.35 * torch.sin(ph)], -1)

    k = kind.gather(1, part)[..., None]  # [b,n,1]
    pts = torch.where(k == 0, sphere, torch.where(
        k == 1, box, torch.where(k == 2, cyl, torch.where(
            k == 3, torus, sphere))))
    sel = part[..., None].expand(b, n, 3)
    pts = pts * scale.gather(1, sel)
    r = rot.gather(1, part[..., None, None].expand(b, n, 3, 3))
    pts = (r @ pts[..., None])[..., 0] + shift.gather(1, sel)
    pts = pts - pts.mean(dim=1, keepdim=True)
    radius = pts.norm(dim=-1).amax(dim=1)[:, None, None]
    return (pts / radius).contiguous()


def subset(x: torch.Tensor, m: int, device, seed: int, i: int):
    """[b,n,3] -> [b,m,3]: each cloud's rows at m distinct indices drawn
    from (seed, i)."""
    b, n, _ = x.shape
    g = generator(device, seed, STREAM_SAMPLE, i)
    keys = torch.rand((b, n), generator=g, device=x.device)
    idx = keys.argsort(dim=1)[:, :m]
    return x.gather(1, idx[..., None].expand(b, m, 3)).contiguous()


def weights(spec, device, seed: int) -> dict[str, torch.Tensor]:
    """Parameters for ``spec`` ([(name, shape, kind)]) in one draw: a
    Linear weight ("linear") a normal truncated at 2 standard deviations
    with variance 1 / fan-in; a bias U(-0.1, 0.1); a norm's scale
    1 + U(-0.1, 0.1)."""
    device = torch.device(device)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    total = sum(sizes)
    g = generator(device, seed, STREAM_WEIGHTS)
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    kinds = torch.tensor([{"linear": 0, "bias": 1, "norm_scale": 2}[k]
                          for _, _, k in spec], device=device)
    fan = torch.tensor([float(shape[-1]) for _, shape, _ in spec],
                       device=device)
    counts = torch.tensor(sizes, device=device)
    kind_e = torch.repeat_interleave(kinds, counts)
    std_e = torch.repeat_interleave(
        torch.rsqrt(fan) / 0.87962566103423978, counts)
    bound = math.erf(2.0 / math.sqrt(2.0))
    normal = torch.erfinv(u * bound) * math.sqrt(2.0)
    flat = torch.where(kind_e == 0, normal * std_e,
                       torch.where(kind_e == 1, 0.1 * u, 1.0 + 0.1 * u))
    out = {}
    for (name, shape, _), part in zip(spec, flat.split(sizes)):
        out[name] = part.view(shape)
    return out


class Phases:
    """Seconds each phase of a set-up took, each ended by a synchronise
    (the first phase also pays for the CUDA context)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now
