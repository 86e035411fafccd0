"""Differentiable point splatting (counterpart of the JAX
``geo/splatting.py``; the DSS lineage).

Screen-space gaussian splats with a soft z-buffer, differentiable in the
points' positions, colours, normals and the splat size. It is dense
[pixels x points] arithmetic in plain PyTorch, as the reference's is plain
XLA: no rasterizer, no kernel of its own.

Two footprints:
  * isotropic screen-space gaussians (``normals=None``);
  * EWA ellipses (``normals`` [B,N,3]): each point an oriented disk whose
    screen footprint is the gaussian that the projection's Jacobian makes
    of the disk's tangent frame, so gradients reach the normals too.
"""

from __future__ import annotations

import dataclasses

import torch

from pytorch_points_tpu_torch.ops.normals import cross


def _vec(t, device) -> torch.Tensor:
    return torch.tensor(t, dtype=torch.float32, device=device)


def _unit(x: torch.Tensor, floor: float | None = None) -> torch.Tensor:
    n = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / (n if floor is None else torch.clamp_min(n, floor))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Look-at pinhole camera (orthographic when ``focal`` is None)."""

    eye: tuple = (0.0, 0.0, 3.0)
    target: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    focal: float | None = None  # None = orthographic
    ortho_scale: float = 1.2  # half-extent of the orthographic frustum

    def rotation(self, device=None) -> torch.Tensor:
        """[3,3] world -> camera basis (right, up, -forward)."""
        eye = _vec(self.eye, device)
        fwd = _unit(_vec(self.target, device) - eye)
        right = _unit(cross(fwd, _vec(self.up, device)))
        return torch.stack([right, cross(right, fwd), -fwd])

    def world_to_cam(self, xyz: torch.Tensor) -> torch.Tensor:
        return (xyz - _vec(self.eye, xyz.device)) @ self.rotation(
            xyz.device).T

    def project(self, xyz: torch.Tensor):
        """[..., 3] world -> (uv in [-1,1]^2, depth)."""
        c = self.world_to_cam(xyz)
        z = -c[..., 2]  # positive depth in front of the camera
        if self.focal is None:
            uv = c[..., :2] / self.ortho_scale
        else:
            uv = self.focal * c[..., :2] / torch.clamp_min(z[..., None],
                                                           1e-6)
        return uv, z

    def uv_jacobian(self, cam_xyz: torch.Tensor) -> torch.Tensor:
        """d(uv)/d(camera xyz) at each camera-space point: [..., 2, 3]."""
        if self.focal is None:
            j = cam_xyz.new_zeros(cam_xyz.shape[:-1] + (2, 3))
            j[..., 0, 0] = 1.0 / self.ortho_scale
            j[..., 1, 1] = 1.0 / self.ortho_scale
            return j
        x, y = cam_xyz[..., 0], cam_xyz[..., 1]
        z = torch.clamp_min(-cam_xyz[..., 2], 1e-6)  # positive depth
        f = self.focal
        zero = torch.zeros_like(z)
        # uv = f (x, y) / z with z = -cam_z: d uv / d cam_z = +f x / z^2
        row0 = torch.stack([f / z, zero, f * x / (z * z)], -1)
        row1 = torch.stack([zero, f / z, f * y / (z * z)], -1)
        return torch.stack([row0, row1], -2)


def _ewa_inverse_cov(xyz, normals, camera: Camera, splat_radius: float,
                     min_footprint: float):
    """Per-point inverse screen covariance (invA, invB, invC) of the EWA
    ellipse, and the normal's camera-facing component."""
    cam = camera.world_to_cam(xyz)  # [B,N,3]
    nrm = _unit(normals.to(torch.float32) @ camera.rotation(xyz.device).T,
                1e-8)
    # tangent frame: the helper axis least aligned with the normal (its
    # choice is piecewise constant, so no gradient flows through it)
    pick_z = (nrm[..., 2].abs() < 0.9).detach()[..., None]
    helper = torch.where(pick_z, _vec((0.0, 0.0, 1.0), xyz.device),
                         _vec((1.0, 0.0, 0.0), xyz.device))
    t1 = _unit(cross(nrm, helper), 1e-8)
    t2 = cross(nrm, t1)  # unit, perpendicular to n and t1
    j = camera.uv_jacobian(cam)  # [B,N,2,3]
    a1 = splat_radius * (j * t1[..., None, :]).sum(-1)  # [B,N,2]
    a2 = splat_radius * (j * t2[..., None, :]).sum(-1)
    va = a1[..., 0] ** 2 + a2[..., 0] ** 2 + min_footprint  # S00
    vb = a1[..., 0] * a1[..., 1] + a2[..., 0] * a2[..., 1]  # S01
    vc = a1[..., 1] ** 2 + a2[..., 1] ** 2 + min_footprint  # S11
    det = torch.clamp_min(va * vc - vb * vb, 1e-16)
    return vc / det, -vb / det, va / det, nrm[..., 2]


def pixel_grid(image_size: int, device=None) -> torch.Tensor:
    """[H*W, 2] pixel centres in NDC, y down: ``jnp.linspace(-1, 1, n)``
    by the formula JAX traces (start (1 - t) + stop t, t = i / (n - 1), the
    end point exact), which gives the reference's pixels to within an ulp
    of 1."""
    n = image_size
    if n > 1:
        t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
        px = torch.cat([-1.0 * (1 - t) + 1.0 * t,
                        torch.ones(1, device=device)])
    else:
        px = -torch.ones(1, device=device)
    gy, gx = torch.meshgrid(px, px, indexing="ij")
    return torch.stack([gx, -gy], dim=-1).reshape(-1, 2)


def render_points(xyz: torch.Tensor, colors: torch.Tensor | None = None, *,
                  normals: torch.Tensor | None = None,
                  camera: Camera = Camera(), image_size: int = 128,
                  splat_radius: float = 0.02,
                  depth_temperature: float = 1e-2,
                  mask: torch.Tensor | None = None, backface: str = "none"):
    """Differentiable splat rendering.

    xyz [B,N,3] world points; colors [B,N,C] (default: intensity 1);
    normals [B,N,3] or None (EWA ellipses of world radius
    ``splat_radius``, or isotropic gaussians of NDC sigma
    ``splat_radius``); ``depth_temperature`` the soft z-buffer's (smaller:
    harder occlusion); mask [B,N] validity; backface "none" (two-sided
    splats) or "soft" (each weight scaled by a sigmoid of the normal's
    camera-facing component; needs normals).

    Returns (image [B,H,W,C], alpha [B,H,W]), alpha the splats' coverage.
    Memory: a few [B, H W, N] float32 temporaries (0.5 GB each at B=4,
    128 x 128, N=2048).
    """
    xyz = xyz.to(torch.float32)
    b, n, _ = xyz.shape
    dev = xyz.device
    if colors is None:
        colors = xyz.new_ones((b, n, 1))
    uv, depth = camera.project(xyz)  # [B,N,2], [B,N]
    if normals is not None:
        # a half-pixel least footprint keeps tiny or edge-on splats visible
        min_fp = (0.5 * 2.0 / image_size) ** 2
        ia, ib, ic, n_camz = _ewa_inverse_cov(xyz, normals, camera,
                                              splat_radius, min_fp)
    else:
        inv = 1.0 / splat_radius**2
        ia = ic = xyz.new_full((b, n), inv)
        ib = xyz.new_zeros((b, n))
        n_camz = xyz.new_ones((b, n))
    face = (torch.sigmoid(n_camz / 0.1) if backface == "soft"
            else xyz.new_ones((b, n)))

    pix = pixel_grid(image_size, dev)  # [P,2]
    dx = pix[None, :, 0:1] - uv[:, None, :, 0]  # [B,P,N]
    dy = pix[None, :, 1:2] - uv[:, None, :, 1]
    q = (ia[:, None] * dx * dx + 2.0 * ib[:, None] * dx * dy
         + ic[:, None] * dy * dy)
    w = torch.exp(-0.5 * q) * face[:, None]
    if mask is not None:
        w = torch.where(mask[:, None], w, 0.0)
    # soft z-buffer: nearer points dominate where splats overlap; a large
    # finite score, not -inf, where nothing covers a pixel (a softmax of
    # all -inf would be NaN and poison the gradients)
    zscore = -depth[:, None] / depth_temperature
    zsoft = torch.softmax(torch.where(w > 1e-6, zscore, -1e9), dim=2)
    blend = w * zsoft
    denom = torch.clamp_min(blend.sum(dim=2, keepdim=True), 1e-8)
    img = (blend / denom) @ colors.to(torch.float32)  # [B,P,C]
    alpha = 1.0 - torch.prod(1.0 - torch.clamp(w, 0.0, 1.0 - 1e-6), dim=2)
    img = img.reshape(b, image_size, image_size, -1)
    alpha = alpha.reshape(b, image_size, image_size)
    return img * alpha[..., None], alpha
