"""The port's geometry stack against the JAX package: normals, cloud
normalisation, voxel downsampling, the mesh operators, mean value
coordinates, differentiable splatting and the geometry losses.

Inputs come from numpy with a seed; the JAX side is jitted (its kNN and
gathers on the Pallas kernels in interpret mode, ``force_impl("pallas")``),
the port runs its plain PyTorch versions on the CPU.

Tolerances (float32; the two packages reduce in different orders):
  * voxel masks and dihedral face pairs exactly, the pixel grid within
    two ulps of 1;
  * normalisation, mesh operators and losses: atol TOL of the values'
    scale (1e-5 where a chain of divisions and norms lies between);
  * MVC weights and deformations: atol MVC_TOL (arcsin and sin of
    clamped ratios, then a division by the row sum);
  * normals: sign-invariant, atol NORMAL_TOL (the closed-form eigenvector
    amplifies an ulp of the covariance by 1 / eigengap);
  * splatting: images and alphas atol TOL, grads within GRAD_TOL of each
    tensor's largest JAX grad;
  * grads of the mesh operators and losses within GRAD_TOL likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu import geo as jgeo
from pytorch_points_tpu import losses as jlosses
from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.ops import normalize_point_batch as j_npb
from pytorch_points_tpu.ops import normalize_to_box as j_ntb
from pytorch_points_tpu.ops import voxel_downsample_mask as j_voxel
from pytorch_points_tpu.ops.normals import batch_normals as j_normals
from pytorch_points_tpu.ops.normals import smallest_eigenvector_sym3x3 as j_eig
from pytorch_points_tpu_torch import geo, losses
from pytorch_points_tpu_torch.geo.splatting import pixel_grid
from pytorch_points_tpu_torch.ops import (
    batch_normals,
    normalize_point_batch,
    normalize_to_box,
    voxel_downsample_mask,
)
from pytorch_points_tpu_torch.ops.normals import smallest_eigenvector_sym3x3
from pytorch_points_tpu_torch.utils.geometry_utils import (
    generate_icosphere,
    mesh_edges,
)
from torch_inputs import valid_mask

TOL = 2e-6
NORMAL_TOL = 1e-4
MVC_TOL = 1e-4
GRAD_TOL = 1e-5


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def _grads_close(got, ref):
    for g, r in zip(got, ref, strict=True):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(r).max(), 1e-12))


@pytest.fixture(scope="module", autouse=True)
def pallas():
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


def _sphere(seed, b, n, noise=0.01):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 3))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return (x * (1 + noise * rng.standard_normal((b, n, 1)))).astype(
        np.float32)


@pytest.fixture(scope="module")
def mesh():
    """A perturbed icosphere batch: (verts [2,42,3], faces, edges)."""
    v, f = generate_icosphere(1)
    rng = np.random.default_rng(50)
    verts = (v[None] * (1 + 0.1 * rng.standard_normal((2, len(v), 1)))
             ).astype(np.float32)
    return verts, f, mesh_edges(f)


# ---------------------------------------------------------------------------
# normals, normalisation, voxels
# ---------------------------------------------------------------------------


def test_smallest_eigenvector_matches_jax():
    rng = np.random.default_rng(51)
    a = rng.standard_normal((64, 3, 3)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1)
    cov[0] = np.eye(3) * 0.5  # isotropic: z
    ref = np.asarray(jax.jit(j_eig)(cov))
    got = smallest_eigenvector_sym3x3(_t(cov)).numpy()
    dist = np.minimum(np.abs(got - ref), np.abs(got + ref)).max(-1)
    assert dist.max() <= NORMAL_TOL
    np.testing.assert_array_equal(got[0], [0, 0, 1])


@pytest.mark.parametrize("masked,orient", [(False, False), (True, True)])
def test_batch_normals_match_jax(masked, orient):
    xyz = _sphere(52, 2, 256)
    mask = valid_mask(np.random.default_rng(53), 2, 256) if masked else None
    ref = np.asarray(jax.jit(lambda x, m: j_normals(
        x, 12, m, orient_outward=orient))(xyz, mask))
    got = batch_normals(_t(xyz), 12, _t(mask), orient_outward=orient)
    got = got.numpy()
    if orient:
        np.testing.assert_allclose(got, ref, rtol=0, atol=NORMAL_TOL)
    else:
        dist = np.minimum(np.abs(got - ref), np.abs(got + ref)).max(-1)
        assert dist.max() <= NORMAL_TOL
    if masked:
        assert (got[~mask] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_normalize_match_jax(masked):
    rng = np.random.default_rng(54)
    xyz = (rng.standard_normal((3, 100, 3)) * 2 + 1).astype(np.float32)
    mask = valid_mask(rng, 3, 100) if masked else None
    for jfn, fn in ((j_npb, normalize_point_batch),
                    (j_ntb, normalize_to_box)):
        ref = jax.jit(jfn)(xyz, mask)
        got = fn(_t(xyz), _t(mask))
        for g, r in zip(got, ref, strict=True):
            _close(g, r)


@pytest.mark.parametrize("masked", [False, True])
def test_voxel_downsample_mask_matches_jax(masked):
    rng = np.random.default_rng(55)
    xyz = rng.uniform(-1, 1, (2, 500, 3)).astype(np.float32)
    xyz[:, 250:] = xyz[:, :250]  # exact duplicates: lowest index wins
    mask = valid_mask(rng, 2, 500) if masked else None
    for cell in (0.25, 1e-4):  # 1e-4: past 1024 cells, clamped
        ref = np.asarray(jax.jit(lambda x, m, c=cell: j_voxel(x, c, m))(
            xyz, mask))
        got = voxel_downsample_mask(_t(xyz), cell, _t(mask))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# mesh operators
# ---------------------------------------------------------------------------


MESH_OPS = {
    "face_normals": lambda g, v, f, e: g.face_normals(v, f),
    "face_normals_raw": lambda g, v, f, e: g.face_normals(v, f,
                                                          normalize=False),
    "face_areas": lambda g, v, f, e: g.face_areas(v, f),
    "vertex_normals": lambda g, v, f, e: g.vertex_normals(v, f),
    "edge_lengths": lambda g, v, f, e: g.edge_lengths(v, e),
    "uniform_laplacian": lambda g, v, f, e: g.uniform_laplacian(v, e),
    "uniform_laplacian_raw": lambda g, v, f, e: g.uniform_laplacian(
        v, e, normalize=False),
    "cot_laplacian": lambda g, v, f, e: g.cot_laplacian(v, f),
    "cot_laplacian_area": lambda g, v, f, e: g.cot_laplacian(
        v, f, normalize="area"),
    "cot_laplacian_none": lambda g, v, f, e: g.cot_laplacian(
        v, f, normalize="none"),
    "mean_curvature": lambda g, v, f, e: g.mean_curvature(v, f),
    "dihedral_angles": lambda g, v, f, e: g.dihedral_angles(v, f)[0],
}


@pytest.fixture(scope="module")
def mesh_refs(mesh):
    """Every JAX mesh operator's value, and the grad of a fixed random
    projection of it with respect to the vertices, in one jitted call."""
    verts, f, e = mesh
    shapes = {name: jax.eval_shape(lambda v, op=op: op(jgeo, v, f, e),
                                   verts).shape
              for name, op in MESH_OPS.items()}
    rng = np.random.default_rng(56)
    w = {name: rng.standard_normal(shapes[name]).astype(np.float32)
         for name in sorted(MESH_OPS)}

    def all_ops(v):
        out = {}
        for name, op in MESH_OPS.items():
            def projected(x, op=op, name=name):
                y = op(jgeo, x, f, e)
                return jnp.sum(y * w[name]), y
            (_, y), g = jax.value_and_grad(projected, has_aux=True)(v)
            out[name] = (y, g)
        return out

    return w, jax.jit(all_ops)(jnp.asarray(verts))


@pytest.mark.parametrize("name", sorted(MESH_OPS))
def test_mesh_op_matches_jax(mesh, mesh_refs, name):
    """Value on a batch of perturbed icospheres, and the grad of a fixed
    random projection of it with respect to the vertices."""
    verts, f, e = mesh
    w, refs = mesh_refs
    ref, rgrad = refs[name]
    v = _t(verts).requires_grad_(True)
    got = MESH_OPS[name](geo, v, f, e)
    _close(got, ref, 1e-5)
    (got * _t(w[name])).sum().backward()
    _grads_close([v.grad], [rgrad])


def test_mesh_ops_unbatched_and_pairs(mesh):
    verts, f, _ = mesh
    got = geo.face_areas(_t(verts[0]), f)
    assert got.shape == (len(f),)
    _, pairs = geo.dihedral_angles(_t(verts), f)
    _, rpairs = jgeo.dihedral_angles(jnp.asarray(verts), f)
    np.testing.assert_array_equal(pairs, rpairs)
    assert geo.mesh_edges is mesh_edges
    np.testing.assert_array_equal(mesh_edges(f), jgeo.mesh_edges(f))


@pytest.mark.parametrize("masked", [False, True])
def test_point_laplacian_matches_jax(masked):
    xyz = _sphere(57, 2, 200)
    mask = valid_mask(np.random.default_rng(58), 2, 200) if masked else None
    lap, idx = jax.jit(lambda x, m: jgeo.point_laplacian(x, 8, mask=m))(
        xyz, mask)
    got, gidx = geo.point_laplacian(_t(xyz), 8, mask=_t(mask))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(idx))
    _close(got, lap)
    again, _ = geo.point_laplacian(_t(xyz) * 2, idx=gidx)
    _close(again, jgeo.point_laplacian(jnp.asarray(xyz) * 2, idx=idx)[0])


# ---------------------------------------------------------------------------
# cages
# ---------------------------------------------------------------------------


def test_mean_value_coordinates_match_jax():
    cv, cf = generate_icosphere(1, radius=1.5)
    rng = np.random.default_rng(59)
    pts = rng.standard_normal((2, 60, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts *= rng.uniform(0.1, 2.0, (2, 60, 1)).astype(np.float32)  # in, out
    pts[0, 0] = cv[cf[0]].mean(0)  # on a face: barycentric
    ref = jax.jit(jax.vmap(lambda p: jgeo.mean_value_coordinates(
        p, cv, cf)))(pts)
    got = geo.mean_value_coordinates(_t(pts), cv, cf)
    assert got.shape == (2, 60, len(cv))
    _close(got, ref, MVC_TOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    cage = (cv * 1.2 + 0.1).astype(np.float32)
    _close(geo.deform_with_cage(got, _t(cage)),
           jgeo.deform_with_cage(ref, cage), MVC_TOL)
    # one cage a cloud
    cages = np.stack([cage, cage[::-1].copy()])
    _close(geo.deform_with_cage(got, _t(cages)),
           jnp.einsum("bpv,bvc->bpc", ref, cages,
                      precision=jax.lax.Precision.HIGHEST), MVC_TOL)


# ---------------------------------------------------------------------------
# splatting
# ---------------------------------------------------------------------------


def test_pixel_grid_is_jax_linspace():
    """Within two float32 ulps of 1 (XLA's CPU fusion rounds some middle
    pixels differently from the formula it traces)."""
    for n in (1, 7, 16, 128):
        px = np.asarray(jnp.linspace(-1.0, 1.0, n))
        grid = pixel_grid(n).numpy().reshape(n, n, 2)
        np.testing.assert_allclose(grid[0, :, 0], px, rtol=0, atol=2.0**-22)
        np.testing.assert_allclose(grid[:, 0, 1], -px, rtol=0,
                                   atol=2.0**-22)
        assert grid[0, 0, 0] == -1 and grid[0, -1, 0] == (1 if n > 1 else -1)


RENDER_CASES = {
    "isotropic": dict(normals=False, focal=None, backface="none",
                      masked=False),
    "ewa_ortho_masked": dict(normals=True, focal=None, backface="none",
                             masked=True),
    "ewa_perspective_soft": dict(normals=True, focal=1.8, backface="soft",
                                 masked=False),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_points_matches_jax(case):
    """Image and alpha, and the grads of a fixed projection of both with
    respect to the points, colours and normals."""
    cfg = RENDER_CASES[case]
    rng = np.random.default_rng(60)
    xyz = _sphere(61, 2, 48) * 0.6
    colors = rng.uniform(0, 1, (2, 48, 3)).astype(np.float32)
    nrm = (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
           + 0.1 * rng.standard_normal(xyz.shape)).astype(np.float32)
    mask = valid_mask(rng, 2, 48) if cfg["masked"] else None
    w_img = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    w_a = rng.standard_normal((2, 16, 16)).astype(np.float32)
    kw = dict(image_size=16, splat_radius=0.08, depth_temperature=0.05,
              backface=cfg["backface"])

    def jloss(x, c, n):
        img, alpha = jgeo.render_points(
            x, c, normals=n if cfg["normals"] else None,
            camera=jgeo.Camera(eye=(1.5, 1.0, 2.5), focal=cfg["focal"]),
            mask=mask, **kw)
        return jnp.sum(img * w_img) + jnp.sum(alpha * w_a), (img, alpha)

    (_, (rimg, ralpha)), rgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(xyz, colors, nrm)
    x, c, n = (_t(a).requires_grad_(True) for a in (xyz, colors, nrm))
    img, alpha = geo.render_points(
        x, c, normals=n if cfg["normals"] else None,
        camera=geo.Camera(eye=(1.5, 1.0, 2.5), focal=cfg["focal"]),
        mask=_t(mask), **kw)
    _close(img, rimg, 1e-5)
    _close(alpha, ralpha, 1e-5)
    assert alpha.max() > 0.5  # the cloud is in view
    ((img * _t(w_img)).sum() + (alpha * _t(w_a)).sum()).backward()
    grads = [x.grad, c.grad] + ([n.grad] if cfg["normals"] else [])
    _grads_close(grads, rgrads[:len(grads)])
    if not cfg["normals"]:
        assert n.grad is None


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_inputs():
    rng = np.random.default_rng(62)
    gt = _sphere(63, 2, 128)
    pred = (gt + 0.05 * rng.standard_normal(gt.shape)).astype(np.float32)
    nrm = rng.standard_normal(gt.shape).astype(np.float32)
    nrm2 = rng.standard_normal(gt.shape).astype(np.float32)
    v, f = generate_icosphere(1)
    verts = (v[None] * (1 + 0.1 * rng.standard_normal((2, len(v), 1)))
             ).astype(np.float32)
    ref_v = np.repeat(v[None], 2, 0).astype(np.float32)
    mask = valid_mask(rng, 2, 128)
    return dict(gt=gt, pred=pred, nrm=nrm, nrm2=nrm2, verts=verts,
                ref_v=ref_v, f=f, e=mesh_edges(f), mask=mask)


# name -> the loss in terms of a losses module, the differentiated input p
# (the mesh losses' vertices, NormalLoss's predicted normals, else the
# predicted cloud) and the other inputs
LOSSES = {
    "smape": lambda L, p, d: L.SmapeLoss()(p, d["gt"]),
    "point_laplacian_l2": lambda L, p, d: L.PointLaplacianLoss()(d["gt"], p),
    "point_laplacian_l1_norm_masked": lambda L, p, d: L.PointLaplacianLoss(
        metric="l1", use_norm=True)(d["gt"], p, d["mask"]),
    "mesh_laplacian_uniform": lambda L, p, d: L.MeshLaplacianLoss()(
        p, d["e"], d["ref_v"]),
    "mesh_laplacian_cot_magnitude": lambda L, p, d: L.MeshLaplacianLoss(
        uniform=False, compare=False)(p, d["f"]),
    "normal": lambda L, p, d: L.NormalLoss()(d["pred"], p, d["gt"],
                                             d["nrm2"]),
    "point_edge_length": lambda L, p, d: L.PointEdgeLengthLoss()(d["gt"], p),
    "point_edge_length_l1": lambda L, p, d: L.PointEdgeLengthLoss(
        metric="l1")(d["gt"], p),
    "mesh_edge_length": lambda L, p, d: L.MeshEdgeLengthLoss()(
        p, d["e"], d["ref_v"]),
    "mesh_edge_length_mean": lambda L, p, d: L.MeshEdgeLengthLoss()(
        p, d["e"]),
}
MESH_LOSSES = {"mesh_laplacian_uniform", "mesh_laplacian_cot_magnitude",
               "mesh_edge_length", "mesh_edge_length_mean"}


def _pred_of(name, d):
    return (d["verts"] if name in MESH_LOSSES
            else d["nrm"] if name == "normal" else d["pred"])


@pytest.fixture(scope="module")
def loss_refs():
    """Every JAX loss's value and grad, in one jitted call."""
    d = _loss_inputs()
    jd = {k: (jnp.asarray(v) if k not in ("f", "e") else v)
          for k, v in d.items()}

    def all_losses(preds):
        return {name: jax.value_and_grad(
            lambda p, fn=fn: fn(jlosses, p, jd))(preds[name])
            for name, fn in LOSSES.items()}

    return d, jax.jit(all_losses)({name: jnp.asarray(_pred_of(name, d))
                                   for name in LOSSES})


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(loss_refs, name):
    d, refs = loss_refs
    rv, rg = refs[name]
    td = {k: (_t(v) if k not in ("f", "e") else v) for k, v in d.items()}
    p = _t(_pred_of(name, d)).requires_grad_(True)
    value = LOSSES[name](losses, p, td)
    value.backward()
    np.testing.assert_allclose(value.item(), float(rv), rtol=1e-5)
    _grads_close([p.grad], [rg])
