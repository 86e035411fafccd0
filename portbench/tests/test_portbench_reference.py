"""The frozen reference agrees with the port's CPU path at a tiny size.

The port's plain versions are its own CPU semantics (the CUDA kernels are
held to them on the card); the reference is written apart from them and
must agree: the same neighbourhoods, assignment and outputs."""

import pytest
import torch

from portbench import gen
from portbench.reference import emd, ops, pn2_ae, pu_3pu
from portbench.spec import config

SEED = 4242


@pytest.fixture(scope="module")
def clouds():
    return gen.surface_clouds(2, 256, "cpu", SEED, 0)


def test_autoencoder_forward(clouds):
    from pytorch_points_tpu_torch.models import PointCloudAutoencoder

    cfg = config("pn2_ae")
    cfg["sa"][0]["npoint"], cfg["sa"][1]["npoint"] = 64, 16
    w = gen.weights(pn2_ae.param_spec(cfg), "cpu", SEED)
    model = PointCloudAutoencoder(64, 16, device="cpu")
    model.load_state_dict(w, strict=True)
    with torch.no_grad():
        got = model(clouds)
        want = pn2_ae.forward(w, clouds, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_upsampler_forward():
    from pytorch_points_tpu_torch.models import PointUpsampler

    cfg = config("pu_3pu")
    x = gen.surface_clouds(2, 128, "cpu", SEED, 1)
    w = gen.weights(pu_3pu.param_spec(cfg), "cpu", SEED)
    model = PointUpsampler(**cfg["kwargs"], device="cpu")
    model.load_state_dict(w, strict=True)
    with torch.no_grad():
        got = model(x)
        want = pu_3pu.forward(w, x, cfg)
    assert got.shape == (2, 512, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_neighbourhoods(clouds):
    from pytorch_points_tpu_torch.ops import (
        ball_query,
        furthest_point_sample,
        knn,
    )

    idx = furthest_point_sample(clouds, 32)
    assert torch.equal(idx.long(), ops.fps(clouds, 32))
    cen = ops.gather_rows(clouds, idx.long())
    got, _ = ball_query(clouds, cen, 0.2, 16)
    assert torch.equal(got.long(), ops.ball_query(clouds, cen, 0.2, 16))
    d, i = knn(clouds, clouds, 17)
    dr, ir = ops.knn(clouds, clouds, 17)
    assert torch.equal(i.long(), ir) and torch.equal(d, dr)


def test_emd_assignment_and_chamfer(clouds):
    from pytorch_points_tpu_torch.ops import (
        chamfer_distance,
        earth_mover_distance,
    )

    q = gen.surface_clouds(2, 256, "cpu", SEED, 2)
    _, got = earth_mover_distance(clouds, q)
    assert torch.equal(got.long(), emd.assignment(clouds, q))
    assert sorted(got[0].tolist()) == list(range(256))
    torch.testing.assert_close(chamfer_distance(clouds, q),
                               ops.chamfer(clouds, q), rtol=1e-6, atol=0)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, 3.0])
    want = torch.tensor([1.0, 1.0, 1.0 + 2**-9, 3.0])
    assert torch.equal(ops.round_tf32(x), want)
