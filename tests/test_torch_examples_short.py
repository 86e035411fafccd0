"""The port's ``examples_torch/`` ``train_autoencoder``,
``export_and_serve``, ``upsample_cloud``, ``render_cloud`` and
``deform_with_cage`` against the JAX package's scripts of the same names
(``examples/``), each run through its ``main()`` on the CPU at a tiny
size.

Each script is loaded from its file under a name of its own
(``examples_parity.load``); the JAX example's model constructor records
the model it builds (under ``nnx.jit``) and the port example's loads its
initial parameters (``load_jax_params``). The JAX ``train_autoencoder``
sees one device (``jax.devices`` patched), as the port's world of one;
the JAX upsampler's forward is jitted (eager JAX compiles every op alone).
Both sides take their "auto" routes and no run has an EMD term. Losses are
read unrounded where the scripts compute them or pass them to
``device_sync`` (``jax.debug.callback`` inside the JAX jit).

Tolerances: ``train_autoencoder``'s losses rtol 1e-4;
``export_and_serve``'s last chamfer rtol 1e-4 and the port script's own
served-against-live check below 1e-5; the upsampled cloud atol 1e-5; the
render's uint8 pixels within 1 (both scripts write their raw PPM, as on a
machine without matplotlib); the cage fit's step-0 chamfer rtol 1e-6,
both fits ending below 1e-3 (the JAX fit runs its 200 steps in about 5 s
with the port's).
"""

import os
import re
import sys

import numpy as np
import pytest

from examples_parity import (
    NAMES,
    Carried,
    load,
    one_device,
    recorder,
    run_main,
)
from pytorch_points_tpu.utils import pc_utils as jax_pc_utils

AE_ARGS = ["--n", "64", "--batch", "2", "--steps", "3", "--emd-weight", "0"]
SERVE_ARGS = ["--n", "128", "--batch", "2", "--steps", "2"]
RENDER_SIZE = 64


# ---------------------------------------------------------------------------
# train_autoencoder, export_and_serve
# ---------------------------------------------------------------------------


def test_train_autoencoder_example_matches(tmp_path):
    jex, pex = load("examples", NAMES[1]), load("examples_torch", NAMES[1])
    carried, want, got = Carried(), [], []
    with pytest.MonkeyPatch.context() as mp:
        one_device(mp)
        mp.setattr(jex, "PointCloudAutoencoder",
                   carried.jax_ctor(jex.PointCloudAutoencoder))
        mp.setattr(jex, "device_sync", lambda x: want.append(float(x)))
        run_main(mp, jex, [*AE_ARGS, "--ckpt", str(tmp_path / "jax")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pex, "PointCloudAutoencoder",
                   carried.port_ctor(pex.PointCloudAutoencoder))
        mp.setattr(pex, "device_sync", lambda x: got.append(float(x)))
        run_main(mp, pex, [*AE_ARGS, "--ckpt", str(tmp_path / "port"),
                           "--device", "cpu"])
    assert len(got) == len(want) == 2  # steps 0 and 2 print
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert os.listdir(tmp_path / "port") == ["3"]


def test_export_and_serve_example_matches(capsys):
    jex, pex = load("examples", NAMES[2]), load("examples_torch", NAMES[2])
    carried, want, got = Carried(), [], []

    def recorded(fn, record):
        return lambda *args, **kwargs: record(fn(*args, **kwargs))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jex, "PointCloudAutoencoder",
                   carried.jax_ctor(jex.PointCloudAutoencoder))
        mp.setattr(jex, "chamfer_distance",
                   recorded(jex.chamfer_distance, recorder(want, True)))
        run_main(mp, jex, SERVE_ARGS)
    assert "SERVE OK" in capsys.readouterr().out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pex, "PointCloudAutoencoder",
                   carried.port_ctor(pex.PointCloudAutoencoder))
        mp.setattr(pex, "chamfer_distance",
                   recorded(pex.chamfer_distance, recorder(got, False)))
        run_main(mp, pex, [*SERVE_ARGS, "--device", "cpu"])
    printed = capsys.readouterr().out
    # the script's own check, served against live below 1e-5, passed
    assert "SERVE OK" in printed
    err = float(re.search(r"max \|exported - live\| = (\S+)", printed)[1])
    assert err < 1e-5
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-4)


# ---------------------------------------------------------------------------
# upsample_cloud, render_cloud, deform_with_cage
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_ply(tmp_path_factory):
    path = tmp_path_factory.mktemp("cloud") / "in.ply"
    jax_pc_utils.save_ply(np.random.default_rng(0).standard_normal(
        (64, 3)).astype(np.float32), str(path))
    return path


def test_upsample_cloud_example_matches(small_ply, tmp_path):
    jex, pex = load("examples", NAMES[3]), load("examples_torch", NAMES[3])
    carried = Carried()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jex, "PointUpsampler",
                   carried.jax_ctor(jex.PointUpsampler, jit_call=True))
        run_main(mp, jex, [str(small_ply), str(tmp_path / "jax.ply")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pex, "PointUpsampler",
                   carried.port_ctor(pex.PointUpsampler))
        run_main(mp, pex, [str(small_ply), str(tmp_path / "port.ply"),
                           "--device", "cpu"])
    want = jax_pc_utils.read_ply(str(tmp_path / "jax.ply"))
    got = jax_pc_utils.read_ply(str(tmp_path / "port.ply"))
    assert got.shape == want.shape == (256, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def read_ppm(path):
    raw = path.read_bytes()
    header = f"P6 {RENDER_SIZE} {RENDER_SIZE} 255\n".encode()
    assert raw.startswith(header)
    return np.frombuffer(raw[len(header):], np.uint8).reshape(
        RENDER_SIZE, RENDER_SIZE, 3)


def test_render_cloud_example_matches(small_ply, tmp_path):
    jex, pex = load("examples", NAMES[4]), load("examples_torch", NAMES[4])
    with pytest.MonkeyPatch.context() as mp:
        # both write their raw PPM: the card's machine has no matplotlib
        mp.setitem(sys.modules, "matplotlib", None)
        run_main(mp, jex, [str(small_ply), str(tmp_path / "jax.png"),
                           str(RENDER_SIZE)])
        run_main(mp, pex, [str(small_ply), str(tmp_path / "port.png"),
                           str(RENDER_SIZE), "--device", "cpu"])
    want = read_ppm(tmp_path / "jax.ppm").astype(np.int16)
    got = read_ppm(tmp_path / "port.ppm").astype(np.int16)
    assert want.max() > 0  # the splats reach the image
    assert np.abs(got - want).max() <= 1


def test_deform_with_cage_example_matches(capsys):
    jex, pex = load("examples", NAMES[5]), load("examples_torch", NAMES[5])
    want, got = [], []

    def recorded(cls, record):
        class Recorded(cls):
            def __call__(self, *args, **kwargs):
                return record(super().__call__(*args, **kwargs))

        return Recorded

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jex, "ChamferLoss",
                   recorded(jex.ChamferLoss, recorder(want, True)))
        run_main(mp, jex, [])
        mp.setattr(pex, "ChamferLoss",
                   recorded(pex.ChamferLoss, recorder(got, False)))
        run_main(mp, pex, ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.count("cage deformation fit ok") == 2
    assert len(re.findall(r"step   0  chamfer \S+", printed)) == 2
    assert len(want) == len(got) == 200
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert want[-1] < 1e-3 and got[-1] < 1e-3
