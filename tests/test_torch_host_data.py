"""The port's host side against the JAX package: masking helpers, the
native library and its numpy fallbacks, point-cloud and mesh I/O, the PLY
dataset, the bucketed batcher and the prefetcher, and config 10's dataset
(``chip_smoke.make_dataset`` against ``examples/train_on_ply_dataset.py``).

Inputs come from numpy with a seed. Everything here is host-side numpy (or
torch on the CPU) on both sides, so every comparison is exact: arrays and
files byte for byte, buckets and orders equal.
"""

import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_points_tpu.core import masking as jax_masking
from pytorch_points_tpu.data import BucketedBatcher as JaxBatcher
from pytorch_points_tpu.data import PlyFolderDataset as JaxDataset
from pytorch_points_tpu.utils import geometry_utils as jax_geo
from pytorch_points_tpu.utils import pc_utils as jax_pc
from pytorch_points_tpu_torch import _native
from pytorch_points_tpu_torch.core import masking
from pytorch_points_tpu_torch.data import (
    BucketedBatcher,
    PlyFolderDataset,
    Prefetcher,
    random_clouds,
)
from pytorch_points_tpu_torch.misc import get_logger
from pytorch_points_tpu_torch.utils import geometry_utils, pc_utils
from torch_inputs import write_ply_clouds

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ply_root(tmp_path_factory):
    return write_ply_clouds(tmp_path_factory.mktemp("ply"), count=12, lo=60,
                            hi=300, seed=9)


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def reader(request, monkeypatch):
    """The port's PLY reader with the native library, then without it."""
    if request.param:
        assert _native.available()
    else:
        monkeypatch.setattr(_native, "_LIB", False)
        assert not _native.available()
    return request.param


# ---------------------------------------------------------------------------
# core/masking
# ---------------------------------------------------------------------------

MASKING_CASES = {
    "bucket_few": ("bucket_sizes", ([100, 250, 900, 129],
                                    dict(multiple=128, max_buckets=4))),
    "bucket_spread": ("bucket_sizes", (list(range(50, 3000, 37)),
                                       dict(multiple=64, max_buckets=5))),
    "bucket_default": ("bucket_sizes", ([1, 256, 257, 5000], {})),
    "bucket_empty": ("bucket_sizes", ([], {})),
    "pad_first": ("pad_to_bucket", (37, [64, 128])),
    "pad_exact": ("pad_to_bucket", (128, [128, 64])),
    "pad_last": ("pad_to_bucket", (100, [64, 128])),
    "mask_lengths": ("mask_from_lengths", ([3, 0, 8, 5], 8)),
}


@pytest.mark.parametrize("case", sorted(MASKING_CASES))
def test_masking_helpers_match_jax(case):
    name, (a, b) = MASKING_CASES[case]
    if name == "bucket_sizes":
        got = masking.bucket_sizes(a, **b)
        assert got == jax_masking.bucket_sizes(a, **b)
        assert all(isinstance(x, int) for x in got)
    elif name == "pad_to_bucket":
        xyz = np.random.default_rng(a).standard_normal((a, 3)).astype(
            np.float32)
        want = jax_masking.pad_to_bucket(xyz, b)
        got = masking.pad_to_bucket(torch.from_numpy(xyz), b)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        want = np.asarray(jax_masking.mask_from_lengths(np.array(a), b))
        np.testing.assert_array_equal(
            masking.mask_from_lengths(a, b).numpy(), want)
        assert masking.mask_from_lengths is masking.lengths_to_mask


def test_pad_to_bucket_raises_past_the_largest():
    with pytest.raises(ValueError, match="no bucket"):
        masking.pad_to_bucket(torch.zeros(200, 3), [64, 128])


# ---------------------------------------------------------------------------
# _native, utils/pc_utils, utils/geometry_utils
# ---------------------------------------------------------------------------


def test_native_library_matches_numpy_fallbacks(ply_root, monkeypatch):
    assert _native.available()
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    path = os.path.join(ply_root, "cloud_000.ply")
    native = (pc_utils.read_ply(path), pc_utils.furthest_point_sample_np(
        xyz, 64), _native.grid_subsample(xyz, 0.5))
    assert native[2].shape[1] == 3 and 1 <= len(native[2]) <= 64
    monkeypatch.setattr(_native, "_LIB", False)
    assert _native.grid_subsample(xyz, 0.5) is None
    fallback = (pc_utils.read_ply(path),
                pc_utils.furthest_point_sample_np(xyz, 64))
    for a, b in zip(native, fallback):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        fallback[1], jax_pc.furthest_point_sample_np(xyz, 64))


@pytest.mark.parametrize("binary", [True, False])
def test_ply_io_matches_jax(tmp_path, binary):
    rng = np.random.default_rng(2)
    xyz = rng.standard_normal((40, 3)).astype(np.float32)
    nrm = rng.standard_normal((40, 3)).astype(np.float32)
    rgb = rng.uniform(size=(40, 3))
    for mod, name in ((pc_utils, "port.ply"), (jax_pc, "jax.ply")):
        mod.save_ply(xyz, tmp_path / name, normals=nrm, colors=rgb,
                     binary=binary)
    assert (tmp_path / "port.ply").read_bytes() == (
        tmp_path / "jax.ply").read_bytes()
    got = pc_utils.read_ply(tmp_path / "port.ply", load_normals=True,
                            load_colors=True)
    want = jax_pc.read_ply(tmp_path / "port.ply", load_normals=True,
                           load_colors=True)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    pc_utils.save_ply_property(xyz, xyz[:, 0], tmp_path / "p.ply")
    jax_pc.save_ply_property(xyz, xyz[:, 0], tmp_path / "j.ply")
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply"
                                                 ).read_bytes()


def test_pc_preprocessing_matches_jax():
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-2, 3, (300, 3)).astype(np.float32)
    nrm = rng.standard_normal((300, 3)).astype(np.float32)
    pairs = [
        (pc_utils.normalize_point_cloud(xyz),
         jax_pc.normalize_point_cloud(xyz)),
        (pc_utils.downsample_points(xyz, 50, seed=4),
         jax_pc.downsample_points(xyz, 50, seed=4)),
        (pc_utils.jitter_perturbation_point_cloud(xyz, seed=5),
         jax_pc.jitter_perturbation_point_cloud(xyz, seed=5)),
    ] + [(pc_utils.rotate_point_cloud(xyz, nrm, seed=6, axis=a),
          jax_pc.rotate_point_cloud(xyz, nrm, seed=6, axis=a))
         for a in "xyz"]
    for got, want in pairs:
        if isinstance(got, np.ndarray):
            got, want = (got,), (want,)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ext", [".obj", ".off", ".ply"])
def test_mesh_io_and_templates_match_jax(tmp_path, ext):
    verts, faces = geometry_utils.generate_icosphere(2)
    jv, jf = jax_geo.generate_icosphere(2)
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(faces, jf)
    gv, gf = geometry_utils.generate_grid_mesh(7, 5, 0.5)
    for g, w in zip((gv, gf), jax_geo.generate_grid_mesh(7, 5, 0.5)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(geometry_utils.mesh_edges(faces),
                                  jax_geo.mesh_edges(faces))
    np.testing.assert_array_equal(geometry_utils.get_edge_points(gv, gf),
                                  jax_geo.get_edge_points(gv, gf))
    geometry_utils.write_mesh(tmp_path / f"p{ext}", verts, faces)
    jax_geo.write_mesh(tmp_path / f"j{ext}", verts, faces)
    assert (tmp_path / f"p{ext}").read_bytes() == (
        tmp_path / f"j{ext}").read_bytes()
    for g, w in zip(geometry_utils.read_mesh(tmp_path / f"p{ext}"),
                    jax_geo.read_mesh(tmp_path / f"p{ext}"), strict=True):
        np.testing.assert_array_equal(g, w)


def test_logger_default_name():
    log = get_logger()
    assert log.name == "pytorch_points_tpu_torch"
    assert get_logger() is log and len(log.handlers) == 1


# ---------------------------------------------------------------------------
# data/loader
# ---------------------------------------------------------------------------


def test_ply_folder_dataset_matches_jax(ply_root, reader):
    ds, want = PlyFolderDataset(ply_root), JaxDataset(ply_root)
    assert ds.files == want.files and len(ds) == 12
    for i in range(len(ds)):
        got = ds[i]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want[i])
    raw = PlyFolderDataset(ply_root, normalize=False,
                           transform=lambda x: x[::2])
    np.testing.assert_array_equal(
        raw[3], JaxDataset(ply_root, normalize=False,
                           transform=lambda x: x[::2])[3])
    with pytest.raises(FileNotFoundError):
        PlyFolderDataset(os.path.join(ply_root, "missing"))


@pytest.mark.parametrize("shuffle,drop", [(True, True), (True, False),
                                          (False, False)])
def test_bucketed_batcher_matches_jax_over_two_epochs(ply_root, shuffle,
                                                      drop):
    kw = dict(multiple=64, max_buckets=3, shuffle=shuffle,
              drop_remainder=drop, seed=7)
    got = BucketedBatcher(PlyFolderDataset(ply_root), 3, **kw)
    want = JaxBatcher(JaxDataset(ply_root), 3, **kw)
    assert got.buckets == want.buckets and len(got.buckets) == 3
    for _ in range(2):  # the seed advances each shuffled epoch
        g, w = list(got), list(want)
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            for key in ("points", "mask"):
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()
    assert got.seed == want.seed == 7 + 2 * shuffle


def test_random_clouds_match_jax():
    from pytorch_points_tpu.data import random_clouds as jax_random_clouds

    for g, w in zip(random_clouds(5, 10, 40, seed=3),
                    jax_random_clouds(5, 10, 40, seed=3), strict=True):
        np.testing.assert_array_equal(g, w)


def test_prefetcher_order_and_reraise():
    batcher = BucketedBatcher(random_clouds(10, lo=100, hi=300, seed=1), 3,
                              multiple=64, shuffle=False)
    direct = list(batcher)
    for depth in (1, 2):
        pre = list(Prefetcher(batcher, depth=depth))
        assert len(pre) == len(direct)
        for a, b in zip(direct, pre):
            np.testing.assert_array_equal(a["points"], b["points"])
            np.testing.assert_array_equal(a["mask"], b["mask"])

    def bad():
        yield {"x": 1}
        raise ValueError("boom")

    seen = []
    with pytest.raises(ValueError, match="boom"):
        for item in Prefetcher(bad(), depth=1):
            seen.append(item)
    assert seen == [{"x": 1}]


def test_prefetcher_abandoned_iteration_releases_producer():
    produced = []

    def many():
        for i in range(1000):
            produced.append(i)
            yield {"i": i}

    before = threading.active_count()
    for batch in Prefetcher(many(), depth=1):
        if batch["i"] >= 2:
            break  # abandon mid-pass with the queue full
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) < 1000


# ---------------------------------------------------------------------------
# config 10's dataset
# ---------------------------------------------------------------------------


def test_chip_smoke_dataset_matches_the_example(tmp_path, monkeypatch):
    """Config 10's PLY files (chip_smoke.py phase 15) come from the port
    example's ``make_dataset``, byte-equal to the JAX example's files;
    chip_smoke keeps no copy of its own."""
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    import train_on_ply_dataset

    port = chip_smoke.load_example("train_on_ply_dataset")
    assert port.__file__ == str(ROOT / "examples_torch" /
                                "train_on_ply_dataset.py")
    assert not hasattr(chip_smoke, "make_dataset")
    port.make_dataset(str(tmp_path / "port"), count=6, seed=3)
    train_on_ply_dataset.make_dataset(str(tmp_path / "jax"), count=6, seed=3)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 6
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes()
    assert "jax" not in sys.modules["chip_smoke"].__dict__
    assert "jax" not in vars(port)


def test_native_entries_refuse_bad_shapes():
    assert _native.available()
    with pytest.raises(ValueError):
        _native.fps(np.zeros((0, 3), np.float32), 4)
    with pytest.raises(ValueError):
        _native.fps(np.zeros((8, 2), np.float32), 4)
    with pytest.raises(ValueError):
        _native.fps(np.zeros((8, 3), np.float32), 0)
    with pytest.raises(ValueError):
        _native.grid_subsample(np.zeros((8, 3), np.float32), 0.0)
