"""The MSG part-segmentation cell on the CPU: a whole run at a cut size
reads correct when sound and not with a fault or the TF32 control in the
program's place; its Linear and LayerNorm shapes against a count by hand.
The cell is cut here (npoint 32/8, N=128, B=2); every width is the
configuration's."""

import copy

import pytest
import torch

from portbench import calibrate, harness, spec
from portbench.reference import pn2_partseg_msg as ref

CELL = "pn2_partseg_msg.train_ce.b32n2048"
SEED = 2**31 + 5


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread, so that the program and the reference run the same
    float32 operations in one order. With several, the CPU's BLAS may take
    another number of threads from call to call on a loaded machine, and
    the two sides then part by a rounding of the loss, which its limit
    does not admit (on the card both run one order)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cut_cell():
    cell = spec.Cell(CELL)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["kwargs"].update(npoint1=32, npoint2=8)
    cfg["sa"][0]["npoint"], cfg["sa"][1]["npoint"] = 32, 8
    tr.update(batch=2, points=128, pool=4, warmup=1, steps_traced=2)
    cell.config, cell.traffic = cfg, tr
    return cell


def test_sound_run_is_correct():
    out = harness.run_cell(cut_cell(), SEED, 0.3, trace=False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_clouds_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_is_not_correct(fault):
    out = harness.run_cell(cut_cell(), SEED, 0.3, trace=False, device="cpu",
                           fault=fault)
    assert not out["correct"], out["checks"]


def test_control_is_not_correct():
    cell = cut_cell()
    sound, control = calibrate.readings(cell, SEED, "cpu", 0.3,
                                        control=True)
    limits = cell.limits
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert any(control[k] > limits[k] for k in limits), control
    # the loss's limit lies under the control's least reading too
    assert control["loss_step1_gap"] > limits["loss_step1_gap"], control


def test_linear_and_norm_shapes_by_hand():
    cfg = cut_cell().config
    b, n = 2, 128
    rows_widths = [
        (b * 32 * 32, [6, 32, 32, 64]),      # SA1, radius 0.1: 32 of 32
        (b * 32 * 64, [6, 64, 64, 128]),     # radius 0.2: 64 of 32
        (b * 32 * 128, [6, 64, 96, 128]),    # radius 0.4: 128 of 32
        (b * 8 * 64, [323, 128, 128, 256]),  # SA2, radius 0.4: 64 of 8
        (b * 8 * 128, [323, 128, 196, 256]),  # radius 0.8: 128 of 8
        (b * 8, [515, 256, 512, 1024]),      # SA3: all 8 points
        (b * 8, [1536, 256, 256]),           # FP3 onto level 2
        (b * 32, [576, 256, 128]),           # FP2 onto level 1
        (b * n, [150, 128, 128]),            # FP1: 16 + 3 + 3 + 128
        (b * n, [128, 128, 50]),             # fc1, fc2
    ]
    want = [(rows, ci, co) for rows, ws in rows_widths
            for ci, co in zip(ws[:-1], ws[1:])]
    assert ref.linear_shapes(cfg, b, n) == want
    assert ref.norm_shapes(cfg, b, n) == [(r, co) for r, _, co in want[:-1]]
    names = [name for name, _, _ in ref.param_spec(cfg)]
    assert len(names) == 2 * len(want) + 2 * (len(want) - 1)
    assert "sa2.mlps.1.norms.1.weight" in names
    assert "fc2.layers.0.weight" in names and "fc2.norms.0.weight" not in names


def test_norm_bytes_by_hand():
    from types import SimpleNamespace

    cell = cut_cell()
    shapes = ref.norm_shapes(cell.config, 2, 128)
    _, nbytes = spec.work("norm")(SimpleNamespace(cell=cell))
    assert nbytes == sum(rows * (20 * c + 8) for rows, c in shapes)
