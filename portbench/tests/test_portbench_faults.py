"""A whole run on the CPU at a tiny size, with the chip's check skipped:
sound, it reads correct; with the timed path broken underneath, or with
the control (the reference in TF32) in the program's place, it does not."""

import pytest

from portbench import calibrate, harness
from portbench.tests.tiny import tiny_cell

TRAIN = ("pn2_ae.train_cd_emd.b32n2048", "pn2_ae.train_cd.b32n16384",
         "pu_3pu.train_cd.b32n2048x4")
SERVE = ("pu_3pu.serve.b32n2048x4",)
SEED = 2**31 + 5


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_sound_run_is_correct(name):
    out = harness.run_cell(tiny_cell(name), SEED, 0.3, trace=False,
                           device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [
    *((n, f) for n in TRAIN for f in ("state_unchanged", "half_batch")),
    *((n, f) for n in SERVE for f in ("altered_answer", "half_batch"))])
def test_fault_is_not_correct(name, fault):
    out = harness.run_cell(tiny_cell(name), SEED, 0.3, trace=False,
                           device="cpu", fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    sound, control = calibrate.readings(cell, SEED, "cpu", 0.3,
                                        control=True)
    limits = cell.limits
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert any(control[k] > limits[k] for k in limits), control
