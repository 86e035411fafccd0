"""Nothing that a run loads is JAX or the JAX package; the reference loads
nothing of the port."""

import subprocess
import sys

from portbench import guard
from portbench.tests.conftest import ROOT


def test_top_level_names_compared_whole():
    mods = {"pytorch_points_tpu_torch": 1, "pytorch_points_tpu_torch.ops": 1,
            "jaxtyping": 1, "benchmark_x": 1, "torch": 1}
    assert guard.forbidden_loaded(mods) == []
    assert guard.forbidden_loaded({**mods, "pytorch_points_tpu.ops": 1,
                                   "jax.numpy": 1}) == [
        "jax", "pytorch_points_tpu"]
    assert guard.forbidden_loaded({"flax": 1, "jaxlib.xla": 1,
                                   "bench.probe": 1}) == [
        "bench", "flax", "jaxlib"]


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_whole_run_loads_nothing_forbidden():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import guard, harness\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "for n in ('pn2_ae.train_cd.b32n16384', 'pu_3pu.serve.b32n2048x4'):\n"
        "    out = harness.run_cell(tiny_cell(n), 3, 0.2, False, 'cpu')\n"
        "    assert out['correct'], out\n"
        "print(guard.forbidden_loaded())\n")
    assert _run(code) == "[]"


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.reference.ops, portbench.reference.emd\n"
        "import portbench.reference.pn2_ae, portbench.reference.pu_3pu\n"
        "import portbench.reference.train\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'pytorch_points_tpu_torch',\n"
        "                    'pytorch_points_tpu', 'jax'}))\n")
    assert _run(code) == "[]"


def test_run_without_a_card_prints_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "pn2_ae.train_cd_emd.b32n2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
