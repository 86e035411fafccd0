"""On the card: one short run of each cell through ``run.py`` reads
correct and prints the contract's result line. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import spec
from portbench.tests.conftest import ROOT

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 11), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    cell = spec.Cell(name)
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
