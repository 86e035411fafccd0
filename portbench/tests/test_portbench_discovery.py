"""A configuration, a traffic mix, a metric and a layer pattern are found
by name: adding a cell is adding files."""

import json
import shutil

from portbench import harness, spec
from portbench.tests.tiny import tiny_cell


def test_new_files_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    here = root / "portbench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.benchmark()
    base = tiny_cell("pu_3pu.serve.b32n2048x4")  # prepared, not listed
    # a new configuration, traffic mix, metric, layer pattern and limits
    cfg = dict(base.config, k=8, kwargs=dict(base.config["kwargs"], k=8))
    (here / "configs" / "pu_k8.json").write_text(json.dumps(cfg))
    (here / "traffic" / "serve.tiny.json").write_text(
        json.dumps(base.traffic))
    (here / "limits" / "pu_k8.serve.tiny.json").write_text(
        json.dumps({"out_gap": 1e-4}))
    (here / "patterns" / "cat.txt").write_text("# concatenations\nCatArray\n")
    (here / "metrics" / "requests.seen.py").write_text(
        "def read(ctx):\n    return float(ctx.driver.requests)\n")
    bench["configs"].append({"name": "pu_k8", "source": "x",
                             "file": "portbench/configs/pu_k8.json",
                             "reduced": [], "why": "x"})
    bench["workloads"] = [{"name": "pu_k8.serve.tiny", "config": "pu_k8",
                           "traffic": "serve.tiny", "chips": 1, "why": "x"}]
    bench["end_to_end"] = [
        {"name": "serve_ms_p95", "unit": "ms", "better": "lower",
         "bound": 0.1, "source": "host_clock",
         "workloads": ["pu_k8.serve.tiny"]},
        *(m for m in bench["end_to_end"] if "workloads" not in m)]
    bench["per_layer"] = [{"name": "requests.seen", "unit": "requests",
                           "better": "higher", "source": "host_clock",
                           "layer": "x", "moves": "serve_ms_p95",
                           "workloads": ["pu_k8.serve.tiny"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ROOT", root)

    cell = spec.Cell("pu_k8.serve.tiny")
    assert cell.config["k"] == 8 and cell.traffic == base.traffic
    assert [m["name"] for m in cell.end_to_end] == ["serve_ms_p95",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["requests.seen"]
    assert spec.patterns("cat").search("CatArrayBatchedCopy")
    out = harness.run_cell(cell, 5, 0.2, trace=False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"serve_ms_p95", "setup_s"}
    assert spec.metric_reader("requests.seen")(
        harness.Context(cell, type("D", (), {"requests": 3})(), None,
                        spec.peaks(), "cpu")) == 3.0
