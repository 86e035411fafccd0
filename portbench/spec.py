"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells. Everything
that belongs to one configuration, traffic mix, metric, layer pattern or
work count lives in a file of its own under this folder, named after it:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix's parameters;
* ``limits/<cell>.json``: the limits of the cell's correctness numbers
  (a cell is named ``<config>.<traffic>``);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``;
* ``patterns/<layer>.txt``: regular expressions, one a line, naming the
  device items of a layer;
* ``work/<name>.py``: a work count, ``count(ctx)``;
* ``reference/<name>.py``: a configuration's plain reference.

A later cell, metric or configuration is new files; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(ctx) -> float | None`` of per-layer metric ``name``."""
    return _module("metrics", name).read


def work(name: str):
    """``count(ctx) -> (flops, bytes)`` of work count ``name``."""
    return _module("work", name).count


def patterns(layer: str) -> re.Pattern:
    """One regular expression for the device items of ``layer``."""
    lines = (HERE / "patterns" / f"{layer}.txt").read_text().splitlines()
    pats = [ln.strip() for ln in lines
            if ln.strip() and not ln.lstrip().startswith("#")]
    return re.compile("|".join(f"(?:{p})" for p in pats))


def reference(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def peaks() -> dict:
    with open(HERE / "peaks.json") as f:
        return json.load(f)


class Cell:
    """One ``workloads`` entry with its configuration, traffic and limits
    loaded, and the metrics it reports. ``entry`` gives the cell's
    ``config`` and ``traffic`` for a cell that ``BENCHMARK.json`` does not
    list (a prepared cell, in the tests)."""

    def __init__(self, name: str, entry: dict | None = None):
        bench = benchmark()
        if entry is None:
            entries = {w["name"]: w for w in bench["workloads"]}
            if name not in entries:
                raise KeyError(f"no workload {name!r} in BENCHMARK.json")
            entry = entries[name]
        self.name = name
        self.chips = int(entry.get("chips", 1))
        self.config_name = entry["config"]
        self.traffic_name = entry["traffic"]
        self.config = config(entry["config"])
        self.traffic = traffic(entry["traffic"])
        self.limits = limits(name)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]
