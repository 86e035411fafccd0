"""Tiny CPU versions of the cells, for the tests: every width as
configured, the clouds and sampling sizes cut down."""

from __future__ import annotations

import copy

from portbench import spec


# a serving cell prepared under portbench/ but not in BENCHMARK.json (its
# p95 did not hold steady on the card; PERF.md)
PREPARED = {"pu_3pu.serve.b32n2048x4": {"config": "pu_3pu",
                                        "traffic": "serve.b32n2048x4"}}


def tiny_cell(name: str, **traffic):
    """``spec.Cell(name)`` with its sizes cut for a CPU run."""
    cell = spec.Cell(name, PREPARED.get(name))
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if cfg["model"] == "PointCloudAutoencoder":
        cfg["kwargs"].update(npoint1=32, npoint2=8)
        cfg["sa"][0].update(npoint=32)
        cfg["sa"][1].update(npoint=8)
        tr.update(batch=2, points=128)
    else:
        tr.update(batch=2, points=64)
        if "target_points" in tr:
            tr["target_points"] = 256
    tr.update(pool=4, warmup=1, steps_traced=2)
    if tr["kind"] == "serve":
        tr.update(rate_per_s=40, sample=4)
    tr.update(traffic)
    cell.config, cell.traffic = cfg, tr
    return cell
