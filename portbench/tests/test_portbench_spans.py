"""The readers of the port's spans on the CPU: each returns None without a
card, and one run makes the two stretches of ``spans.py`` once, whatever
the number of readers."""

from portbench import harness, spans, spec
from portbench.tests.tiny import tiny_cell

READERS = ("step.forward_ms.train", "step.backward_ms.train",
           "step.optimizer_ms.train", "ops.point_ms.train",
           "ops.loss_ms.train", "layers.forward_ms.train",
           "host.issue_ms.train", "host.syncs_per_step.train")


def test_readers_none_on_the_cpu_and_stretches_made_once(monkeypatch):
    cell = tiny_cell("pn2_ae.train_cd_emd.b32n2048")
    assert set(READERS) <= {m["name"] for m in cell.per_layer}
    drv = harness.driver_for(cell, 2**31 + 17, "cpu")
    drv.setup()
    made = []
    measure = spans.measure
    monkeypatch.setattr(spans, "measure",
                        lambda *a: made.append(1) or measure(*a))
    ctx = harness.Context(cell, drv, None, spec.peaks(), "cpu")
    for name in READERS:
        assert spec.metric_reader(name)(ctx) is None, name
    assert made == [1]
    got = ctx._spans
    steps = cell.traffic["steps_traced"]
    assert len(got.issue_s) == steps and not got.card
    assert got.att.calls("train.step") == steps
    assert got.att.calls("ppt.emd.backward") == steps
    assert {"layers.sa", "layers.fp", "train.optimizer"} <= set(
        got.att.names())
