"""The port's span recorder (``utils/profiling.py``) on the CPU: off, a
span site is one flag test; on, spans nest by thread and step; a train
step emits the expected spans and the same numbers; ``attribute`` reads
a synthetic profile. (The shared clock with CUPTI is a card test in
``test_torch_cuda.py``.)"""

import collections
import threading

import pytest
import torch

from pytorch_points_tpu_torch.models import (
    PointCloudAutoencoder,
    PointUpsampler,
)
from pytorch_points_tpu_torch.ops import chamfer_distance
from pytorch_points_tpu_torch.parallel import (
    make_train_step,
    reconstruction_loss,
)
from pytorch_points_tpu_torch.utils import profiling
from pytorch_points_tpu_torch.utils.profiling import Event, Span


def _boom(*a, **k):
    raise AssertionError("a span site did work with the recorder off")


def _autoencoder():
    model = PointCloudAutoencoder(8, 4, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    opt = torch.optim.Adam(model.parameters(), 1e-3)
    loss_fn = reconstruction_loss(emd_weight=0.1,
                                  emd_kwargs={"phases": 1, "max_iters": 3})
    return model, make_train_step(model, opt, loss_fn)


def _upsampler():
    model = PointUpsampler(device="cpu",
                           generator=torch.Generator().manual_seed(3))
    opt = torch.optim.Adam(model.parameters(), 1e-3)

    def loss_fn(m, b):
        return chamfer_distance(m(b["points"]), b["target"])

    return model, make_train_step(model, opt, loss_fn)


def _batch(kind):
    g = torch.Generator().manual_seed(11)
    if kind == "autoencoder":
        return {"points": torch.rand(2, 16, 3, generator=g)}
    return {"points": torch.rand(2, 32, 3, generator=g),
            "target": torch.rand(2, 128, 3, generator=g)}


MODELS = {"autoencoder": _autoencoder, "upsampler": _upsampler}

# the spans of one train step, with their counts
STEP = {"train.step": 1, "train.forward": 1, "train.backward": 1,
        "train.optimizer": 1, "ppt.chamfer": 1, "ppt.nndistance": 1,
        "ppt.nndistance.backward": 1}
EXPECTED = {
    "autoencoder": {**STEP, "layers.sa": 3, "layers.fp": 3, "ppt.fps": 2,
                    "ppt.ball_query": 2, "ppt.group": 3, "ppt.gather": 3,
                    "ppt.gather.backward": 1, "ppt.knn": 2,
                    "ppt.three_nn": 2, "ppt.three_interpolate": 2,
                    "ppt.three_interpolate.backward": 2, "ppt.emd": 1,
                    "ppt.emd.backward": 1},
    "upsampler": {**STEP, "layers.edgeconv": 2, "ppt.knn": 2,
                  "ppt.group": 2, "ppt.gather": 2,
                  "ppt.gather.backward": 2},
}


def test_off_is_one_flag_test(monkeypatch):
    assert profiling.op_scope("fps") is profiling._NOOP
    assert profiling.annotate("train.step") is profiling._NOOP
    monkeypatch.setattr(profiling, "_clock", _boom)
    monkeypatch.setattr(profiling, "record_function", _boom)
    monkeypatch.setattr(profiling, "Recorder", _boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", _boom)
    monkeypatch.setattr(profiling, "_span", _boom)
    _, step = _upsampler()
    assert torch.isfinite(step(_batch("upsampler")))


def test_nesting_parents_and_steps():
    with profiling.recording() as rec:
        for _ in range(2):
            with profiling.annotate("train.step"):
                with profiling.annotate("train.forward"):
                    with profiling.op_scope("fps"):
                        pass
                with profiling.annotate("train.backward"):
                    pass
    names = [(s.name, s.parent, s.step) for s in rec.spans]
    assert names == [("train.step", -1, 0), ("train.forward", 0, 0),
                     ("ppt.fps", 1, 0), ("train.backward", 0, 0),
                     ("train.step", -1, 1), ("train.forward", 4, 1),
                     ("ppt.fps", 5, 1), ("train.backward", 4, 1)]
    assert all(s.start_ns <= s.end_ns for s in rec.spans)
    assert profiling._REC is None and profiling.op_scope("x") is \
        profiling._NOOP


def test_other_thread_takes_its_parent_from_the_root_thread():
    """A thread stands in for autograd's device thread: a span it opens
    with none of its own open takes the span open on the root's thread."""
    tids = []

    def device_thread():
        with profiling.op_scope("emd.backward"):
            with profiling.op_scope("scatter"):
                tids.append(threading.get_ident())

    with profiling.recording() as rec:
        with profiling.annotate("train.step"):
            with profiling.annotate("train.forward"):
                pass
            with profiling.annotate("train.backward"):
                t = threading.Thread(target=device_thread)
                t.start()
                t.join(timeout=10)
        t2 = threading.Thread(target=device_thread)  # no root open: a root
        t2.start()
        t2.join(timeout=10)
    assert not t.is_alive() and not t2.is_alive()
    got = [(s.name, s.parent, s.step) for s in rec.spans]
    assert got == [("train.step", -1, 0), ("train.forward", 0, 0),
                   ("train.backward", 0, 0), ("ppt.emd.backward", 2, 0),
                   ("ppt.scatter", 3, 0), ("ppt.emd.backward", -1, 1),
                   ("ppt.scatter", 5, 1)]
    assert [rec.spans[i].thread for i in (3, 4, 5, 6)] == [
        tids[0], tids[0], tids[1], tids[1]]
    assert rec.spans[0].thread == threading.get_ident() != tids[0]


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_train_step_emits_the_expected_spans(kind):
    model, step = MODELS[kind]()
    with profiling.recording() as rec:
        step(_batch(kind))
    assert collections.Counter(s.name for s in rec.spans) == EXPECTED[kind]
    by_name = {s.name: s for s in rec.spans}
    index = {id(s): i for i, s in enumerate(rec.spans)}
    for name, parent in (("train.forward", "train.step"),
                         ("ppt.chamfer", "train.forward"),
                         ("ppt.nndistance.backward", "train.backward"),
                         ("train.optimizer", "train.step")):
        assert by_name[name].parent == index[id(by_name[parent])], name
    assert {s.step for s in rec.spans} == {0}


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_recording_changes_no_number(kind):
    out = {}
    for on in (False, True):
        model, step = MODELS[kind]()
        with (profiling.recording() if on else profiling._NOOP):
            losses = [step(_batch(kind)) for _ in range(2)]
        out[on] = losses, [p.detach().clone() for p in model.parameters()]
    for a, b in zip(out[False][0] + out[False][1],
                    out[True][0] + out[True][1]):
        assert torch.equal(a, b)


def _us(t):
    return int(t * 1000)


def test_attribute_on_a_synthetic_profile():
    """Thread 1 opens the step, thread 2 runs a backward (times in us):
    each item goes to the innermost span open at its launch on its thread,
    else on the root's; gaps are labelled by what the host was doing."""
    a, b = 1, 2

    def span(name, s, e, parent, thread):
        return Span(name, _us(s), parent, thread, 0, _us(e))

    spans = [span("train.step", 0, 100, -1, a),
             span("train.forward", 10, 40, 0, a),
             span("ppt.fps", 15, 25, 1, a),
             span("train.backward", 50, 95, 0, a),
             span("ppt.emd.backward", 55, 70, 3, b)]
    evs = []

    def launch(corr, thread, at, item=None, name="cudaLaunchKernel",
               took=1):
        evs.append(Event(name, _us(at), _us(at + took), corr, False, thread))
        if item:
            evs.append(Event(item[2] if len(item) > 2 else "k", _us(item[0]),
                             _us(item[1]), corr, True))

    launch(10, a, -10, (-5, -2))           # before the window
    launch(1, a, 16, (30, 40))             # ppt.fps
    launch(2, a, 35, (40, 45))             # train.forward
    launch(3, b, 60, (62, 70))             # ppt.emd.backward; gap 45-62
    launch(4, b, 72, (75, 80))             # b has none open: train.backward
    launch(5, a, 76, (80, 81, "Memcpy DtoH (Device -> Pinned)"),
           name="cudaMemcpyAsync")
    launch(6, a, 77, name="cudaStreamSynchronize", took=5)
    launch(7, a, 78, (90, 92))             # launched before its gap: queued
    launch(8, a, 120, (121, 125))          # outside every span
    att = profiling.attribute(evs, spans, since_ns=0)

    def us(x):
        return pytest.approx(x * 1e-6, abs=1e-12)

    assert att.device_s("ppt.fps") == us(10)
    assert att.device_s("train.forward") == us(15)
    assert att.device_s("ppt.fps", "train.forward") == us(15)
    assert att.device_s("ppt.emd.backward") == us(8)
    assert att.device_s("train.backward") == us(16)
    assert att.device_s("train.step") == us(31)
    assert att.self_device_s("train.forward") == us(5)
    assert att.self_device_s("train.backward") == us(8)
    assert att.self_device_s("train.step") == us(0)
    assert att.unattributed_s == us(4)
    assert att.busy_s == us(35) and att.window_s == us(125)
    assert [(g[0], round(g[1] * 1e6, 6)) for g in att.gaps] == [
        ("train.step", 30), ("train.backward", 29), ("train.step", 17),
        ("queued", 9), ("train.backward", 5)]
    assert [(n, round(s * 1e6, 6), lab) for n, s, lab in att.syncs] == [
        ("cudaMemcpyAsync", 1, "train.backward"),
        ("cudaStreamSynchronize", 5, "train.backward")]
    assert att.calls("train.step") == 1
    assert att.host_s("train.backward") == us(45)
