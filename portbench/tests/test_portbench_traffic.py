"""Traffic is a function of the seed alone."""

import torch

from portbench import gen
from portbench.kinds import serve, train
from portbench.spec import traffic

SEED = 2**31 + 977  # seeds may pass 32 signed bits


def test_clouds_deterministic_by_seed():
    a = gen.surface_clouds(3, 500, "cpu", SEED, 4)
    b = gen.surface_clouds(3, 500, "cpu", SEED, 4)
    c = gen.surface_clouds(3, 500, "cpu", SEED + 1, 4)
    d = gen.surface_clouds(3, 500, "cpu", SEED, 5)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert a.shape == (3, 500, 3) and a.dtype == torch.float32
    r = a.norm(dim=-1).amax(dim=1)
    torch.testing.assert_close(r, torch.ones(3), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a.mean(dim=1), torch.zeros(3, 3),
                               rtol=0, atol=1e-5)


def test_every_training_batch_deterministic_and_distinct():
    for name in ("train_cd_emd.b32n2048", "train_cd.b32n2048x4"):
        tr = dict(traffic(name), batch=2, points=64)
        if "target_points" in tr:
            tr["target_points"] = 256
        b0 = train.draw_batch(tr, "cpu", SEED, 0)
        again = train.draw_batch(tr, "cpu", SEED, 0)
        b1 = train.draw_batch(tr, "cpu", SEED, 1)
        for k in b0:
            assert torch.equal(b0[k], again[k])
            assert not torch.equal(b0[k], b1[k])
        if "target" in b0:  # the input is a subset of its target
            d = (b0["points"][:, :, None] - b0["target"][:, None]).norm(
                dim=-1).amin(dim=2)
            assert float(d.max()) == 0.0


def test_arrivals_same_set_other_order():
    tr = traffic("serve.b32n2048x4")
    assert serve.due_times(tr, 1.0, SEED) == [
        i / tr["rate_per_s"] for i in range(int(tr["rate_per_s"]))
    ] or tr["jitter"] > 0  # periodic without a jitter
    tr = dict(tr, jitter=0.5)
    a = serve.due_times(tr, 2.0, SEED)
    b = serve.due_times(tr, 2.0, SEED)
    c = serve.due_times(tr, 2.0, SEED + 1)
    assert a == b and a != c
    rate = tr["rate_per_s"]
    jit = lambda ds: sorted(round(d * rate - i, 9) for i, d in enumerate(ds))
    assert jit(a) == jit(c)  # the same jitters, in another order
    assert len(a) == int(rate * 2.0)
    assert serve.sampled(100, 8, SEED) == serve.sampled(100, 8, SEED)
    assert 99 in serve.sampled(100, 8, SEED)


def test_weights_deterministic_by_seed():
    spec = [("a.weight", (4, 8), "linear"), ("a.bias", (4,), "bias"),
            ("n.weight", (4,), "norm_scale")]
    w = gen.weights(spec, "cpu", SEED)
    assert all(torch.equal(w[k], gen.weights(spec, "cpu", SEED)[k])
               for k in w)
    assert not torch.equal(w["a.weight"],
                           gen.weights(spec, "cpu", SEED + 1)["a.weight"])
    assert float(w["a.weight"].abs().max()) <= 2 * (8 ** -0.5) / 0.8796
    assert float(w["a.bias"].abs().max()) <= 0.1
    assert float((w["n.weight"] - 1).abs().max()) <= 0.1
