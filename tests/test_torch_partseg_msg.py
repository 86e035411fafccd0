"""The port's multi-scale grouping and its MSG part segmenter on the CPU.

``PointNet2PartSegMSG`` at its published widths, with the clouds cut
(npoint 32/8, N=128, B=2), against the benchmark's plain reference
(``portbench/reference/pn2_partseg_msg.py``, plain torch, nothing of the
port) on the same seeded weights and batch, the dropout's mask shared
through generators seeded alike: the logits, the mean cross-entropy and
every leaf's gradient. Then the multi-scale SA layer with one scale
against the single-scale one, and the shared group step against
``sample_and_group``'s composition as it was written before the step was
split out.

Tolerances: the two sides run the same float32 operations in the same
order, except that the port's backward of a grouping is its own
deterministic scatter-add where the reference has autograd's; so the
logits and the loss are held to a few float32 roundings of their size
(LOGIT_ATOL, LOSS_RTOL), and each gradient to GRAD_TOL of its leaf's
largest reference gradient, the sums' other order. The layer tests are
bitwise: one computation, two routes.
"""

import pytest
import torch
import torch.nn.functional as F

from portbench import gen
from portbench.kinds.train_seg import draw_batch
from portbench.reference import pn2_partseg_msg as ref
from portbench.spec import config, traffic
from pytorch_points_tpu_torch.layers import (
    PointNetSAModule,
    PointNetSAModuleMSG,
)
from pytorch_points_tpu_torch.models import PointNet2PartSegMSG
from pytorch_points_tpu_torch.ops import (
    ball_query,
    furthest_point_sample_and_gather,
    group_around,
    group_points,
    knn,
    sample_and_group,
)

LOGIT_ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
SEED = 2**31 + 23
B, N, NPOINT = 2, 128, (32, 8)


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread, so that both sides run their float32 operations in
    one order: with several, the CPU's BLAS may take another number of
    threads from call to call on a loaded machine, and the sides then part
    by roundings that the tolerances below do not count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cut_config():
    cfg = config("pn2_partseg_msg")
    cfg["kwargs"].update(npoint1=NPOINT[0], npoint2=NPOINT[1])
    cfg["sa"][0]["npoint"], cfg["sa"][1]["npoint"] = NPOINT
    return cfg


@pytest.fixture(scope="module")
def case():
    cfg = _cut_config()
    tr = dict(traffic("train_ce.b32n2048"), batch=B, points=N)
    batch = draw_batch(tr, cfg, "cpu", SEED, 0)
    w = gen.weights(ref.param_spec(cfg), "cpu", SEED)
    return cfg, batch, w


def _ce(logits, labels):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


@pytest.mark.parametrize("train", [True, False], ids=["dropout", "eval"])
def test_model_against_the_reference(case, train):
    cfg, batch, w = case
    model = PointNet2PartSegMSG(**cfg["kwargs"], device="cpu")
    model.load_state_dict(w, strict=True)
    model.train(train)
    logits = model(batch["points"], batch["normals"], batch["category"],
                   dropout_generator=torch.Generator().manual_seed(7))
    loss = _ce(logits, batch["labels"])
    loss.backward()

    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    rcfg = dict(cfg, dropout=cfg["dropout"] if train else 0.0)
    want = ref.forward(params, batch, rcfg,
                       dropout_generator=torch.Generator().manual_seed(7))
    want_loss = _ce(want, batch["labels"])
    want_loss.backward()

    assert logits.shape == (B, N, cfg["num_classes"])
    torch.testing.assert_close(logits, want, rtol=0, atol=LOGIT_ATOL)
    torch.testing.assert_close(loss, want_loss, rtol=LOSS_RTOL, atol=0)
    got = dict(model.named_parameters())
    assert set(got) == set(params)
    for name, p in params.items():
        scale = p.grad.abs().max().clamp_min(1e-30)
        gap = ((got[name].grad - p.grad).abs().max() / scale).item()
        assert gap <= GRAD_TOL, (name, gap)


def test_tf32_control_fails_the_tolerances(case):
    """The reference with its matmuls' operands rounded to TF32 (a lower
    precision than the configuration's float32) falls outside the
    tolerances above: they can tell the precision apart."""
    cfg, batch, w = case
    gens = [torch.Generator().manual_seed(7) for _ in range(2)]
    exact = ref.forward(w, batch, cfg, False, gens[0])
    tf32 = ref.forward(w, batch, cfg, True, gens[1])
    assert (tf32 - exact).abs().max().item() > 10 * LOGIT_ATOL


def test_dropout_mask_follows_its_generator(case):
    cfg, batch, w = case
    model = PointNet2PartSegMSG(**cfg["kwargs"], device="cpu")
    model.load_state_dict(w, strict=True)
    args = (batch["points"], batch["normals"], batch["category"])
    with torch.no_grad():
        a = model(*args, dropout_generator=torch.Generator().manual_seed(1))
        b = model(*args, dropout_generator=torch.Generator().manual_seed(1))
        c = model(*args, dropout_generator=torch.Generator().manual_seed(2))
        model.eval()
        d = model(*args)
        e = model(*args)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, e) and not torch.equal(a, d)


def _clouds(c):
    x = gen.surface_clouds(B, N, "cpu", SEED, 1)
    f = None if c == 0 else torch.randn(B, N, c,
                                        generator=torch.Generator()
                                        .manual_seed(c))
    return x, f


@pytest.mark.parametrize("c,radius,nsample", [(0, 0.2, 16), (5, 0.4, 32),
                                              (5, 0.3, 200)])
def test_one_scale_is_the_single_scale_layer(c, radius, nsample):
    x, f = _clouds(c)
    msg = PointNetSAModuleMSG(c, [[16, 32]], npoint=24, radii=(radius,),
                              nsamples=(nsample,), device="cpu")
    ssg = PointNetSAModule(c, [16, 32], npoint=24, radius=radius,
                           nsample=nsample, device="cpu")
    ssg.mlp.load_state_dict(msg.mlps[0].state_dict())
    with torch.no_grad():
        got, want = msg(x, f), ssg(x, f)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def _old_sample_and_group(xyz, features, npoint, nsample, radius, use_xyz):
    """``sample_and_group`` as it was written before the group step was
    split out of it (no radius normalising)."""
    new_xyz, _ = furthest_point_sample_and_gather(xyz, npoint)
    if radius is not None:
        idx, _ = ball_query(xyz, new_xyz, radius, nsample)
    else:
        _, idx = knn(new_xyz, xyz, nsample)
    grouped_xyz = group_points(xyz, idx)
    centered = grouped_xyz - new_xyz[:, :, None, :]
    if features is None:
        new_features = centered
    else:
        new_features = group_points(features, idx)
        if use_xyz:
            new_features = torch.cat([centered, new_features], dim=-1)
    return new_xyz, new_features, idx, grouped_xyz


@pytest.mark.parametrize("c,radius,use_xyz", [(0, 0.3, True), (4, 0.3, True),
                                              (4, 0.3, False),
                                              (4, None, True)])
def test_group_step_gives_the_old_outputs(c, radius, use_xyz):
    x, f = _clouds(c)
    want = _old_sample_and_group(x, f, 16, 8, radius, use_xyz)
    got = sample_and_group(x, f, 16, 8, radius, use_xyz=use_xyz)
    step = group_around(x, f, want[0], 8, radius, use_xyz=use_xyz)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(step, want[1:], strict=True):
        assert torch.equal(a, b)
