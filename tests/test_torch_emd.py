"""The port's auction EMD (K11, K12), ``earth_mover_distance``, ``EMDLoss``,
``ChamferLoss`` and the metrics against the JAX package.

The JAX side runs under ``force_impl("pallas")`` (the Pallas kernels in
interpret mode, jit caches cleared around it); the port runs its plain
PyTorch versions on the CPU.

Why dyadic-grid clouds (coordinates k/64): XLA's CPU backend rounds about
one benefit in five an ulp away from sequential float32 (it contracts some
multiply-adds into FMAs), so on real-valued clouds the interpret-mode
auction and any sequential-f32 restatement drift apart in ``price`` and,
through it, in ``owner``. On the grid every distance, benefit and price
sum is exact in float32, so both sides must agree bit for bit: owners,
prices and assignments are held EQUAL there. On real-valued clouds the
port is held to the reference's contracts instead (a permutation, the
eps-CS bound against scipy's Hungarian solver, identity).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from pytorch_points_tpu import losses as jax_losses
from pytorch_points_tpu.kernels import auction as jax_auction
from pytorch_points_tpu.kernels import dispatch as jax_dispatch
from pytorch_points_tpu.ops import emd as jax_emd
from pytorch_points_tpu_torch import losses
from pytorch_points_tpu_torch.kernels import auction
from pytorch_points_tpu_torch.ops import earth_mover_distance
from pytorch_points_tpu_torch.ops import emd as port_emd
from torch_inputs import emd_cloud

EPS = 0.005


@pytest.fixture(scope="module", autouse=True)
def pallas():
    jax.clear_caches()
    jax_dispatch.force_impl("pallas")
    yield
    jax_dispatch.force_impl(None)
    jax.clear_caches()


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _eq(got, ref):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# K11 and K12: plain versions against the Pallas kernels, bitwise
# ---------------------------------------------------------------------------

# (b, n, ti, phases, max_iters, budgets, warm_start)
K11_CASES = {
    "n128_ti128_1phase": (2, 128, 128, 1, 3, (), True),
    "n256_3phase_warm": (2, 256, 256, 3, 2, (), True),
    "n256_ti128_cold": (3, 256, 128, 3, 2, (), False),
    "n256_1phase_cold": (2, 256, 256, 1, 4, (), False),
    "n100_padded": (2, 100, 256, 3, 15, (), True),
    "budgets_40_25_15": (2, 256, 256, 3, 15, (40, 25, 15), True),
}


@pytest.mark.parametrize("case", sorted(K11_CASES))
def test_auction_plain_matches_pallas(case):
    b, n, ti, phases, iters, budgets, warm = K11_CASES[case]
    rng = np.random.default_rng(30)
    p, q = emd_cloud(rng, b, n, "grid"), emd_cloud(rng, b, n, "grid")
    jo, jp, jpp, jqp = jax_auction._auction_owner(
        jnp.asarray(p), jnp.asarray(q), EPS, iters, ti, phases, 6.0, budgets,
        warm)
    to, tp, tpp, tqp = auction._auction_owner(_t(p), _t(q), EPS, iters, ti,
                                              phases, 6.0, budgets, warm)
    _eq(to, jo)
    _eq(tp, jp)
    _eq(tpp, jpp)
    _eq(tqp, jqp)
    if not budgets and iters < 15:
        assert (to < 0).any()  # stragglers for the endgame


@pytest.mark.parametrize("hint", [True, False])
def test_auction_hint_picks_the_ladder(hint):
    """The hint (a bool tensor) picks the hard ladder when true, the
    default one (max_iters a phase) when false."""
    rng = np.random.default_rng(31)
    p, q = emd_cloud(rng, 2, 256, "grid"), emd_cloud(rng, 2, 256, "grid")
    hard = (3, 2, 2)
    jo, jp, _, _ = jax_auction._auction_owner(
        jnp.asarray(p), jnp.asarray(q), EPS, 1, 256, 3, 6.0,
        hard if hint else (), True)
    to, tp, _, _ = auction._auction_owner(_t(p), _t(q), EPS, 1, 256, 3, 6.0,
                                          (), True, torch.tensor(hint), hard)
    _eq(to, jo)
    _eq(tp, jp)


# (b, n, pop_cap, max_iters, phases, warm_start): stragglers from a tiny
# budget; "two_rounds" leaves 512 per cloud (padding included), more than
# one of the reference's 256-person rounds.
K12_CASES = {
    "n128_pop768": (2, 128, 768, 2, 1, True),
    "n256_pop8": (2, 256, 8, 2, 2, True),
    "n256_pop64": (2, 256, 64, 2, 3, True),
    "n512_pop16_cold": (2, 512, 16, 1, 1, False),
    "two_rounds": (2, 384, 768, 0, 1, True),
}


@pytest.mark.parametrize("case", sorted(K12_CASES))
def test_augment_plain_matches_pallas(case):
    b, n, pop, iters, phases, warm = K12_CASES[case]
    rng = np.random.default_rng(32)
    p, q = emd_cloud(rng, b, n, "grid"), emd_cloud(rng, b, n, "grid")
    jo, jp, jpp, jqp = jax_auction._auction_owner(
        jnp.asarray(p), jnp.asarray(q), EPS, iters, 256, phases, 6.0, (),
        warm)
    assert (np.asarray(jo) < 0).sum(1).min() >= 8
    ref = jax_auction._residual_rounds(jo, jp, jpp, jqp, EPS, n, pop_cap=pop)
    got, price = auction._residual_rounds(_t(jo), _t(jp), _t(jpp), _t(jqp),
                                          EPS, pop_cap=pop)
    _eq(got, ref)
    assert (got >= 0).all()
    assert torch.equal(torch.sort(got, 1).values,
                       torch.arange(got.shape[1]).expand_as(got).int())
    assert (price >= _t(jp)).all()  # prices only rise


@pytest.mark.parametrize("kind", ["uniform", "normal", "gmm"])
def test_hardness_hint_matches_jax(kind):
    rng = np.random.default_rng(33)
    p, q = emd_cloud(rng, 4, 1024, kind), emd_cloud(rng, 4, 1024, kind)
    want = bool(jax_auction._hardness_hint(jnp.asarray(p), jnp.asarray(q)))
    got = auction._hardness_hint(_t(p), _t(q))
    assert got.dtype == torch.bool and got.ndim == 0
    assert bool(got) == want
    assert want == (kind == "gmm")  # the hint separates the kinds


def test_auction_unassigned_count_matches_jax():
    rng = np.random.default_rng(34)
    p, q = emd_cloud(rng, 2, 256, "grid"), emd_cloud(rng, 2, 256, "grid")
    want = jax_auction.auction_unassigned_count(p, q, EPS, 3, phases=2)
    got = auction.auction_unassigned_count(_t(p), _t(q), EPS, 3, phases=2)
    _eq(got, want)


# ---------------------------------------------------------------------------
# The work counters of the plain K11 and K12 (the kernels write the same)
# ---------------------------------------------------------------------------


def _line(xs):
    """[1, n, 3] points on the x axis."""
    return torch.tensor([[[x, 0.0, 0.0] for x in xs]], dtype=torch.float32)


def test_auction_counts_a_worked_case():
    """Persons at x = 0, 1; objects at x = 1, -2; eps 0.5, chunks of one
    person, cold start. Sweep 1: person 0 bids (-1 + 4) + .5 = 3.5 for
    object 0; person 1 outbids it, (0 + 9) + .5 = 9.5. Sweep 2: person 0,
    alone, takes object 1 at (-4 + 10) + .5 = 6.5 + .5 = 7: 3 bidder
    scans in 2 sweeps. Phase 2 (owners reset, prices kept) runs the same
    way: 10.5, then 16.5 for object 0, then 14 for object 1."""
    p, q = _line([0.0, 1.0]), _line([1.0, -2.0])
    counts = torch.full((1, 2, 2), -1, dtype=torch.int32)
    owner, price = auction.auction_torch(p, q, [0.5, 0.5], ([5, 5], [5, 5]),
                                         None, 1, False, counts)
    assert counts.tolist() == [[[3, 3], [2, 2]]]
    assert owner.tolist() == [[1, 0]]
    assert price.tolist() == [[16.5, 14.0]]


def test_augment_counts_a_worked_case():
    """Four points at x = 0..3 on both sides, object j owned by person j+1,
    object 3 free, so person 0 is the one straggler. Its search pops
    columns 0, 1, 2 (each owned, relaxing the next at d = -1 + eps, -2 +
    2 eps, -3 + 3 eps) and then the free column 3: 4 pops. At pop cap 2
    it stops after columns 0 and 1 and takes the free column 3, which
    column 1 relaxed last: 2 pops, one capped straggler, and the path 3 <-
    1 <- 0 flips."""
    x = [0.0, 1.0, 2.0, 3.0]
    p, q = _line(x), _line(x)
    owner = torch.tensor([[1, 2, 3, -1]], dtype=torch.int32)
    price = torch.zeros((1, 4))
    for pop, want, flipped in ((768, [[4, 0]], [[0, 1, 2, 3]]),
                               (2, [[2, 1]], [[0, 1, 3, 2]])):
        counts = torch.full((1, 2), -1, dtype=torch.int32)
        got, _ = auction.augment_torch(owner, price, p, q, 0.25, pop, 4,
                                       counts)
        assert counts.tolist() == want
        assert got.tolist() == flipped


def test_counters_leave_owners_and_prices_unchanged():
    rng = np.random.default_rng(35)
    p, q = (_t(emd_cloud(rng, 3, 256, "normal")) for _ in range(2))
    eps_k = auction.phase_schedule(EPS, 3, 6.0)
    ladders = ([2, 2, 2], [3, 3, 3])
    hint = torch.tensor(False)
    plain = auction.auction_torch(p, q, eps_k, ladders, hint, 128, True)
    k11 = torch.zeros((3, 2, 3), dtype=torch.int32)
    counted = auction.auction_torch(p, q, eps_k, ladders, hint, 128, True,
                                    k11)
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)
    owner, price = plain
    assert ((owner < 0).sum(1) > 0).all()  # stragglers for the endgame
    assert (k11[:, 1] == 2).all()  # no phase finished inside its 2 sweeps
    assert (k11[:, 0, 0] > 256).all()  # 256 bidders in every first sweep
    ends = auction.augment_torch(owner, price, p, q, EPS, 16, 4096)
    k12 = torch.zeros((3, 2), dtype=torch.int32)
    counted = auction.augment_torch(owner, price, p, q, EPS, 16, 4096, k12)
    for a, b in zip(ends, counted):
        assert torch.equal(a, b)
    stragglers = (owner < 0).sum(1)
    assert (k12[:, 0] >= stragglers).all()  # a pop at least each
    assert (k12[:, 0] <= 16 * stragglers).all()
    assert (k12[:, 1] <= stragglers).all()


# ---------------------------------------------------------------------------
# earth_mover_distance against the JAX op
# ---------------------------------------------------------------------------


def _jax_emd_value_and_grads(p, q, w, **kw):
    def f(p, q):
        d, _ = jax_emd.earth_mover_distance(p, q, **kw)
        return jnp.sum(d * w)

    return jax.value_and_grad(f, (0, 1))(jnp.asarray(p), jnp.asarray(q))


@pytest.mark.parametrize("pop_cap", [768, 8])
def test_emd_matches_jax_on_grid(pop_cap):
    rng = np.random.default_rng(35)
    p, q = emd_cloud(rng, 2, 256, "grid"), emd_cloud(rng, 2, 256, "grid")
    w = rng.standard_normal((2, 256)).astype(np.float32)
    jd, ja = jax_emd.earth_mover_distance(p, q, endgame_pop_cap=pop_cap)
    rv, (rgp, rgq) = _jax_emd_value_and_grads(p, q, w,
                                              endgame_pop_cap=pop_cap)
    tp, tq = _t(p).requires_grad_(), _t(q).requires_grad_()
    dist, assign = earth_mover_distance(tp, tq, endgame_pop_cap=pop_cap)
    assert assign.dtype == torch.int32 and not assign.requires_grad
    _eq(assign, ja)
    _eq(dist, jd)
    (dist * _t(w)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(rgp), rtol=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(rgq), rtol=1e-6)


def _equal_count_masks(rng, b, n):
    """Two masks with equal valid counts per cloud, 75-100% valid."""
    counts = rng.integers(3 * n // 4, n + 1, b)
    pm = np.stack([np.isin(np.arange(n), rng.permutation(n)[:c])
                   for c in counts])
    qm = np.stack([np.isin(np.arange(n), rng.permutation(n)[:c])
                   for c in counts])
    return pm, qm


def test_emd_masked_matches_jax():
    rng = np.random.default_rng(36)
    p, q = emd_cloud(rng, 2, 200, "grid"), emd_cloud(rng, 2, 200, "grid")
    pm, qm = _equal_count_masks(rng, 2, 200)
    jd, ja = jax_emd.earth_mover_distance(p, q, p_mask=pm, q_mask=qm)
    tp = _t(p).requires_grad_()
    dist, assign = earth_mover_distance(tp, _t(q), p_mask=_t(pm),
                                        q_mask=_t(qm))
    _eq(assign, ja)
    _eq(dist, jd)
    assert (dist[~_t(pm)] == 0).all() and (assign[~_t(pm)] == 0).all()
    for bi in range(2):  # valid persons matched to valid objects
        assert qm[bi][assign[bi][_t(pm[bi])].numpy()].all()
    dist.sum().backward()
    assert (tp.grad[~_t(pm)] == 0).all()


def test_poison_rank_matched_offsets():
    mask = torch.tensor([[True, False, True, False]])
    x = torch.ones(1, 4, 3)
    got = port_emd._poison_rank_matched(x, mask)
    want = jax_emd._poison_rank_matched(jnp.ones((1, 4, 3)),
                                        jnp.asarray(mask.numpy()))
    _eq(got, want)


# ---------------------------------------------------------------------------
# The reference's contracts on real-valued clouds (tests/test_emd.py)
# ---------------------------------------------------------------------------


def test_emd_is_permutation_and_matched_distance(rng):
    p = rng.standard_normal((3, 64, 3), dtype=np.float32)
    q = rng.standard_normal((3, 64, 3), dtype=np.float32)
    dist, assign = earth_mover_distance(_t(p), _t(q), eps=0.01,
                                        max_iters=200)
    a = assign.numpy()
    for bi in range(3):
        assert sorted(a[bi].tolist()) == list(range(64))
    want = np.stack([np.sum((p[bi] - q[bi][a[bi]]) ** 2, -1)
                     for bi in range(3)])
    np.testing.assert_allclose(dist.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("phases,max_iters", [(2, 2), (3, 15)])
def test_emd_eps_cs_bound(rng, phases, max_iters):
    """cost <= optimal + n*eps, stragglers included (2 sweeps a phase leave
    many for the endgame)."""
    n, eps = 96, 0.02
    p = rng.standard_normal((2, n, 3)).astype(np.float32)
    q = rng.standard_normal((2, n, 3)).astype(np.float32)
    _, assign = earth_mover_distance(_t(p), _t(q), eps=eps,
                                     max_iters=max_iters, phases=phases)
    a = assign.numpy()
    for bi in range(2):
        d2 = ((p[bi, :, None] - q[bi, None]) ** 2).sum(-1).astype(np.float64)
        r, c = linear_sum_assignment(d2)
        assert sorted(a[bi].tolist()) == list(range(n))
        assert d2[np.arange(n), a[bi]].sum() <= d2[r, c].sum() + n * eps + 1e-3


def test_emd_identity(rng):
    p = rng.standard_normal((2, 32, 3), dtype=np.float32)
    dist, _ = earth_mover_distance(_t(p), _t(p.copy()), eps=1e-4,
                                   max_iters=2000)
    assert (dist.sum(-1) < 1e-3).all()


@pytest.mark.parametrize("warm", [True, False])
def test_auction_warm_and_cold_near_optimal(rng, warm):
    p = rng.standard_normal((3, 32, 3), dtype=np.float32)
    q = rng.standard_normal((3, 32, 3), dtype=np.float32)
    a = auction.auction_assignment(_t(p), _t(q), 0.0005, 2000,
                                   warm_start=warm).numpy()
    for bi in range(3):
        d2 = ((p[bi][:, None] - q[bi][None]) ** 2).sum(-1)
        r, c = linear_sum_assignment(d2)
        assert sorted(a[bi].tolist()) == list(range(32))
        assert np.sum((p[bi] - q[bi][a[bi]]) ** 2) <= (
            d2[r, c].sum() + 32 * 0.0005 + 1e-4)


def test_emd_greedy_backstop_completes():
    """With the endgame capped at a few stragglers the greedy pass
    finishes the permutation, each leftover person taking its nearest free
    object in person order, as the reference's backstop does."""
    rng = np.random.default_rng(37)
    p, q = emd_cloud(rng, 2, 128, "grid"), emd_cloud(rng, 2, 128, "grid")
    jo, jp, jpp, jqp = jax_auction._auction_owner(
        jnp.asarray(p), jnp.asarray(q), EPS, 1, 128, 1, 6.0, (), True)
    owner, _ = auction._residual_rounds(_t(jo), _t(jp), _t(jpp), _t(jqp), EPS,
                                        s_max=2, max_rounds=2)
    assert (owner < 0).sum() > 0
    got = auction._invert_and_complete(owner, _t(jpp), _t(jqp), 128)
    for bi in range(2):
        assert sorted(got[bi].tolist()) == list(range(128))
    # the reference's backstop on the same owners: the first unassigned
    # person takes its nearest free object (lowest index on ties), in turn
    for bi in range(2):
        held = {o: j for j, o in enumerate(owner[bi].tolist()) if o >= 0}
        taken = set(held.values())
        for i in [i for i in range(128) if i not in held]:
            free = [j for j in range(128) if j not in taken]
            d = ((p[bi][i] - q[bi][free]) ** 2).sum(-1)
            held[i] = free[int(np.argmin(d))]
            taken.add(held[i])
        assert got[bi].tolist() == [held[i] for i in range(128)]


# ---------------------------------------------------------------------------
# EMDLoss and ChamferLoss
# ---------------------------------------------------------------------------


def test_emd_operating_point_split():
    sig = inspect.signature(earth_mover_distance)
    assert sig.parameters["endgame_pop_cap"].default == 768
    assert losses.EMDLoss().endgame_pop_cap == 384
    doc = losses.EMDLoss.__doc__
    assert "+5.03% max" in doc and "endgame_pop_cap=768" in doc
    assert losses.metrics._METRIC_EMD_DEFAULTS == {"endgame_pop_cap": 384}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("masked", [False, True])
def test_emd_loss_matches_jax(reduction, masked):
    rng = np.random.default_rng(38)
    p, q = emd_cloud(rng, 2, 128, "grid"), emd_cloud(rng, 2, 128, "grid")
    pm, qm = _equal_count_masks(rng, 2, 128) if masked else (None, None)
    want = jax_losses.EMDLoss(reduction=reduction)(
        p, q, None if pm is None else jnp.asarray(pm),
        None if qm is None else jnp.asarray(qm))
    got = losses.EMDLoss(reduction=reduction)(_t(p), _t(q), _t(pm), _t(qm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


CHAMFER_LOSSES = {
    "plain": {},
    "threshold": {"threshold": 0.05},
    "trimmed": {"percentage": 0.7},
    "one_sided_sum": {"one_sided": True, "reduction": "sum"},
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cfg", sorted(CHAMFER_LOSSES))
def test_chamfer_loss_matches_jax(cfg, masked):
    rng = np.random.default_rng(39)
    p, q = emd_cloud(rng, 2, 300, "normal"), emd_cloud(rng, 2, 250, "normal")
    pm = rng.uniform(size=(2, 300)) < 0.8 if masked else None
    qm = rng.uniform(size=(2, 250)) < 0.8 if masked else None
    kw = CHAMFER_LOSSES[cfg]
    want = jax_losses.ChamferLoss(**kw)(
        p, q, None if pm is None else jnp.asarray(pm),
        None if qm is None else jnp.asarray(qm))
    got = losses.ChamferLoss(**kw)(_t(p), _t(q), _t(pm), _t(qm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_nn_metrics_match_jax(masked):
    rng = np.random.default_rng(40)
    p, q = emd_cloud(rng, 3, 200, "grid"), emd_cloud(rng, 3, 180, "grid")
    pm = rng.uniform(size=(3, 200)) < 0.8 if masked else None
    qm = rng.uniform(size=(3, 180)) < 0.8 if masked else None
    jm = [None if m is None else jnp.asarray(m) for m in (pm, qm)]
    for name, extra in (("hausdorff_distance", ()), ("chamfer_l1", ()),
                        ("fscore", (0.1,))):
        want = getattr(jax_losses, name)(p, q, *extra, *jm)
        got = getattr(losses, name)(_t(p), _t(q), *extra, _t(pm), _t(qm))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("metric", ["chamfer", "emd"])
def test_set_metrics_match_jax(metric):
    """1-NNA and COV/MMD over G=3 generated and R=4 reference clouds, pairs
    solved in batches of 4 (the last one padded, as the reference pads)."""
    rng = np.random.default_rng(41)
    gen = emd_cloud(rng, 3, 128, "grid")
    ref = np.concatenate([gen[:1] + np.float32(1 / 64),
                          emd_cloud(rng, 3, 128, "grid")])
    kw = {"metric": metric, "pair_batch": 4}
    acc = losses.one_nn_accuracy(_t(gen), _t(ref), **kw)
    np.testing.assert_allclose(
        acc.numpy(), np.asarray(jax_losses.one_nn_accuracy(gen, ref, **kw)),
        rtol=1e-6)
    cov, mmd = losses.coverage_and_mmd(_t(gen), _t(ref), **kw)
    jcov, jmmd = jax_losses.coverage_and_mmd(gen, ref, **kw)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-6)
    np.testing.assert_allclose(mmd.numpy(), np.asarray(jmmd), rtol=1e-6)


def test_emd_unequal_valid_counts_matches_jax():
    """Masks with unequal valid counts (30 against 35 of 40): the
    reference's greedy backstop moves the persons left on alignment pads
    to free real objects, and the port gives the same assignment."""
    rng = np.random.default_rng(5)
    p = rng.uniform(-1, 1, (1, 40, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (1, 40, 3)).astype(np.float32)
    pm = np.arange(40)[None] < 30
    qm = np.arange(40)[None] < 35
    jd, ja = jax_emd.earth_mover_distance(p, q, p_mask=pm, q_mask=qm)
    dist, assign = earth_mover_distance(_t(p), _t(q), p_mask=_t(pm),
                                        q_mask=_t(qm))
    _eq(assign, ja)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=1e-6)
    assert (dist[0, 30:] == 0).all() and (assign[0, 30:] == 0).all()
    assert (assign[0, :30] < 40).all()
