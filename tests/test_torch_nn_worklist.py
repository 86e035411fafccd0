"""The port's worklist NN (``_run_worklist``, the counterpart of the TPU
kernel ``_nn_worklist_kernel``) and the pruned bidirectional NN built on it
(``nn_both_directions_pruned``) against the JAX package.

The JAX functions run their Pallas kernels in interpret mode, as the JAX
package's own kernel tests run them on the CPU; the port runs its plain
PyTorch versions (CPU tensors). Inputs come from numpy with a seed.

Tolerances, and why: the worklist is held bitwise on dyadic-grid clouds,
where every distance is exact in float32, so ties resolve by position
alike on both sides; indices exactly equal everywhere. On real-valued
clouds distances are held at rtol 1e-6: XLA's CPU backend contracts some
interpret-mode multiply-adds into FMAs (about one distance in six an ulp
away). The candidate count decides the branch, so it is held equal to the
reference's (read from its own ``_run_worklist``) on grid clouds, where
every bound is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.kernels import distance_tiles as jax_dt
from pytorch_points_tpu_torch.kernels import distance_tiles
from torch_inputs import cloud, emd_cloud

RTOL = 1e-6
TN, TM = 128, 64  # small tiles: 5 x 8 tile pairs at N=600, M=500


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _random_cand(rng, b, ni, nj, share=0.3):
    """[B,nI,nJ] int32 with every tile row and column holding a pair."""
    cand = rng.uniform(size=(b, ni, nj)) < share
    for bi in range(b):
        cand[bi, np.arange(ni), rng.integers(0, nj, ni)] = True
        cand[bi, rng.integers(0, ni, nj), np.arange(nj)] = True
    return cand.astype(np.int32)


def _worklist_case(seed, n=600, m=500, b=2):
    """Padded grid clouds (port layout), JAX's layout of the same, a
    random candidate mask and the tile counts."""
    rng = np.random.default_rng(seed)
    p, q = emd_cloud(rng, b, n, "grid"), emd_cloud(rng, b, m, "grid")
    n_pad, m_pad = -(-n // TN) * TN, -(-m // TM) * TM
    pp = distance_tiles._pad_poison(_t(p), n_pad, 1.0)
    qp = distance_tiles._pad_poison(_t(q), m_pad, -1.0)
    ni, nj = n_pad // TN, m_pad // TM
    return pp, qp, _random_cand(rng, b, ni, nj), ni, nj


def _jax_worklist(pp, qp, cand, ni, nj, k_max):
    b, n_pad, _ = pp.shape
    m_pad = qp.shape[1]
    pt = jnp.transpose(jnp.pad(jnp.asarray(pp.numpy()),
                               ((0, 0), (0, 0), (0, 5))), (0, 2, 1))
    qs = jnp.pad(jnp.asarray(qp.numpy()), ((0, 0), (0, 0), (0, 5)))
    (d1, i1, d2, i2), count = jax_dt._run_worklist(
        jnp.asarray(cand), pt, qs, b, ni, nj, TN, TM, n_pad, k_max)

    def flat(x):  # [B, tm, nJ] with q point j*tm + r at (r, j) -> [B, M']
        return np.asarray(jnp.transpose(x, (0, 2, 1)).reshape(b, m_pad))

    return (np.asarray(d1[:, 0]), np.asarray(i1[:, 0]), flat(d2), flat(i2),
            np.asarray(count))


def test_worklist_matches_pallas_on_grid_clouds():
    pp, qp, cand, ni, nj = _worklist_case(31)
    k_max = int(cand.reshape(2, -1).sum(1).max())
    ref = _jax_worklist(pp, qp, cand, ni, nj, k_max)
    got, count = distance_tiles._run_worklist(
        _t(cand), pp, qp, 2, ni, nj, TN, TM, pp.shape[1], k_max)
    for g, r in zip((*got, count), ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), r)
    assert [g.dtype for g in got] == [torch.float32, torch.int32] * 2
    # the pruning matters: some rows find another neighbour than the dense
    # scan over all pairs; distances never undercut it
    dense = distance_tiles.nn_both_directions(pp, qp)
    assert (got[1] != dense[1]).any() and (got[0] >= dense[0]).all()


def test_worklist_ties_resolve_by_sorted_position():
    # coarse-grid clouds (k/8: many points at equal distance), sorted along
    # the Morton curve, every pair a candidate: equal to the reference, and
    # ties go to the lowest SORTED position, which in original order is
    # another index than the dense kernel's lowest original one
    rng = np.random.default_rng(32)
    p, q = _t(cloud(rng, 2, 600, "grid")), _t(cloud(rng, 2, 500, "grid"))
    perm_p = torch.sort(distance_tiles._morton_codes(p), dim=1,
                        stable=True).indices
    perm_q = torch.sort(distance_tiles._morton_codes(q), dim=1,
                        stable=True).indices
    pp = distance_tiles._pad_poison(p.gather(1, perm_p[..., None].expand(
        -1, -1, 3)), 640, 1.0)
    qp = distance_tiles._pad_poison(q.gather(1, perm_q[..., None].expand(
        -1, -1, 3)), 512, -1.0)
    cand = np.ones((2, 5, 8), np.int32)
    ref = _jax_worklist(pp, qp, cand, 5, 8, 40)
    got, _ = distance_tiles._run_worklist(_t(cand), pp, qp, 2, 5, 8, TN, TM,
                                          640, 40)
    for g, r in zip(got, ref[:4]):
        np.testing.assert_array_equal(g.numpy(), r)
    d1 = torch.empty_like(got[0][:, :600]).scatter_(1, perm_p,
                                                    got[0][:, :600])
    i1 = torch.empty_like(got[1][:, :600]).scatter_(
        1, perm_p, perm_q.gather(1, got[1][:, :600].long()).to(torch.int32))
    dense_d, dense_i = distance_tiles.nn_one_direction(p, q)
    assert torch.equal(d1, dense_d)
    assert (i1 != dense_i).any()


def test_worklist_truncated_at_k_max():
    # k_max below the count: only the first k_max pairs in i-major order
    # run. The reference leaves p tiles that no pair reached unwritten, so
    # those rows are compared only in the port ((inf, 0), its start).
    pp, qp, cand, ni, nj = _worklist_case(33)
    counts = cand.reshape(2, -1).sum(1)
    k_max = int(counts.min()) - 7
    ref = _jax_worklist(pp, qp, cand, ni, nj, k_max)
    got, count = distance_tiles._run_worklist(
        _t(cand), pp, qp, 2, ni, nj, TN, TM, pp.shape[1], k_max)
    np.testing.assert_array_equal(count.numpy(), counts)
    np.testing.assert_array_equal(ref[4], counts)
    for g, r in zip(got[2:], ref[2:4]):  # q rows: every row defined
        np.testing.assert_array_equal(g.numpy(), r)
    for bi in range(2):
        pairs = np.flatnonzero(cand[bi].reshape(-1))[:k_max]
        reached = np.zeros(ni, bool)
        reached[pairs // nj] = True
        rows = np.repeat(reached, TN)
        assert not rows.all()  # the cut leaves some p tile unvisited
        for g, r in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(g[bi].numpy()[rows], r[bi][rows])
        assert torch.isinf(got[0][bi][~torch.from_numpy(rows)]).all()
        assert (got[1][bi][~torch.from_numpy(rows)] == 0).all()


def _spy_counts(monkeypatch):
    """Record each call's candidate counts from the reference's own
    ``_run_worklist`` (jit caches cleared, so the spy is traced in)."""
    seen = []
    real = jax_dt._run_worklist

    def spy(*args):
        outs, count = real(*args)
        jax.debug.callback(lambda c: seen.append(np.asarray(c)), count)
        return outs, count

    monkeypatch.setattr(jax_dt, "_run_worklist", spy)
    jax.clear_caches()
    return seen


@pytest.fixture
def clear_jax_caches():
    yield
    jax.clear_caches()


def _shuffled(rng, p):
    return np.stack([c[rng.permutation(len(c))] for c in p])


PRUNED_CASES = {
    # name: (clouds, tn, tm, the branch that answers)
    "shuffle_4096": ("shuffle", 4096, 4096, 256, 128, "worklist"),
    "independent_4096": ("independent", 4096, 4096, 256, 128, "dense"),
    "small_default_tiles": ("independent", 300, 420, None, None, "worklist"),
}


@pytest.mark.parametrize("case", sorted(PRUNED_CASES))
def test_pruned_matches_jax(case, monkeypatch, clear_jax_caches):
    kind, n, m, tn, tm, branch = PRUNED_CASES[case]
    rng = np.random.default_rng(34)
    p = cloud(rng, 2, n)
    q = _shuffled(rng, p) if kind == "shuffle" else cloud(rng, 2, m)
    seen = _spy_counts(monkeypatch)
    ref = jax_dt.nn_both_directions_pruned(jnp.asarray(p), jnp.asarray(q),
                                           tn=tn, tm=tm)
    ref = [np.asarray(r) for r in ref]
    got = distance_tiles.nn_both_directions_pruned(_t(p), _t(q), tn, tm)
    for g, r in zip(got, ref, strict=True):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), r)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=0)
    plan = distance_tiles.pruned_plan(_t(p), _t(q), tn, tm)
    np.testing.assert_array_equal(plan["count"].numpy(), seen[-1])
    took = "dense" if (plan["count"] > plan["k_max"]).any() else "worklist"
    assert took == branch


@pytest.mark.parametrize("kind,branch", [("shuffle", "worklist"),
                                         ("independent", "dense")])
def test_pruned_count_and_branch_match_jax_on_grid(kind, branch,
                                                   monkeypatch,
                                                   clear_jax_caches):
    # coarse grid (k/8): every bound exact, many exact duplicates
    rng = np.random.default_rng(35)
    p = cloud(rng, 2, 2048, "grid")
    q = _shuffled(rng, p) if kind == "shuffle" else cloud(rng, 2, 2048,
                                                           "grid")
    seen = _spy_counts(monkeypatch)
    ref = jax_dt.nn_both_directions_pruned(jnp.asarray(p), jnp.asarray(q),
                                           tn=TN, tm=TM)
    got = distance_tiles.nn_both_directions_pruned(_t(p), _t(q), TN, TM)
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    plan = distance_tiles.pruned_plan(_t(p), _t(q), TN, TM)
    np.testing.assert_array_equal(plan["count"].numpy(), seen[-1])
    assert plan["k_max"] == 246
    assert ((plan["count"] > 246).any().item()) == (branch == "dense")
    dense = distance_tiles.nn_both_directions(_t(p), _t(q))
    for g, r in zip(got[::2], dense[::2]):
        assert torch.equal(g, r)  # distances: the dense kernel's
