"""The 64-bit key merges of the streaming kNN (K8) and the dense NN (K5),
emulated in torch and held against the plain versions and the JAX kernels.

Both kernels rest on one fact: a candidate (d, index) with d >= +0 packs
into a 64-bit key, (float bits of d << 32) | index (K8 shifts the index
left by one, a flag bit the ring kernel uses), that orders exactly as (d,
index). So the k smallest keys of a set, or the smallest, do not depend on
the order in which candidates arrive, and partial results merge by key.

* The keys: pack and unpack at the edge values (d = +0, denormals, the
  1e9-scale distances of poisoned points, inf) and their order.
* K8: each query's support split into contiguous parts, as the kernel
  splits it across a block's warps; each part offers its candidates in
  groups, shuffled, to a list of K keys behind the kernel's float test
  against a stale worst distance (the queue flushes at random points); the
  parts' lists merge by key in shuffled order. The first k keys equal
  ``knn_torch`` and the reference's Pallas scan bitwise, on dyadic-grid
  clouds (every distance exact) with ties across the k-th place and
  duplicate points on both sides of every part boundary.
* K5: ragged N != M cut into tile pairs; each pair's row and column minima
  (keys) merge by minimum into keys that start at (inf, 0), pairs in
  shuffled order. The unpacked result equals ``nn_one_direction_torch``
  both ways and the reference's Pallas kernel bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_points_tpu.kernels import distance_tiles as jax_dt
from pytorch_points_tpu.kernels import topk_scan as jax_topk
from pytorch_points_tpu_torch.kernels import distance_tiles, topk_scan

INF_BITS = 0x7F800000


def _pack(d: torch.Tensor, idx: torch.Tensor, shift: int) -> torch.Tensor:
    """The kernels' key: (bits of d << 32) | (idx << shift), in int64 (d >=
    +0, so the key stays below 2^63 and orders as an unsigned one)."""
    return (d.contiguous().view(torch.int32).to(torch.int64) << 32) | (
        idx.to(torch.int64) << shift)


def _unpack(key: torch.Tensor, shift: int):
    d = (key >> 32).to(torch.int32).view(torch.float32)
    return d, ((key & 0xFFFFFFFF) >> shift).to(torch.int32)


def _grid(rng, b, n, c=3, scale=8):
    return (rng.integers(0, scale, (b, n, c)) / scale).astype(np.float32)


@pytest.mark.parametrize("shift", [0, 1], ids=["k5", "k8"])
def test_keys_pack_unpack_and_order_at_the_edges(shift):
    d = torch.tensor([0.0, 1e-45, 1e-40, 1.1754944e-38, 0.25, 1.0, 4.0e8,
                      6.4e9, 3.4e38, float("inf")], dtype=torch.float32)
    ids = torch.tensor([0, 1, 2**24, 2**31 - 1])
    dd = d[:, None].expand(-1, ids.numel()).reshape(-1)
    ii = ids[None, :].expand(d.numel(), -1).reshape(-1)
    key = _pack(dd, ii, shift)
    assert (key >= 0).all()  # below 2^63: signed order is unsigned order
    got_d, got_i = _unpack(key, shift)
    assert torch.equal(got_d.view(torch.int32), dd.view(torch.int32))
    assert torch.equal(got_i, ii.to(torch.int32))
    # the key order is the lexicographic (d, index) order
    rng = np.random.default_rng(0)
    perm = torch.from_numpy(rng.permutation(key.numel()))
    by_key = torch.argsort(key[perm])
    lex = np.lexsort((ii[perm].numpy(), dd[perm].numpy()))
    assert torch.equal(by_key, torch.from_numpy(lex))
    # a zero distance has the bits of +0: the key is the index alone
    p = torch.tensor([[0.5, -0.25, 0.125]])
    zero = distance_tiles.sqdist_rows(p, p)
    assert zero.view(torch.int32).item() == 0
    # the empty slots lie above every key a candidate makes
    k8_empty = (INF_BITS << 32) | 0xFFFFFFFF
    k5_start = INF_BITS << 32
    if shift:
        assert (key < k8_empty).all()
    start_d, start_i = _unpack(torch.tensor([k5_start]), 0)
    assert start_d.item() == float("inf") and start_i.item() == 0


def _list_merge(keys: torch.Tensor, cand: torch.Tensor, k_list: int):
    """The K smallest keys of (list, candidates): what a queue flush leaves
    in a list (register chain or heap) for any insert order."""
    return torch.topk(torch.cat([keys, cand], dim=1), k_list, dim=1,
                      largest=False, sorted=True).values


def _k8_emulated(q, s, k, parts, rng, group=8):
    """K8's scan on [B,Nq,C], [B,Ns,C] with the support split into
    ``parts`` contiguous parts: (d [B,Nq,k], idx int32)."""
    b, nq, _ = q.shape
    ns = s.shape[1]
    k_list = 4 if k <= 4 else 8 if k <= 8 else 16 if k <= 16 else (
        -(-k // 8) * 8)
    d_all = None
    for c in range(q.shape[-1]):  # the kernels' channel order
        dc = q[:, :, None, c] - s[:, None, :, c]
        d_all = dc * dc if d_all is None else d_all + dc * dc
    d_all = d_all.reshape(b * nq, ns)
    empty = torch.full((b * nq, k_list), (INF_BITS << 32) | 0xFFFFFFFF,
                       dtype=torch.int64)
    part_len = -(-ns // parts)
    lists = []
    for p in range(parts):
        lo, hi = p * part_len, min(ns, (p + 1) * part_len)
        keys = empty.clone()
        worst = torch.full((b * nq,), float("inf"))
        starts = list(range(lo, hi, group))
        rng.shuffle(starts)  # arrival order: any
        for g, start in enumerate(starts):
            cols = torch.arange(start, min(start + group, hi))
            d = d_all[:, cols]
            ok = d <= worst[:, None]  # the float test against a stale worst
            cand = torch.where(ok, _pack(d, cols.expand_as(d), 1),
                               torch.iinfo(torch.int64).max)
            keys = _list_merge(keys, cand, k_list)
            if rng.uniform() < 0.5:  # a flush refreshes the worst
                worst = _unpack(keys[:, -1], 1)[0]
        lists.append(keys)
    order = rng.permutation(parts)  # parts merge by key, in any order
    merged = lists[order[0]]
    for p in order[1:]:
        merged = _list_merge(merged, lists[p], k_list)
    d, i = _unpack(merged[:, :k], 1)
    return d.reshape(b, nq, k), i.reshape(b, nq, k)


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 3, 8, 16, 17, 40])
def test_k8_split_support_merge_equals_plain_and_reference(k, parts):
    rng = np.random.default_rng(100 + k + parts)
    q, s = _grid(rng, 2, 40), _grid(rng, 2, 300)
    # duplicates across every part boundary: equal distances in two parts
    part_len = -(-300 // parts)
    for p in range(1, parts):
        s[:, p * part_len : p * part_len + 4] = s[:, 0:4]
    got = _k8_emulated(torch.from_numpy(q), torch.from_numpy(s), k, parts,
                       rng)
    plain = topk_scan.knn_torch(torch.from_numpy(q), torch.from_numpy(s), k)
    for g, r in zip(got, plain):
        assert torch.equal(g, r)
    ref = jax_topk.knn(jnp.asarray(q), jnp.asarray(s), k, sorted_ok=False)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    # ties do straddle the k-th place
    d_next = topk_scan.knn_torch(torch.from_numpy(q), torch.from_numpy(s),
                                 k + 1)[0]
    assert (d_next[..., k - 1] == d_next[..., k]).any()


def test_k8_split_support_merge_any_channels():
    # C != 3: the same lists over the all-channel distance
    rng = np.random.default_rng(7)
    q, s = _grid(rng, 2, 33, c=5, scale=4), _grid(rng, 2, 257, c=5, scale=4)
    got = _k8_emulated(torch.from_numpy(q), torch.from_numpy(s), 17, 4, rng)
    plain = topk_scan.knn_torch(torch.from_numpy(q), torch.from_numpy(s), 17)
    for g, r in zip(got, plain):
        assert torch.equal(g, r)


def _k5_emulated(p, q, tn, tm, rng):
    """K5's one pass over ragged clouds [B,N,3], [B,M,3] in tiles of tn x
    tm, pairs in shuffled order, merged by key minimum from (inf, 0)."""
    b, n, _ = p.shape
    m = q.shape[1]
    pkeys = torch.full((b, n), INF_BITS << 32, dtype=torch.int64)
    qkeys = torch.full((b, m), INF_BITS << 32, dtype=torch.int64)
    pairs = [(i, j) for i in range(0, n, tn) for j in range(0, m, tm)]
    rng.shuffle(pairs)
    for i, j in pairs:
        pi, qj = p[:, i : i + tn], q[:, j : j + tm]
        d = torch.stack([distance_tiles.sqdist_rows(pi[c], qj[c])
                         for c in range(b)])  # [B, rows, cols]
        rows = torch.arange(i, i + pi.shape[1])
        cols = torch.arange(j, j + qj.shape[1])
        row_key = _pack(d, cols.expand_as(d), 0).amin(dim=2)
        col_key = _pack(d, rows[:, None].expand_as(d), 0).amin(dim=1)
        pkeys[:, rows] = torch.minimum(pkeys[:, rows], row_key)
        qkeys[:, cols] = torch.minimum(qkeys[:, cols], col_key)
    return (*_unpack(pkeys, 0), *_unpack(qkeys, 0))


@pytest.mark.parametrize("kind", ["grid", "poisoned"])
@pytest.mark.parametrize("tiles", [(64, 40), (128, 1000), (1000, 96)],
                         ids=["small", "q_whole", "p_whole"])
def test_k5_tile_pair_merge_equals_plain_and_reference(tiles, kind):
    rng = np.random.default_rng(200)
    p, q = _grid(rng, 2, 301), _grid(rng, 2, 517)
    if kind == "poisoned":  # the 1e9-scale distances of masked points
        p[:, 250:, 0] = 2.0e4 + 4.0 * np.arange(51)
        q[:, 400:, 0] = -2.0e4 - 4.0 * np.arange(117)
    got = _k5_emulated(torch.from_numpy(p), torch.from_numpy(q), *tiles, rng)
    plain = (*distance_tiles.nn_one_direction_torch(torch.from_numpy(p),
                                                    torch.from_numpy(q)),
             *distance_tiles.nn_one_direction_torch(torch.from_numpy(q),
                                                    torch.from_numpy(p)))
    for g, r in zip(got, plain):
        assert g.dtype == r.dtype and torch.equal(g, r)
    # the reference in interpret mode: bitwise wherever its distances are
    # exact (a poisoned point's 1e9-scale distances round, and XLA's CPU
    # backend contracts some of those multiply-adds), so on the poisoned
    # clouds the valid rows
    ref = jax_dt.nn_both_directions(jnp.asarray(p), jnp.asarray(q))
    n_p, n_q = (250, 400) if kind == "poisoned" else (None, None)
    valid = (slice(n_p), slice(n_p), slice(n_q), slice(n_q))
    for g, r, rows in zip(got, ref, valid):
        np.testing.assert_array_equal(g.numpy()[:, rows],
                                      np.asarray(r)[:, rows])
