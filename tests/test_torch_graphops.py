"""``lazzaro_tpu_torch.ops.graphops`` and the index's consolidation reads
against the JAX package on shared seeded inputs.

- ``pairwise_merge_candidates`` (the plain version a CPU arena runs): rows
  ``top_j`` equal to ``lazzaro_tpu.ops.graphops.pairwise_merge_candidates``;
  scores within 1e-6 where ``top_j >= 0`` (f32 sums in another order). A slot
  with ``top_j = -1`` holds ``NEG_INF`` in the port, where JAX keeps the
  below-threshold score it ranked there: pinned below.
- ``connected_components``: labels equal; ``component_stats``: counts equal,
  weight sums within 1e-6.
- ``MemoryIndex.merge_candidates`` / ``components``: the triples and the
  groups equal to the JAX index's after the same adds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lazzaro_tpu.core.index import MemoryIndex as JaxIndex
from lazzaro_tpu.ops import graphops as jg
from lazzaro_tpu_torch.core.index import MemoryIndex as TorchIndex
from lazzaro_tpu_torch.ops import graphops as tg
from lazzaro_tpu_torch.ops.topk import NEG_INF

THRESHOLD = 0.95


def planted_arena(seed, n=1300, d=32):
    """An awkward-size arena (not a chunk multiple, crossing the 512-row
    chunk) of random unit rows with planted near-duplicates whose sums are
    exact in any order: three identical rows, a group of seven (a base and
    six rows that each move one entry of it) across a chunk boundary, and
    the same group's copies on dead, super and other-tenant rows. Returns
    ``(emb f32, mask, group rows)``: the mask is tenant 0's live non-super
    rows."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    base = np.zeros(d, np.float32)
    base[:16] = 0.25
    triple = np.zeros(d, np.float32)
    triple[[3, 9, 17, 30]] = 0.5
    for r in (7, 300, 1299):
        emb[r] = triple
    group = [40, 200, 511, 512, 513, 900, 1200]
    emb[group[0]] = base
    for m, r in enumerate(group[1:], start=1):
        emb[r] = base
        emb[r, m] -= m / 64
    tenant = (rng.random(n) < 0.3).astype(np.int32)      # 1: the other tenant
    alive = rng.random(n) > 0.05
    is_super = np.zeros(n, bool)
    tenant[[7, 300, 1299] + group] = 0
    alive[[7, 300, 1299] + group] = True
    for r, (t, a, s) in zip((60, 61, 62), ((0, False, False), (0, True, True),
                                           (1, True, False))):
        emb[r] = base                  # a dead, a super, another tenant's copy
        tenant[r], alive[r], is_super[r] = t, a, s
    mask = alive & (tenant == 0) & ~is_super
    return emb, mask, group


def jax_pairs(emb, mask, dtype):
    ts, tj = jg.pairwise_merge_candidates(jnp.asarray(emb).astype(dtype),
                                          jnp.asarray(mask),
                                          jnp.float32(THRESHOLD), k=4)
    return np.asarray(ts), np.asarray(tj)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pairwise_plain_matches_jax(dtype):
    emb, mask, group = planted_arena(0)
    js, jj = jax_pairs(emb, mask, getattr(jnp, dtype))
    t_emb = torch.from_numpy(emb).to(getattr(torch, dtype))
    ts, tj = tg.pairwise_merge_candidates(t_emb, torch.from_numpy(mask),
                                          THRESHOLD, k=4)
    ts, tj = ts.numpy(), tj.numpy()
    np.testing.assert_array_equal(tj, jj)
    hit = tj >= 0
    np.testing.assert_allclose(ts[hit], js[hit], rtol=0, atol=1e-6)
    # The fixture exercises what it claims: a full list, the triple's tie
    # order, and no pair of a masked row.
    assert (tj[group[0]] >= 0).all()
    assert tj[7].tolist() == [300, 1299, -1, -1]
    assert tj[300].tolist() == [1299, -1, -1, -1]
    assert not np.isin(tj, np.nonzero(~mask)[0]).any()
    assert (tj[~mask] == -1).all()
    # No score sits near the threshold, so the verdicts rest on no rounding.
    full = emb @ emb.T
    assert not (np.abs(full - THRESHOLD) < 1e-3).any()


def test_pairwise_empty_slots_hold_neg_inf_where_jax_holds_scores():
    """The one documented difference: a ``-1`` slot holds ``NEG_INF`` in the
    port, the ranked below-threshold score (or ``-inf``) in JAX."""
    emb, mask, _ = planted_arena(1)
    js, jj = jax_pairs(emb, mask, jnp.float32)
    ts, tj = tg.pairwise_merge_candidates(torch.from_numpy(emb),
                                          torch.from_numpy(mask), THRESHOLD)
    ts, tj = ts.numpy(), tj.numpy()
    empty = tj < 0
    assert (ts[empty] == np.float32(NEG_INF)).all()
    below = empty & np.isfinite(js)
    assert below.any() and (js[below] <= THRESHOLD).all()
    assert (js[below] > NEG_INF).all()


def _naive_pairs(emb, mask, threshold, k):
    scores = emb @ emb.T
    out = set()
    for i in range(emb.shape[0]):
        if not mask[i]:
            continue
        cand = [(scores[i, j], j) for j in range(i + 1, emb.shape[0])
                if mask[j] and scores[i, j] > threshold]
        for _, j in sorted(cand, reverse=True)[:k]:
            out.add((i, j))
    return out


def test_chunked_matches_naive_oracle():
    """``tests/test_merge_scale.py::test_chunked_matches_naive_oracle`` on
    the port's plain version."""
    rng = np.random.default_rng(0)
    n, d = 1500, 24
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for a, b in [(3, 700), (511, 512), (1023, 1499), (100, 101)]:
        emb[b] = emb[a]
    mask = np.ones(n, bool)
    mask[100] = False
    _, tj = tg.pairwise_merge_candidates(torch.from_numpy(emb),
                                         torch.from_numpy(mask), 0.95, k=4)
    got = {(i, int(j)) for i in range(n) for j in tj[i].tolist() if j >= 0}
    assert got == _naive_pairs(emb, mask, 0.95, k=4)
    assert (3, 700) in got and (511, 512) in got and (1023, 1499) in got
    assert all(100 not in p for p in got)


@pytest.mark.slow
def test_merge_candidates_100k_rows():
    """``tests/test_merge_scale.py::test_merge_candidates_100k_rows`` on the
    port's index (slow, as the JAX file marks it)."""
    rng = np.random.default_rng(1)
    n, d = 100_000, 32
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    planted = [(10, 99_000), (4_095, 4_096), (50_000, 50_001)]
    for a, b in planted:
        emb[b] = emb[a]
    idx = TorchIndex(dim=d, capacity=n + 8, device="cpu")
    ids = [f"m{i}" for i in range(n)]
    step = 20_000
    for s in range(0, n, step):
        sl = slice(s, s + step)
        idx.add(ids[sl], emb[sl], [0.5] * step, [1000.0] * step,
                ["semantic"] * step, ["default"] * step, "u1")
    pairs = idx.merge_candidates("u1", threshold=0.98)
    got = {tuple(sorted((a, b))) for a, b, _ in pairs}
    want = {tuple(sorted((f"m{a}", f"m{b}"))) for a, b in planted}
    assert got == want
    for _, _, sim in pairs:
        assert sim == pytest.approx(1.0, abs=5e-3)


def test_pairwise_cpu_tensor_runs_the_plain_version(monkeypatch):
    """A CPU arena never reaches the kernel, and counts no launch."""
    def refuse(*a, **kw):
        raise AssertionError("the kernel must not launch for a CPU tensor")

    monkeypatch.setattr(tg, "_launch", refuse)
    emb, mask, _ = planted_arena(2)
    before = (tg.launches, tg.launches_wgmma)
    got = tg.pairwise_merge_candidates(torch.from_numpy(emb),
                                       torch.from_numpy(mask), THRESHOLD)
    want = tg.pairwise_merge_candidates_reference(torch.from_numpy(emb),
                                                  torch.from_numpy(mask),
                                                  THRESHOLD)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tg.launches, tg.launches_wgmma) == before
    assert tg.route_for(torch.bfloat16) == "wgmma"
    assert tg.route_for(torch.float32) == "fma"


# ------------------------------------------------------------ components
def random_graph(seed, n=200, e=300):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    tgt = rng.integers(0, n, e).astype(np.int32)
    alive = rng.random(e) > 0.2
    src[~alive & (rng.random(e) > 0.5)] = -1          # dead edges may hold -1
    weight = rng.random(e).astype(np.float32)
    node_alive = rng.random(n) > 0.1
    return src, tgt, alive, weight, node_alive


@pytest.mark.parametrize("seed,min_weight", [(0, 0.0), (1, 0.0), (2, 0.4),
                                             (3, 0.8)])
def test_connected_components_and_stats_match_jax(seed, min_weight):
    src, tgt, alive, weight, node_alive = random_graph(seed)
    n = node_alive.shape[0]
    jl = np.asarray(jg.connected_components(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(alive),
        jnp.asarray(node_alive), n, jnp.float32(min_weight),
        jnp.asarray(weight)))
    tl = tg.connected_components(
        torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(alive),
        torch.from_numpy(node_alive), n, min_weight, torch.from_numpy(weight))
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert len(set(jl[jl >= 0].tolist())) > 1        # several components
    jstats = jg.component_stats(jnp.asarray(jl), jnp.asarray(src),
                                jnp.asarray(tgt), jnp.asarray(alive),
                                jnp.asarray(weight))
    tstats = tg.component_stats(tl, torch.from_numpy(src), torch.from_numpy(tgt),
                                torch.from_numpy(alive), torch.from_numpy(weight))
    np.testing.assert_array_equal(tstats[0].numpy(), np.asarray(jstats[0]))
    np.testing.assert_array_equal(tstats[1].numpy(), np.asarray(jstats[1]))
    np.testing.assert_allclose(tstats[2].numpy(), np.asarray(jstats[2]),
                               rtol=0, atol=1e-5)


# ----------------------------------------------------------------- index
def basis(dim, i):
    v = np.zeros(dim, np.float32)
    v[i] = 1.0
    return v


def both_indexes(**kw):
    return (JaxIndex(dim=8, capacity=16, edge_capacity=32, epoch=1000.0, **kw),
            TorchIndex(dim=8, capacity=16, edge_capacity=32, epoch=1000.0,
                       device="cpu", **kw))


def test_merge_candidates_all_pairs():
    """``tests/test_index.py::test_merge_candidates_all_pairs`` on both
    indexes: the triples are equal."""
    got = []
    for idx in both_indexes():
        dup = basis(8, 3)
        embs = np.stack([dup, dup, dup, basis(8, 6)])
        idx.add(["d1", "d2", "d3", "x"], embs, [0.5] * 4, [1000.0] * 4,
                ["semantic"] * 4, ["default"] * 4, "u1")
        pairs = idx.merge_candidates("u1", threshold=0.95)
        merge_ids = {(a, b) for a, b, _ in pairs}
        assert ("d1", "d2") in merge_ids or ("d2", "d1") in merge_ids
        assert all("x" not in p[:2] for p in pairs)
        got.append(pairs)
    assert got[1] == got[0]


def test_merge_candidates_equal_jax_index_after_the_same_adds():
    """Two tenants, a super row and a deleted row: the port's triples equal
    the JAX index's (ids, order; sims within 1e-6)."""
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((24, 8)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows[5] = rows[2]
    rows[9] = rows[2]
    rows[11] = rows[2]
    rows[17] = rows[2]              # the other tenant's copy
    rows[20] = rows[2]              # a super node's copy
    rows[21] = rows[2]              # deleted below
    rows[14] = rows[13]
    got = []
    for idx in both_indexes():
        ids = [f"n{i}" for i in range(24)]
        tenant = ["u2" if i in (16, 17, 18) else "u1" for i in range(24)]
        for i in range(24):
            idx.add([ids[i]], rows[i:i + 1], [0.5], [1000.0], ["semantic"],
                    ["default"], tenant[i], [i == 20])
        idx.delete(["n21"])
        got.append(idx.merge_candidates("u1", threshold=0.95))
        assert idx.merge_candidates("nobody") == []
    (jp, tp) = got
    assert [(a, b) for a, b, _ in tp] == [(a, b) for a, b, _ in jp]
    np.testing.assert_allclose([s for _, _, s in tp], [s for _, _, s in jp],
                               rtol=0, atol=1e-6)
    assert ("n2", "n5") in {(a, b) for a, b, _ in tp}
    assert not {"n17", "n20", "n21"} & {x for p in tp for x in p[:2]}


def test_components():
    """``tests/test_index.py::test_components`` on both indexes: the groups
    are equal."""
    got = []
    for idx in both_indexes():
        ids = [f"n{i}" for i in range(4)]
        idx.add(ids, np.stack([basis(8, i) for i in range(4)]), [0.5] * 4,
                [1000.0] * 4, ["semantic"] * 4, ["default"] * 4, "u1")
        idx.add_edges([("n0", "n1", 0.8), ("n2", "n3", 0.8)], "u1")
        comps = sorted([sorted(c) for c in idx.components()])
        assert ["n0", "n1"] in comps and ["n2", "n3"] in comps
        got.append(comps)
    assert got[1] == got[0]


def test_merge_candidates_under_a_mesh_raises():
    from lazzaro_tpu_torch.parallel import make_mesh

    idx = TorchIndex(8, device="cpu", mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 21"):
        idx.merge_candidates("u1")
