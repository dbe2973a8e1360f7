"""Parity of ``lazzaro_tpu_torch.core.state`` with ``lazzaro_tpu.core.state``:
each ported function runs on the same arena (numpy, fixed seed) in both
packages and every column is compared.

Tolerances: integer and bool columns, row indices and slot lists must be
equal; f32 columns agree within 1e-6 (one f32 rounding may differ where XLA
fuses a multiply-add, and norms sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lazzaro_tpu.core import state as JS
from lazzaro_tpu.core.memory_system import MemorySystem as JaxMemorySystem
from lazzaro_tpu_torch.core import state as TS

CAP = 63          # 64 rows with the sentinel
DIM = 16
ECAP = 31
ATOL = 1e-6


def arena_cols(seed=0):
    rng = np.random.default_rng(seed)
    n = CAP + 1
    emb = rng.standard_normal((n, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return {
        "emb": emb,
        "salience": rng.random(n).astype(np.float32),
        "timestamp": (rng.random(n) * 100).astype(np.float32),
        "last_accessed": (rng.random(n) * 1e6).astype(np.float32),
        "access_count": rng.integers(0, 20, n).astype(np.int32),
        "type_id": rng.integers(0, 3, n).astype(np.int32),
        "shard_id": rng.integers(0, 3, n).astype(np.int32),
        "tenant_id": rng.integers(0, 2, n).astype(np.int32),
        "alive": rng.random(n) > 0.2,
        "is_super": rng.random(n) < 0.15,
    }


def edge_cols(seed=0):
    rng = np.random.default_rng(seed + 1)
    n = ECAP + 1
    return {
        "src": rng.integers(0, CAP, n).astype(np.int32),
        "tgt": rng.integers(0, CAP, n).astype(np.int32),
        "weight": rng.random(n).astype(np.float32),
        "co": rng.integers(1, 5, n).astype(np.int32),
        "last_updated": rng.random(n).astype(np.float32),
        "alive": rng.random(n) > 0.3,
        "tenant_id": rng.integers(0, 2, n).astype(np.int32),
    }


def both_arenas(seed=0):
    c = arena_cols(seed)
    return (JS.ArenaState(**{k: jnp.asarray(v) for k, v in c.items()}),
            TS.arena_from_numpy(c, "cpu"))


def both_edges(seed=0):
    c = edge_cols(seed)
    return (JS.EdgeState(**{k: jnp.asarray(v) for k, v in c.items()}),
            TS.edges_from_numpy(c, "cpu"))


def assert_same(jstate, tstate, names):
    for name in names:
        a = np.asarray(getattr(jstate, name))
        b = getattr(tstate, name).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def rows(*r):
    return JS.pad_rows(np.asarray(r, np.int32), CAP)


def test_pad_rows_buckets():
    for n in (0, 1, 7, 9, 4096, 4097, 5000):
        r = np.arange(n, dtype=np.int32)
        np.testing.assert_array_equal(TS.pad_rows(r, 99), JS.pad_rows(r, 99))


def test_add():
    ja, ta = both_arenas()
    rng = np.random.default_rng(3)
    r = rows(3, 10, 62)
    b = len(r)
    emb = rng.standard_normal((b, DIM)).astype(np.float32)
    sal = rng.random(b).astype(np.float32)
    ts = rng.random(b).astype(np.float32)
    ty = np.full(b, 2, np.int32)
    sh = np.full(b, 1, np.int32)
    te = np.full(b, 1, np.int32)
    sup = np.array([True, False, True] + [False] * (b - 3))
    args = (r, emb, sal, ts, ty, sh, te, sup)
    ja = JS.arena_add_copy(ja, *map(jnp.asarray, args))
    TS._arena_add(ta, *args)
    assert_same(ja, ta, TS.ARENA_FIELDS)


def test_delete_and_flags():
    ja, ta = both_arenas(1)
    r = rows(0, 5, 6)
    ja = JS.arena_delete_copy(ja, jnp.asarray(r))
    TS._arena_delete(ta, r)
    vals = np.linspace(0, 1, len(r)).astype(np.float32)
    ja = JS.arena_set_salience_copy(ja, jnp.asarray(r), jnp.asarray(vals))
    TS._arena_set_salience(ta, r, vals)
    flags = np.arange(len(r)) % 2 == 0
    ja = JS.arena_set_parentage_copy(ja, jnp.asarray(r), jnp.asarray(flags))
    TS._arena_set_parentage(ta, r, flags)
    assert_same(ja, ta, TS.ARENA_FIELDS)


def test_access_boost_merge():
    ja, ta = both_arenas(2)
    r = rows(1, 2, 40)
    ja = JS.arena_update_access_copy(ja, jnp.asarray(r), jnp.float32(12.5),
                                     jnp.float32(0.05))
    TS._arena_update_access(ta, r, 12.5, 0.05)
    ja = JS.arena_boost_copy(ja, jnp.asarray(r), jnp.float32(13.0),
                             jnp.float32(0.02))
    TS._arena_boost(ta, r, 13.0, 0.02)
    cand = np.linspace(0.1, 0.99, len(r)).astype(np.float32)
    ja = JS.arena_merge_touch_copy(ja, jnp.asarray(r), jnp.asarray(cand),
                                   jnp.float32(14.0))
    TS._arena_merge_touch(ta, r, cand, 14.0)
    assert_same(ja, ta, TS.ARENA_FIELDS)


def test_apply_boosts():
    ja, ta = both_arenas(4)
    r = rows(7, 8, 9)
    acc = np.array([1, 0, 3] + [0] * (len(r) - 3), np.int32)
    nbr = np.array([0, 2, 1] + [0] * (len(r) - 3), np.int32)
    now = np.array([5.0, 6.0, 7.0] + [-1e30] * (len(r) - 3), np.float32)
    ja = JS.arena_apply_boosts_copy(ja, *map(jnp.asarray, (r, acc, nbr, now)),
                                    jnp.float32(0.05), jnp.float32(0.02))
    TS._arena_apply_boosts(ta, r, acc, nbr, now, 0.05, 0.02)
    assert_same(ja, ta, TS.ARENA_FIELDS)


@pytest.mark.parametrize("tenant", [0, 1])
def test_decay_fused(tenant):
    (ja, ta), (je, te) = both_arenas(5), both_edges(5)
    ja, je = JS.decay_fused_copy(ja, je, jnp.int32(tenant), jnp.float32(0.01),
                                 jnp.float32(0.2))
    TS._decay_fused(ta, te, tenant, 0.01, 0.2)
    assert_same(ja, ta, TS.ARENA_FIELDS)
    assert_same(je, te, TS.EDGE_FIELDS)


DECAY_ROWS = 131_072


@pytest.mark.parametrize("rate,floor", [(0.05, 0.2), (0.01, 0.2),
                                        (0.013, 0.1), (0.3, 0.05)])
def test_decay_salience_bits_equal_jax(rate, floor):
    """The decay of 131,072 saliences, half of them in the tenant, over
    three passes: every salience bit equal to the JAX package's compiled
    decay (one fused multiply-add, one rounding) and to the reload's replay
    of the missed passes; the edge weights too."""
    rng = np.random.default_rng(17)
    n = DECAY_ROWS
    sal = rng.uniform(floor, 1.0, n).astype(np.float32)
    sal[:64] = np.float32(floor)                  # at the floor already
    tenant = (rng.random(n) < 0.5).astype(np.int32)
    alive = rng.random(n) > 0.1
    weight = rng.random(n).astype(np.float32)
    cols = {"emb": np.zeros((n, 1), np.float32), "salience": sal,
            "timestamp": np.zeros(n, np.float32),
            "last_accessed": np.zeros(n, np.float32),
            "access_count": np.zeros(n, np.int32),
            "type_id": np.zeros(n, np.int32), "shard_id": np.zeros(n, np.int32),
            "tenant_id": tenant, "alive": alive,
            "is_super": np.zeros(n, bool)}
    ecols = {"src": np.zeros(n, np.int32), "tgt": np.zeros(n, np.int32),
             "weight": weight, "co": np.ones(n, np.int32),
             "last_updated": np.zeros(n, np.float32), "tenant_id": tenant,
             "alive": alive}
    ja = JS.ArenaState(**{k: jnp.asarray(v) for k, v in cols.items()})
    je = JS.EdgeState(**{k: jnp.asarray(v) for k, v in ecols.items()})
    ta, te = TS.arena_from_numpy(cols, "cpu"), TS.edges_from_numpy(ecols, "cpu")
    for _ in range(3):
        ja, je = JS.decay_fused_copy(ja, je, jnp.int32(1), jnp.float32(rate),
                                     jnp.float32(floor))
        TS._decay_fused(ta, te, 1, rate, floor)
    want = np.asarray(ja.salience)
    got = ta.salience.numpy()
    assert (got.view(np.int32) != want.view(np.int32)).sum() == 0
    assert np.array_equal(ta.salience.view(torch.int32).numpy(),
                          want.view(np.int32))
    live = alive & (tenant == 1)
    replay = JaxMemorySystem._replay_node_decay(
        sal, np.where(live, 3, 0), rate, floor)
    assert np.array_equal(replay.view(np.int32), got.view(np.int32))
    assert np.array_equal(te.weight.numpy().view(np.int32),
                          np.asarray(je.weight).view(np.int32))
    assert np.array_equal(
        JaxMemorySystem._replay_edge_decay(weight, np.where(live, 3, 0), rate)
        .view(np.int32), te.weight.numpy().view(np.int32))


@pytest.mark.parametrize("modes", [(1, 0), (-1,), (0,)])
def test_link_candidates(modes):
    ja, ta = both_arenas(6)
    new = rows(1, 4, 9, 33)
    got_j = JS.arena_link_candidates_multi(ja, jnp.asarray(new), jnp.asarray(new),
                                           jnp.int32(1), 3, modes)
    got_t = TS.arena_link_candidates_multi(ta, new, new, 1, 3, modes)
    assert len(got_t) == 2 * len(modes)
    for i in range(0, len(got_j), 2):
        np.testing.assert_allclose(got_t[i].numpy(), np.asarray(got_j[i]),
                                   rtol=0, atol=ATOL)
        np.testing.assert_array_equal(got_t[i + 1].numpy(), np.asarray(got_j[i + 1]))


def test_importance_and_evict_candidates():
    ja, ta = both_arenas(7)
    w = (0.5, 0.3, 0.2)
    imp_j = JS.arena_importance(ja, jnp.float32(2e6), *map(jnp.float32, w))
    imp_t = TS.arena_importance(ta, 2e6, *w)
    np.testing.assert_allclose(imp_t.numpy(), np.asarray(imp_j), rtol=0, atol=ATOL)
    for tenant in (0, 1):
        sj, rj = JS.arena_evict_candidates(ja, jnp.int32(tenant), jnp.float32(2e6),
                                           *map(jnp.float32, w), 8)
        st, rt = TS.arena_evict_candidates(ta, tenant, 2e6, *w, 8)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def test_importance_ties_rank_by_row():
    """Equal importance (same salience, access and age) ranks by row in
    both, the order eviction relies on."""
    c = arena_cols(8)
    c["salience"][:] = 0.5
    c["access_count"][:] = 2
    c["last_accessed"][:] = 0.0
    ja = JS.ArenaState(**{k: jnp.asarray(v) for k, v in c.items()})
    ta = TS.arena_from_numpy(c, "cpu")
    _, rj = JS.arena_evict_candidates(ja, jnp.int32(0), jnp.float32(0.0),
                                      *map(jnp.float32, (0.5, 0.3, 0.2)), 16)
    _, rt = TS.arena_evict_candidates(ta, 0, 0.0, 0.5, 0.3, 0.2, 16)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def test_mean_embedding():
    ja, ta = both_arenas(9)
    r = rows(2, 3, 5, 8, 13)
    np.testing.assert_allclose(TS.arena_mean_embedding(ta, r).numpy(),
                               np.asarray(JS.arena_mean_embedding(ja, jnp.asarray(r))),
                               rtol=0, atol=ATOL)


def test_edges_add_reinforce_decay_prune():
    je, te = both_edges(10)
    slots = JS.pad_rows(np.array([3, 4, 20], np.int32), ECAP)
    b = len(slots)
    src = np.array([1, 2, 3] + [-1] * (b - 3), np.int32)
    tgt = np.array([4, 5, 6] + [-1] * (b - 3), np.int32)
    w = np.array([0.3, 1.4, 0.7] + [0.0] * (b - 3), np.float32)
    co = np.ones(b, np.int32)
    live = np.arange(b) < 3
    je = JS.edges_add_copy(je, *map(jnp.asarray, (slots, src, tgt, w, co)),
                           jnp.float32(9.0), jnp.int32(1), jnp.asarray(live))
    TS._edges_add(te, slots, src, tgt, w, co, 9.0, 1, live)
    assert_same(je, te, TS.EDGE_FIELDS)
    je = JS.edges_reinforce_copy(je, jnp.asarray(slots), jnp.float32(0.1),
                                 jnp.float32(10.0))
    TS._edges_reinforce(te, slots, 0.1, 10.0)
    assert_same(je, te, TS.EDGE_FIELDS)
    je = JS.edges_decay_copy(je, jnp.int32(1), jnp.float32(0.01))
    TS._edges_decay(te, 1, 0.01)
    assert_same(je, te, TS.EDGE_FIELDS)
    for cap in (4, 64):
        je2, sj = JS.edges_prune_copy(je, jnp.int32(1), jnp.float32(0.5),
                                      prune_cap=cap)
        te2 = TS.edges_from_numpy({f: getattr(te, f).numpy() for f in TS.EDGE_FIELDS},
                                  "cpu")
        te2, st = TS._edges_prune(te2, 1, 0.5, cap)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert_same(je2, te2, TS.EDGE_FIELDS)


def test_edges_delete_for_nodes():
    je, te = both_edges(11)
    r = rows(1, 2, 3, 4, 5)
    je = JS.edges_delete_for_nodes_copy(je, jnp.asarray(r))
    TS._edges_delete_for_nodes(te, r)
    assert_same(je, te, TS.EDGE_FIELDS)


def test_grow_arena_and_edges():
    (ja, ta), (je, te) = both_arenas(12), both_edges(12)
    assert_same(JS.grow_arena(ja, 127), TS.grow_arena(ta, 127), TS.ARENA_FIELDS)
    assert_same(JS.grow_edges(je, 63), TS.grow_edges(te, 63), TS.EDGE_FIELDS)


def test_normalize():
    x = np.random.default_rng(13).standard_normal((5, DIM)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(TS.normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(JS.normalize(jnp.asarray(x))),
                               rtol=0, atol=ATOL)


def test_best_earlier_match_matches_the_host_gram():
    """The device intra-batch duplicate scan against the JAX package's numpy
    formula (``memory_system.py:1462-1474``): same columns, cosines within
    1e-6, exact repeats found, a zero row and row 0 handled alike."""
    rng = np.random.default_rng(12)
    m = rng.standard_normal((40, DIM)).astype(np.float32)
    m[17] = m[3]                       # exact repeat of an earlier row
    m[25] = 2.0 * m[9]                 # same direction, other norm
    m[30] = 0.0                        # zero row
    norms = np.linalg.norm(m, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    mn = m / norms
    tril = np.where(np.tri(40, k=-1, dtype=bool), mn @ mn.T, -np.inf)
    ref_col = np.argmax(tril, axis=1)
    ref_sim = tril[np.arange(40), ref_col]
    cols, sims = TS.best_earlier_match(torch.from_numpy(m))
    np.testing.assert_array_equal(cols.numpy(), ref_col)
    np.testing.assert_allclose(sims.numpy(), ref_sim, rtol=0, atol=ATOL)
    assert cols[17] == 3 and cols[25] == 9 and sims[0] == -np.inf
