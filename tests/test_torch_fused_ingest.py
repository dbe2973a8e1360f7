"""The fused ingest of the port (``ingest_fused`` / ``ingest_dedup_fused``,
the JAX defaults) against ``lazzaro_tpu`` on the CPU.

Function parity: ``state.ingest_dedup_fused`` and ``state.ingest_fused`` run
on the same numpy arena and fact batch (a fixed seed) in both packages,
leaf for leaf, then every arena and edge column; ``_dedup_resolve`` and
``_gated_link_insert`` on their own. Then port versions of
``tests/test_fused_ingest.py`` (one dispatch and one readback per
conversation, fused equals classic, reclaimed slots, the coalescer, the
pool-hint overflow retry) and the scripted dialogue of
``tests/test_torch_memory_system.py`` under the fused ingest against the JAX
system.

Tolerances: verdicts, rows, edge slots, positions, counters, integer and
bool columns are equal; scores and f32 columns agree within 1e-6 (f32 sums
in another order than XLA's).
"""

import json
import tempfile

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lazzaro_tpu.core import state as JS
from lazzaro_tpu_torch import MemoryConfig, MemoryIndex, MemorySystem
from lazzaro_tpu_torch.core import index as TI
from lazzaro_tpu_torch.core import state as TS
from lazzaro_tpu_torch.ops import dedup_resolve as dr
from lazzaro_tpu_torch.ops import ingest_topk as it
from lazzaro_tpu_torch.ops import masked_topk as mt
from lazzaro_tpu_torch.utils.batching import IngestCoalescer
from tests.test_torch_memory_system import (CLASSIC, JaxConfig, JaxEmbedder,
                                            JaxLLM, JaxSystem, TorchConfig,
                                            TorchEmbedder, TorchLLM,
                                            TorchSystem,
                                            assert_same_ranking,
                                            assert_snapshots_match, run,
                                            t_ranked)

CAP = 255             # 256 rows with the sentinel
ECAP = 511
DIM = 16
ATOL = 1e-6
GATE = 0.95


# ------------------------------------------------------------- fixtures
def arena_cols(seed, dtype):
    """Two tenants, three shards, a few super rows; the even rows from 128
    up are free (dead) for the batch."""
    rng = np.random.default_rng(seed)
    n = CAP + 1
    emb = rng.standard_normal((n, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    alive = rng.random(n) < 0.8
    alive[128::2] = False
    alive[-1] = False
    return {
        "emb": emb.astype(dtype),
        "salience": rng.random(n).astype(np.float32),
        "timestamp": (rng.random(n) * 100).astype(np.float32),
        "last_accessed": (rng.random(n) * 100).astype(np.float32),
        "access_count": rng.integers(0, 5, n).astype(np.int32),
        "type_id": rng.integers(0, 3, n).astype(np.int32),
        "shard_id": rng.integers(0, 3, n).astype(np.int32),
        "tenant_id": np.where(alive, rng.integers(0, 2, n), -1).astype(np.int32),
        "alive": alive,
        "is_super": (rng.random(n) < 0.05) & alive,
    }


def edge_cols():
    n = ECAP + 1
    return {"src": np.full(n, -1, np.int32), "tgt": np.full(n, -1, np.int32),
            "weight": np.zeros(n, np.float32), "co": np.zeros(n, np.int32),
            "last_updated": np.zeros(n, np.float32),
            "alive": np.zeros(n, bool), "tenant_id": np.full(n, -1, np.int32)}


def both_states(seed, dtype):
    c, e = arena_cols(seed, dtype), edge_cols()
    return (JS.ArenaState(**{k: jnp.asarray(v) for k, v in c.items()}),
            JS.EdgeState(**{k: jnp.asarray(v) for k, v in e.items()}),
            TS.arena_from_numpy(c, "cpu"), TS.edges_from_numpy(e, "cpu"), c)


def fact_batch(cols, seed, n=12):
    """``n`` facts of tenant 0 (padded to 16): near neighbours of the
    tenant's rows (cos ~0.85, above the 0.5 link gate), an exact copy of an
    arena row (a probe duplicate), a fact and two near copies of it (a
    duplicate of a duplicate), one shard group whose middle fact is a
    duplicate."""
    rng = np.random.default_rng(seed)
    emb = cols["emb"].astype(np.float32)
    mine = np.nonzero(cols["alive"] & (cols["tenant_id"] == 0)
                      & ~cols["is_super"])[0]
    base = emb[rng.choice(mine, n)]
    facts = base + 0.3 * rng.standard_normal((n, DIM)).astype(np.float32)
    facts[0] = emb[mine[3]]                   # duplicate of an arena row
    facts[5] = facts[4] + 1e-3                # duplicate of fact 4
    facts[6] = facts[5] + 1e-3                # ... and of that duplicate
    rows = np.arange(128, 128 + 2 * n, 2, dtype=np.int32)
    gid = np.array([0, 1, 0, 2, 1, 1, 1, 2, 0, 1, 2, 0][:n], np.int32)
    return facts, rows, gid


def pad(x, b, fill, dt):
    out = np.full((b,), fill, dt)
    out[:len(x)] = x
    return out


def batch_arrays(cols, seed, k=3, modes=(1, 0), pool_len=None, n=12):
    facts, rows, gid = fact_batch(cols, seed, n)
    n = len(rows)
    prow = JS.pad_rows(rows, CAP)
    b = len(prow)
    emb = np.zeros((b, DIM), np.float32)
    emb[:n] = facts
    emb[n:, 0] = 1.0
    pool = list(range(100, 100 + len(modes) * b * k))
    real = len(pool) if pool_len is None else pool_len
    return dict(
        rows=prow, emb=emb,
        salience=pad(np.linspace(0.3, 0.9, n), b, 0.0, np.float32),
        timestamp=pad(np.full(n, 7.0), b, 0.0, np.float32),
        type_id=pad(np.arange(n) % 3, b, 0, np.int32),
        shard_id=pad(np.arange(n) % 3, b, -1, np.int32),
        tenant_id=pad(np.zeros(n), b, -1, np.int32),
        is_super=pad(np.zeros(n, bool), b, False, bool),
        chain_gid=pad(gid, b, -1, np.int32),
        chain_slots=pad(np.arange(20, 20 + n), b, ECAP, np.int32),
        link_pool=np.asarray(TI.link_pool_dev(pool[:real], len(pool), ECAP)),
        pool_len=real)


def assert_leaves(jouts, touts):
    assert len(jouts) == len(touts)
    for i, (j, t) in enumerate(zip(jouts, touts)):
        j = np.asarray(j)
        t = t.numpy()
        assert j.shape == t.shape, i
        if j.dtype.kind == "f":
            np.testing.assert_allclose(t, j, rtol=0, atol=ATOL, err_msg=str(i))
        else:
            np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=str(i))


def assert_columns(jstate, tstate, names):
    for name in names:
        a = np.asarray(getattr(jstate, name)).astype(np.float32) \
            if name == "emb" else np.asarray(getattr(jstate, name))
        b = getattr(tstate, name)
        b = (b.float() if name == "emb" else b).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def run_dedup_fused(ja, je, ta, te, a, k=3, modes=(1, 0)):
    """The JAX and the port dedup-fused programs on the same batch; returns
    the new JAX states and both output tuples (the port's states change in
    place)."""
    names = ("rows", "emb", "salience", "timestamp", "type_id", "shard_id",
             "tenant_id", "is_super", "chain_gid", "chain_slots", "link_pool")
    ja, je, *_, jouts = JS.ingest_dedup_fused_copy(
        ja, je, None, None, None, None, *(jnp.asarray(a[n]) for n in names),
        jnp.int32(a["pool_len"]), jnp.float32(50.0), jnp.int32(0),
        jnp.float32(GATE), jnp.float32(0.5), jnp.float32(0.5),
        jnp.float32(0.8), jnp.float32(0.0), k=k, shard_modes=modes)
    _, _, touts = TS.ingest_dedup_fused(
        ta, te, *(torch.from_numpy(np.asarray(a[n])) for n in names),
        torch.tensor(a["pool_len"], dtype=torch.int32), torch.tensor(50.0),
        0, GATE, torch.tensor(0.5), 0.5, 0.8, k=k, shard_modes=modes)
    return ja, je, jouts, touts


# ------------------------------------------------------ function parity
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("k,modes", [(3, (1, 0)), (1, (0,)), (4, (-1, 1))])
def test_ingest_dedup_fused_matches_jax(dtype, k, modes):
    """Leaf for leaf (verdicts, targets, chain sources, per-mode scores,
    candidates and pool positions, the three counters), then every arena
    and edge column."""
    ja, je, ta, te, cols = both_states(0, dtype)
    a = batch_arrays(cols, 1, k, modes)
    ja, je, jouts, touts = run_dedup_fused(ja, je, ta, te, a, k, modes)
    assert_leaves(jouts, touts)
    dup = touts[0][:, 0].numpy()
    assert dup[[0, 5, 6]].all() and dup.sum() == 3       # the crafted ones
    assert touts[1][6, 0] == touts[1][5, 0] == a["rows"][4]   # chained
    assert_columns(ja, ta, TS.ARENA_FIELDS)
    assert_columns(je, te, TS.EDGE_FIELDS)


def test_sentinel_row_stays_out_of_the_tenant_after_a_duplicate():
    """ROADMAP Queue 3: the JAX program scatters duplicate facts to the
    sentinel row, which stays alive with their tenant when no padding row
    writes after them (a batch that fills its bucket), so a scan of that
    tenant lists the sentinel and the decode drops it (k - 1 results). The
    port resets the sentinel's tenant to -1 after the scatter; every other
    row and every output leaf stay equal."""
    ja, je, ta, te, cols = both_states(0, np.float32)
    a = batch_arrays(cols, 1, n=8)
    assert len(a["rows"]) == 8                       # no padding row
    ja, je, jouts, touts = run_dedup_fused(ja, je, ta, te, a)
    assert_leaves(jouts, touts)
    assert touts[0][0, 0] == 1                       # fact 0 is a duplicate
    assert bool(ja.alive[CAP]) and int(ja.tenant_id[CAP]) == 0
    assert int(ta.tenant_id[CAP]) == -1
    for name in TS.ARENA_FIELDS:
        if name not in ("emb", "tenant_id"):
            np.testing.assert_allclose(
                getattr(ta, name).numpy(), np.asarray(getattr(ja, name)),
                rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(ta.tenant_id[:CAP].numpy(),
                                  np.asarray(ja.tenant_id)[:CAP])
    q = a["emb"][6] / np.linalg.norm(a["emb"][6])    # the last duplicate
    _, jrows = JS.arena_search(ja, jnp.asarray(q), jnp.int32(0), 3,
                               super_filter=-1)
    _, trows = TS.arena_search(ta, torch.from_numpy(q), 0, 3, super_filter=-1)
    assert CAP in np.asarray(jrows).tolist()
    assert CAP not in trows.tolist()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_ingest_fused_matches_jax(dtype):
    ja, je, ta, te, cols = both_states(2, dtype)
    a = batch_arrays(cols, 3)
    b = len(a["rows"])
    touch = JS.pad_rows(np.asarray([5, 9], np.int32), CAP)
    touch_sal = pad([0.99, 0.1], len(touch), 0.0, np.float32)
    n = 12
    c_slots = JS.pad_rows(np.arange(20, 20 + n - 1, dtype=np.int32), ECAP)
    c_src = pad(a["rows"][:n - 1], len(c_slots), -1, np.int32)
    c_tgt = pad(a["rows"][1:n], len(c_slots), -1, np.int32)
    c_w = pad(np.full(n - 1, 0.5), len(c_slots), 0.0, np.float32)
    args = [a["rows"], a["emb"], a["salience"], a["timestamp"], a["type_id"],
            a["shard_id"], a["tenant_id"], a["is_super"], touch, touch_sal,
            c_slots, c_src, c_tgt, c_w, a["link_pool"]]
    ja, je, *_, jouts = JS.ingest_fused_copy(
        ja, je, None, None, None, None, *(jnp.asarray(x) for x in args),
        jnp.int32(a["pool_len"]), jnp.float32(50.0), jnp.int32(0),
        jnp.float32(0.5), jnp.float32(0.8), jnp.float32(0.0), k=3,
        shard_modes=(1, 0))
    _, _, touts = TS.ingest_fused(
        ta, te, *(torch.from_numpy(np.asarray(x)) for x in args),
        torch.tensor(a["pool_len"], dtype=torch.int32), torch.tensor(50.0), 0,
        0.5, 0.8, k=3, shard_modes=(1, 0))
    assert b == 16
    assert_leaves(jouts, touts)
    assert int(touts[-2][0, 0]) > 0                      # links accepted
    assert_columns(ja, ta, TS.ARENA_FIELDS)
    assert_columns(je, te, TS.EDGE_FIELDS)


def test_dedup_resolve_matches_jax():
    """Duplicates of duplicates chain to the surviving node, a duplicate in
    the middle of a shard group bridges its neighbours, padding never
    matches, the probe and the gram compete; the kernel's plain version is
    the one the port runs here."""
    rng = np.random.default_rng(5)
    b, n = 16, 13
    qf = rng.standard_normal((b, DIM)).astype(np.float32)
    qf[3] = qf[1] + 1e-3          # dup of 1 (gram)
    qf[7] = qf[3] + 1e-3          # dup of the dup
    qf[n:] = 0.0
    qf[n:, 0] = 1.0               # sentinel padding: one unit vector
    qf /= np.linalg.norm(qf, axis=1, keepdims=True)
    rows = pad(np.arange(40, 40 + n), b, CAP, np.int32)
    valid = rows < CAP
    gid = pad([0, 1, 0, 1, 2, 0, 1, 1, 2, 0, 1, 2, 0], b, -1, np.int32)
    p_s = rng.uniform(-0.2, 0.9, b).astype(np.float32)
    p_s[[5, 9]] = 0.97            # probe duplicates (5 sits mid-group 0)
    p_r = rng.integers(0, 40, b).astype(np.int32)
    want = JS._dedup_resolve(jnp.asarray(qf), jnp.asarray(rows),
                             jnp.asarray(valid), jnp.asarray(gid),
                             jnp.asarray(p_s), jnp.asarray(p_r),
                             jnp.float32(GATE), CAP)
    got = TS._dedup_resolve(torch.from_numpy(qf), torch.from_numpy(rows),
                            torch.from_numpy(valid), torch.from_numpy(gid),
                            torch.from_numpy(p_s), torch.from_numpy(p_r),
                            GATE, CAP)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    target, dup, chain = (g.numpy() for g in got)
    assert list(np.nonzero(dup)[0]) == [3, 5, 7, 9]
    assert target[7] == target[3] == rows[1]
    assert chain[9 + 3] == rows[2]    # group 0: 0, 2, (5 dup), (9 dup), 12
    assert chain[6] == rows[1]        # group 1 bridges the duplicate 3


RESOLVE_B, RESOLVE_DIM = 48, 64
CHAIN = range(3, 27)                  # each fact a duplicate of the one before


def resolve_case(case):
    """``(qf, rows, valid, gid, p_s, p_r)`` of a batch of ``RESOLVE_B``
    facts for one corner of the resolve: Gaussian facts (no two within the
    gate) with the corner planted."""
    rng = np.random.default_rng(11)
    b, d = RESOLVE_B, RESOLVE_DIM
    qf = rng.standard_normal((b, d)).astype(np.float32)
    rows = np.arange(40, 40 + b, dtype=np.int32)
    gid = rng.integers(0, 4, b).astype(np.int32)
    p_s = rng.uniform(-0.2, 0.9, b).astype(np.float32)
    p_r = rng.integers(0, 40, b).astype(np.int32)
    if case in ("deep_chain", "probe_mid_chain"):
        # a step along a new axis: cos ~0.989 to the fact before, ~0.978 to
        # the one before that, so every gram arg-max is the predecessor
        u = qf[2] / np.linalg.norm(qf[2])
        for i in CHAIN:
            u = u + 0.15 * np.eye(d, dtype=np.float32)[i]
            u /= np.linalg.norm(u)
            qf[i] = u
        if case == "probe_mid_chain":
            p_s[14] = 0.999           # the probe beats the gram mid-chain
    elif case == "tied_maxima":
        qf[[1, 3, 5]] = 0.0
        qf[1, :2] = (0.98, 0.199)     # facts 1 and 3 are 0.92 apart, and
        qf[3, :2] = (0.98, -0.199)    # equally near (one f32 value) to 5
        qf[5, 0] = 1.0
    elif case == "ungrouped_live_fact":
        gid[:4] = (-1, 0, 1, 0)       # a live fact of group -1 moves group 0
    elif case == "invalid_between":
        rows[[5, 6, 20]] = CAP        # invalid facts mid-batch ...
        gid[[5, 6, 20]] = -1
        qf[21] = qf[20] + 1e-3        # ... that a later copy never matches
        qf[8] = qf[7] + 1e-3          # while a copy of a valid fact does
        p_s[[5, 20]] = 0.99           # and the probe cannot make them dups
    qf /= np.linalg.norm(qf, axis=1, keepdims=True)
    return qf, rows, rows < CAP, gid, p_s, p_r


@pytest.mark.parametrize("case", ["deep_chain", "probe_mid_chain",
                                  "tied_maxima", "ungrouped_live_fact",
                                  "invalid_between"])
def test_dedup_resolve_cases_match_jax(case):
    """The resolve's corners, the port (the gram form's plain version on
    the CPU) leaf for leaf against JAX's ``_dedup_resolve``."""
    qf, rows, valid, gid, p_s, p_r = resolve_case(case)
    want = JS._dedup_resolve(jnp.asarray(qf), jnp.asarray(rows),
                             jnp.asarray(valid), jnp.asarray(gid),
                             jnp.asarray(p_s), jnp.asarray(p_r),
                             jnp.float32(GATE), CAP)
    got = TS._dedup_resolve(*(torch.from_numpy(x) for x in (
        qf, rows, valid, gid, p_s, p_r)), GATE, CAP)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    target, dup, chain = (g.numpy() for g in got)
    qt = torch.from_numpy(qf)
    gram = TS.nt_dot(qt, qt)
    _, g_j = dr.gram_argmax_reference(gram, torch.from_numpy(valid))
    if case == "deep_chain":
        assert [int(g_j[i]) for i in CHAIN] == [i - 1 for i in CHAIN]
        assert dup[list(CHAIN)].all() and (target[list(CHAIN)] == rows[2]).all()
    elif case == "probe_mid_chain":
        assert (target[3:14] == rows[2]).all() and (target[14:27] == p_r[14]).all()
    elif case == "tied_maxima":
        assert gram[5, 1] == gram[5, 3] and gram[5, 1] > GATE
        assert int(g_j[5]) == 1 and dup[5] and target[5] == rows[1]
    elif case == "ungrouped_live_fact":
        assert not dup[:4].any()
        assert chain[0] == -1 and chain[1] == rows[0] and chain[3] == rows[1]
    else:
        assert not dup[[5, 6, 20, 21]].any() and (target[[5, 6, 20]] == CAP).all()
        assert dup[8] and target[8] == rows[7]


def test_dedup_resolve_gram_on_cpu_is_the_old_composition():
    """On CPU tensors the gram form launches nothing, leaves the gram as it
    was and equals the composition the ingest ran before it: the ``[B, B]``
    mask, ``masked_fill_``, ``argmax`` and ``gather``, then the loop."""
    qf, rows, valid, gid, p_s, p_r = (torch.from_numpy(x) for x in
                                      resolve_case("invalid_between"))
    gram = TS.nt_dot(qf, qf)
    kept = gram.clone()
    old = gram.clone()
    b = old.shape[0]
    earlier = torch.ones((b, b), dtype=torch.bool).tril(-1)
    old.masked_fill_(~(earlier & valid[None, :]), TS.NEG_INF)
    g_j = torch.argmax(old, dim=1)
    g_s = torch.gather(old, 1, g_j[:, None])[:, 0]
    want = dr.dedup_resolve_reference(g_s, g_j, p_s, p_r, valid, rows, gid,
                                      GATE, CAP)
    before = (dr.launches, dr.launches_card)
    got = dr.dedup_resolve_gram(gram, p_s, p_r, valid, rows, gid, GATE, CAP)
    assert (dr.launches, dr.launches_card) == before
    assert torch.equal(gram, kept)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_dedup_resolve_refuses_malformed_inputs_before_any_launch(monkeypatch):
    """A gram that is not ``[B, B]`` f32 on the rows' device, or a column
    that is not ``[B]``, raises ``ValueError`` before the library is loaded,
    on any device; an unsupported device raises too."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(dr, "_library", no_library)
    b = 6
    cols = [torch.zeros(b), torch.zeros(b, dtype=torch.int32),
            torch.ones(b, dtype=torch.bool), torch.arange(b, dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32)]
    before = (dr.launches, dr.launches_card)
    for gram in (torch.zeros(b, b + 1), torch.zeros(b * b), torch.zeros(b - 1, b - 1),
                 torch.zeros(b, b, dtype=torch.float64), torch.zeros(b, b, device="meta")):
        with pytest.raises(ValueError, match="the gram must be"):
            dr.dedup_resolve_gram(gram, *cols, GATE, CAP)
    with pytest.raises(ValueError, match="every column must be"):
        dr.dedup_resolve_gram(torch.zeros(b, b), cols[0][:-1], *cols[1:], GATE, CAP)
    with pytest.raises(ValueError, match="every column must be"):
        dr.dedup_resolve(torch.zeros(b, 1), cols[1], *cols, GATE, CAP)
    meta = [c.to("meta") for c in cols]
    with pytest.raises(ValueError, match="unsupported device"):
        dr.dedup_resolve_gram(torch.zeros(b, b, device="meta"), *meta, GATE, CAP)
    with pytest.raises(ValueError, match="unsupported device"):
        dr.dedup_resolve(meta[0], meta[1], *meta, GATE, CAP)
    assert (dr.launches, dr.launches_card) == before


@pytest.mark.parametrize("pool_len", [2, 40])
def test_gated_link_insert_matches_jax(pool_len):
    """With ``link_accept_hint`` < 1 the pool is short: the accepted edges
    past it write the sentinel slot, keep their true positions and raise
    the overflow flag."""
    rng = np.random.default_rng(9)
    b, k = 8, 3
    s1 = rng.uniform(0.0, 1.0, (b, k)).astype(np.float32)
    s0 = rng.uniform(0.0, 1.0, (b, k)).astype(np.float32)
    c1 = rng.integers(0, 30, (b, k)).astype(np.int32)
    c0 = c1.copy()
    c0[:, 1] = rng.integers(30, 60, b)        # mode 0 repeats mode 1's others
    src = np.arange(100, 100 + b, dtype=np.int32)
    valid = np.ones(b, bool)
    valid[-1] = False
    pool = TI.link_pool_dev(list(range(200, 200 + pool_len)), 2 * b * k, ECAP)
    je = JS.EdgeState(**{n: jnp.asarray(v) for n, v in edge_cols().items()})
    te = TS.edges_from_numpy(edge_cols(), "cpu")
    flat = (s1, c1, s0, c0)
    je, jouts = JS._gated_link_insert(
        je, tuple(jnp.asarray(x) for x in flat), jnp.asarray(pool),
        jnp.int32(pool_len), jnp.asarray(src), jnp.asarray(valid),
        jnp.float32(3.0), jnp.int32(1), jnp.float32(0.5), jnp.float32(0.8),
        (1, 0))
    te, touts = TS._gated_link_insert(
        te, tuple(torch.from_numpy(x) for x in flat), torch.from_numpy(pool),
        torch.tensor(pool_len, dtype=torch.int32), torch.from_numpy(src),
        torch.from_numpy(valid), torch.tensor(3.0), 1, 0.5, 0.8, (1, 0))
    assert_leaves(jouts, touts)
    assert int(touts[-3][0, 0]) == int(pool_len == 2)    # the overflow flag
    assert_columns(je, te, TS.EDGE_FIELDS)


def test_ingest_scan_plain_version_matches_the_jax_core():
    """The kernel's plain version against ``_ingest_scan_core``: the probe
    (the sentinel excluded) and one list per mode, a tenant with fewer
    eligible rows than k included."""
    ja, _, ta, _, cols = both_states(4, np.float32)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((5, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qs = np.array([0, 1, 2, 0, 1], np.int32)
    probe_excl = np.arange(CAP + 1) == CAP
    link_excl = probe_excl.copy()
    link_excl[:40] = True
    for tenant, k in ((0, 3), (1, 7), (5, 2)):      # tenant 5 owns no row
        want = JS._ingest_scan_core(ja, jnp.asarray(q), jnp.asarray(qs),
                                    jnp.asarray(probe_excl),
                                    jnp.asarray(link_excl), jnp.int32(tenant),
                                    k, (1, 0, -1))
        got = TS._ingest_scan_core(ta, torch.from_numpy(q),
                                   torch.from_numpy(qs),
                                   torch.from_numpy(probe_excl),
                                   torch.from_numpy(link_excl), tenant, k,
                                   (1, 0, -1))
        assert_leaves(want, got)
    assert got[0][0, 0] == np.float32(-1e30) and int(got[1][0, 0]) == 0


# -------------------------------------- port versions of test_fused_ingest
D = 24
_DIRS = np.random.default_rng(3).standard_normal((10, D))
_DIRS /= np.linalg.norm(_DIRS, axis=1, keepdims=True)


class ClusteredEmb:
    """Facts of one group land ~0.8 cosine apart: above the 0.5 link gate,
    below the 0.95 dedup gate."""

    dim = D

    def _v(self, t):
        try:
            idx = int(t.split()[1])
        except (IndexError, ValueError):
            idx = abs(hash(t)) % 100
        rng = np.random.default_rng(500 + idx)
        v = 0.85 * _DIRS[idx % 10] + 0.55 * rng.standard_normal(D)
        return (v / np.linalg.norm(v)).tolist()

    def embed(self, t):
        return self._v(t)

    def batch_embed(self, ts):
        return [self._v(t) for t in ts]


class QueueLLM:
    def __init__(self, per=20):
        self.c = 0
        self.per = per

    def completion(self, messages, response_format=None):
        base = self.c * self.per
        self.c += 1
        return json.dumps({"memories": [
            {"content": f"fact {base + i} body", "type": "semantic",
             "salience": 0.6,
             "topic": ["work", "personal", "learning"][(base + i) % 3]}
            for i in range(self.per)]})


def _system(tmp, fused=True, per=20):
    return MemorySystem(
        enable_async=False, db_dir=tmp, verbose=False, load_from_disk=False,
        llm_provider=QueueLLM(per), embedding_provider=ClusteredEmb(),
        auto_prune=False, max_buffer_size=10_000, device="cpu",
        config=MemoryConfig(ingest_fused=fused, ingest_dedup_fused=fused,
                            decay_rate=0.0))


_COUNTED = ("add", "merge_touch", "link_candidates_multi", "search_batch",
            "ingest_batch", "ingest_batch_dedup", "_readback")


def _count_calls(monkeypatch):
    calls = {name: 0 for name in _COUNTED + ("ingest_dedup_fused",
                                             "ingest_fused")}

    def counting(owner, name):
        orig = getattr(owner, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(owner, name, wrapped)

    for name in _COUNTED:
        counting(MemoryIndex, name)
    counting(TS, "ingest_dedup_fused")
    counting(TS, "ingest_fused")
    return calls


def test_one_fused_dispatch_per_conversation(monkeypatch):
    """A consolidated conversation costs ONE ingest dispatch (the dedup
    probe rides inside it, no separate search) and ONE device-to-host copy,
    and no classic mutation call."""
    with tempfile.TemporaryDirectory() as tmp:
        ms = _system(tmp)
        ms.start_conversation()
        ms.add_to_short_term("conv 0", "episodic", 0.7)
        calls = _count_calls(monkeypatch)
        before = ms.index.ingest_dispatch_count
        ms.end_conversation()
        assert calls["ingest_dedup_fused"] == 1
        assert calls["ingest_batch_dedup"] == 1
        assert calls["_readback"] == 1
        assert ms.index.ingest_dispatch_count == before + 1
        for name in ("add", "merge_touch", "link_candidates_multi",
                     "search_batch", "ingest_batch", "ingest_fused"):
            assert calls[name] == 0, (name, calls)
        assert ms.buffer.size()[0] == 20
        ms.close()


class DupLLM(QueueLLM):
    """Repeats the first two facts verbatim: exact-cosine duplicates."""

    def completion(self, messages, response_format=None):
        out = json.loads(super().completion(messages, response_format))
        out["memories"] += [dict(out["memories"][0]), dict(out["memories"][1])]
        return json.dumps(out)


def test_one_dispatch_with_device_dedup_duplicates(monkeypatch):
    """Real duplicates in the batch: the device merges them inside the one
    dispatch, and the graph matches the classic pipeline's."""
    def build(fused):
        ms = _system(tempfile.mkdtemp(), fused=fused)
        ms.llm = DupLLM(8)
        ms.start_conversation()
        ms.add_to_short_term("conv 0", "episodic", 0.7)
        return ms

    ms = build(True)
    calls = _count_calls(monkeypatch)
    ms.end_conversation()
    assert calls["ingest_dedup_fused"] == 1 and calls["search_batch"] == 0
    assert calls["_readback"] == 1
    assert ms.buffer.size()[0] == 8          # 2 duplicates merged, not added
    monkeypatch.undo()
    classic = build(False)
    classic.end_conversation()
    try:
        assert set(ms.buffer.nodes) == set(classic.buffer.nodes)

        def nodes(m):
            return {n: (round(m.buffer.nodes[n].salience, 5),
                        m.buffer.nodes[n].access_count) for n in m.buffer.nodes}

        assert nodes(ms) == nodes(classic)
        assert set(ms.index.edge_slots) == set(classic.index.edge_slots)
    finally:
        ms.close()
        classic.close()


@pytest.mark.parametrize("dedup", [True, False])
def test_fused_matches_unfused_exactly(dedup):
    """Node set, host edges (keys and weights), the device edge arena and
    retrieval results are identical across the fused and classic ingest
    (``dedup=False``: ``ingest_fused`` alone, the probe stays classic)."""
    def build(fused):
        ms = _system(tempfile.mkdtemp(), fused=fused)
        ms.config.ingest_dedup_fused = fused and dedup
        for c in range(3):
            ms.start_conversation()
            ms.add_to_short_term(f"conv {c}", "episodic", 0.7)
            ms.end_conversation()
        return ms

    a, b = build(True), build(False)
    try:
        assert a.index.ingest_dispatch_count == 3
        assert b.index.ingest_dispatch_count == 0
        assert a.buffer.size() == b.buffer.size()
        assert set(a.buffer.nodes) == set(b.buffer.nodes)

        def host_edges(ms):
            return {(e.source, e.target): round(e.weight, 5)
                    for s in ms.shards.values() for e in s.edges.values()}

        assert host_edges(a) == host_edges(b)
        assert set(a.index.edge_slots) == set(b.index.edge_slots)
        wa, wb = a.index.edge_weights(), b.index.edge_weights()
        for key in wa:
            assert wa[key][0] == pytest.approx(wb[key][0], abs=1e-5), key
            assert wa[key][1] == wb[key][1], key
        assert a.metrics["edges_linked"] == b.metrics["edges_linked"] > 0
        for q in ("fact 7 body", "fact 31 body"):
            assert ([n.id for n in a.search_memories(q)]
                    == [n.id for n in b.search_memories(q)])
    finally:
        a.close()
        b.close()


def _seed_index(seed_emb, n=20, **kw):
    idx = MemoryIndex(dim=seed_emb.shape[1], capacity=255, device="cpu", **kw)
    idx.add([f"m{i}" for i in range(n)], seed_emb, [0.5] * n, [0.0] * n,
            ["semantic"] * n, ["default"] * n, "u")
    return idx


def test_ingest_batch_candidates_match_link_candidates_multi():
    """The fused dispatch's link output is the scan the classic path runs
    after its add: the same candidates either way."""
    rng = np.random.default_rng(11)
    seed_emb = rng.standard_normal((20, D)).astype(np.float32)
    new_emb = rng.standard_normal((4, D)).astype(np.float32)
    idx1, idx2 = _seed_index(seed_emb), _seed_index(seed_emb)
    new_ids = [f"n{i}" for i in range(4)]
    common = dict(saliences=[0.5] * 4, timestamps=[0.0] * 4,
                  types=["semantic"] * 4, shard_keys=["default"] * 4)
    _rows, cands, _created = idx1.ingest_batch(new_ids, new_emb, tenant="u",
                                               link_k=3, **common)
    idx2.add(new_ids, new_emb, common["saliences"], common["timestamps"],
             common["types"], common["shard_keys"], "u")
    classic = idx2.link_candidates_multi(new_ids, "u", k=3, shard_modes=(1, 0))
    for mode in (1, 0):
        assert set(cands[mode]) == set(classic[mode])
        for nid in cands[mode]:
            assert ([(c, round(s, 5)) for c, s in cands[mode][nid]]
                    == [(c, round(s, 5)) for c, s in classic[mode][nid]])


def test_link_candidates_multi_reads_back_once(monkeypatch):
    """The classic link scan's leaves come back in ONE packed copy."""
    rng = np.random.default_rng(2)
    idx = _seed_index(rng.standard_normal((20, D)).astype(np.float32))
    copies = []
    inner = idx._readback
    monkeypatch.setattr(idx, "_readback", lambda p: copies.append(p.shape)
                        or inner(p))
    out = idx.link_candidates_multi(["m1", "m2", "m3"], "u", k=3,
                                    shard_modes=(1, 0, -1))
    assert copies == [(6, 8, 3)]       # 3 modes x (scores, rows), B padded
    assert set(out) == {1, 0, -1} and len(out[0]["m1"]) == 3


def test_ingest_batch_reclaims_rejected_slots():
    """Slots pre-allocated for links the gate rejects go back to the free
    list; the live edge arena and the slot map stay consistent."""
    idx = MemoryIndex(dim=D, capacity=255, edge_capacity=1023, device="cpu")
    emb = np.eye(D, dtype=np.float32)[:8]     # orthogonal: nothing links
    free_before = len(idx._free_edge_slots)
    _rows, _cands, created = idx.ingest_batch(
        [f"o{i}" for i in range(8)], emb, [0.5] * 8, [0.0] * 8,
        ["semantic"] * 8, ["default"] * 8, "u",
        chain_pairs=[(f"o{i}", f"o{i+1}") for i in range(7)])
    assert created == {1: [], 0: []}
    assert len(idx._free_edge_slots) == free_before - 7
    assert len(idx.edge_slots) == 7
    assert int(idx.edge_state.alive.sum()) == 7


def test_coalescer_merges_and_splits():
    c = IngestCoalescer(max_facts=10)
    c.add_conversation([{"content": f"a{i}"} for i in range(4)])
    c.add_conversation([{"content": f"b{i}"} for i in range(4)])
    assert len(c) == 8 and c.pending_conversations == 2
    batches = c.drain()
    assert len(batches) == 1
    facts, n_convs = batches[0]
    assert len(facts) == 8 and n_convs == 2
    assert len(c) == 0
    c.add_conversation([{"content": f"a{i}"} for i in range(7)])
    c.add_conversation([{"content": f"b{i}"} for i in range(7)])
    assert [(len(f), n) for f, n in c.drain()] == [(7, 1), (7, 1)]
    c.add_conversation([{"content": f"x{i}"} for i in range(23)])
    batches = c.drain()
    assert [len(f) for f, _ in batches] == [10, 10, 3]
    assert sum(n for _, n in batches) >= 1


def test_coalesced_mega_batch_is_one_dispatch(monkeypatch):
    """Two deferred conversations drain as one mega-batch: one dispatch and
    one readback for both."""
    with tempfile.TemporaryDirectory() as tmp:
        ms = MemorySystem(
            enable_async=False, db_dir=tmp, verbose=False, load_from_disk=False,
            llm_provider=QueueLLM(6), embedding_provider=ClusteredEmb(),
            auto_prune=False, max_buffer_size=10_000, device="cpu",
            config=MemoryConfig(decay_rate=0.0, ingest_flush_wait_s=3600.0))
        ms.start_conversation()
        ms.add_to_short_term("conv 0", "episodic", 0.7)
        ms.end_conversation()
        assert ms.buffer.size()[0] == 0
        ms._ingest_coalescer.policy._oldest -= 7200.0
        calls = _count_calls(monkeypatch)
        ms.start_conversation()
        ms.add_to_short_term("conv 1", "episodic", 0.7)
        ms.end_conversation()
        assert ms.buffer.size()[0] == 12
        assert calls["ingest_dedup_fused"] == 1 and calls["_readback"] == 1
        ms.close()


def _assert_same_edges(a, b):
    assert set(a.edge_slots) == set(b.edge_slots)
    wa, wb = a.edge_weights(), b.edge_weights()
    for key in wa:
        assert abs(wa[key][0] - wb[key][0]) < 1e-5, (key, wa[key], wb[key])


def test_link_pool_hint_overflow_retry_exact_parity():
    """A tiny ``link_accept_hint`` under-provisions the pool on purpose: the
    overflow flag fires, exactly the overflowed edges are re-inserted, the
    result equals a worst-case-pool twin and no slot leaks."""
    base = np.random.default_rng(3).standard_normal((1, 16)).astype(np.float32)

    def build():
        rng = np.random.default_rng(3)
        seed_emb = (np.tile(base, (8, 1))
                    + 0.05 * rng.standard_normal((8, 16)).astype(np.float32))
        idx = MemoryIndex(dim=16, capacity=255, edge_capacity=512, device="cpu")
        idx.add([f"s{i}" for i in range(8)], seed_emb, [0.5] * 8, [0.0] * 8,
                ["semantic"] * 8, ["default"] * 8, "u0")
        return idx

    a, b = build(), build()
    new_emb = (np.tile(base, (4, 1)) + 0.05 * np.random.default_rng(4)
               .standard_normal((4, 16)).astype(np.float32))
    args = ([f"n{i}" for i in range(4)], new_emb, [0.5] * 4, [0.0] * 4,
            ["semantic"] * 4, ["default"] * 4, "u0")
    kw = dict(link_k=3, link_gate=0.5, now=123.0)
    free_a = len(a._free_edge_slots)
    _, _, created_a = a.ingest_batch(*args, link_accept_hint=0.05, **kw)
    _, _, created_b = b.ingest_batch(*args, **kw)
    assert a.link_pool_overflows == 1 and b.link_pool_overflows == 0
    for sm in (1, 0):
        assert sorted(created_a[sm]) == sorted(created_b[sm])
    _assert_same_edges(a, b)
    assert len(a._free_edge_slots) + len(a.edge_slots) == free_a


def test_link_pool_hint_no_overflow_shrinks_allocation():
    idx = MemoryIndex(dim=D, capacity=255, edge_capacity=1023, device="cpu")
    emb = np.eye(D, dtype=np.float32)[:8]
    _, _, created = idx.ingest_batch(
        [f"o{i}" for i in range(8)], emb, [0.5] * 8, [0.0] * 8,
        ["semantic"] * 8, ["default"] * 8, "u", link_k=3,
        link_accept_hint=0.25)
    assert created == {1: [], 0: []}
    assert idx.link_pool_overflows == 0
    assert TI.link_pool_size(48, 0.25) == 12
    assert TI.link_pool_size(48, 1.0) == 48
    assert TI.link_pool_size(48, 0.0) == 1


def test_dedup_fused_pool_hint_overflow_retry():
    """The dedup-fused path honours the hint too: overflowed accepted links
    come back through ``commit_ingest_dedup``'s host retry with the same
    weights."""
    def run_hint(hint):
        rng = np.random.default_rng(11)
        base = rng.standard_normal((1, 16)).astype(np.float32)
        idx = MemoryIndex(dim=16, capacity=255, edge_capacity=512, device="cpu")
        seed_emb = (np.tile(base, (6, 1))
                    + 0.05 * rng.standard_normal((6, 16)).astype(np.float32))
        idx.add([f"s{i}" for i in range(6)], seed_emb, [0.5] * 6, [0.0] * 6,
                ["semantic"] * 6, ["default"] * 6, "u0")
        new_emb = (np.tile(base, (3, 1))
                   + 0.05 * rng.standard_normal((3, 16)).astype(np.float32))
        pending = idx.ingest_batch_dedup(
            new_emb, [0.5] * 3, [0.0] * 3, ["semantic"] * 3, ["default"] * 3,
            "u0", dedup_gate=2.0, link_k=3, link_gate=0.5, now=99.0,
            link_accept_hint=hint)
        _, created, _, _ = idx.commit_ingest_dedup(pending,
                                                   [f"q{i}" for i in range(3)])
        return idx, created

    a, created_a = run_hint(0.05)
    b, created_b = run_hint(1.0)
    assert a.link_pool_overflows == 1 and b.link_pool_overflows == 0
    for sm in (1, 0):
        assert sorted(created_a[sm]) == sorted(created_b[sm])
    _assert_same_edges(a, b)


def test_warmup_ingest_leaves_the_corpus_as_it_was():
    rng = np.random.default_rng(1)
    idx = _seed_index(rng.standard_normal((20, D)).astype(np.float32))
    before = (dict(idx.id_to_row), len(idx._free_rows), set(idx.edge_slots))
    out = idx.warmup_ingest((12,))
    assert list(out) == [16] and idx.ingest_dispatch_count == 1
    assert (dict(idx.id_to_row), len(idx._free_rows), set(idx.edge_slots)) \
        == before


def test_ingest_counters_ride_the_readback():
    """``ingest.dispatches``, ``ingest.dedup_hits``,
    ``ingest.links_accepted`` and ``ingest.pool_slots_used`` come from the
    one readback of each conversation; ``ingest.dispatch_ms`` is
    recorded."""
    with tempfile.TemporaryDirectory() as tmp:
        ms = _system(tmp)
        ms.llm = DupLLM(8)
        for c in range(2):
            ms.start_conversation()
            ms.add_to_short_term(f"conv {c}", "episodic", 0.7)
            ms.end_conversation()
        tel = ms.telemetry
        assert tel.counter_total("ingest.dispatches") == 2
        assert tel.counter_total("ingest.dedup_hits") == 4
        links = tel.counter_total("ingest.links_accepted")
        assert links == tel.counter_total("ingest.pool_slots_used") > 0
        assert len(tel.timer_values("ingest.dispatch_ms")) == 2
        ms.close()


def test_mesh_refuses_the_fused_ingest():
    from lazzaro_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 21"):
        MemoryIndex(8, device="cpu", mesh=mesh).ingest_batch_dedup(
            np.ones((1, 8), np.float32), [0.5], [0.0], ["semantic"],
            ["default"], "u", dedup_gate=0.95)


# ------------------------------------------------------------- kernels' CPU
def test_wrappers_run_the_plain_versions_on_cpu_tensors(monkeypatch):
    """On CPU tensors the ingest scan and the resolve run their plain
    versions and count no launch."""
    ta = arena_cols(6, np.float32)
    st = TS.arena_from_numpy(ta, "cpu")
    before = (it.launches, dr.launches)
    excl = torch.zeros(CAP + 1, dtype=torch.bool)
    out = TS._ingest_scan_core(st, st.emb[:3], st.shard_id[:3], excl, excl,
                               0, 2, (1, 0))
    assert [tuple(x.shape) for x in out] == [(3, 1)] * 2 + [(3, 2)] * 4
    assert all(x.dtype == torch.int32 for x in out[1::2])
    t = torch.zeros(4, dtype=torch.int32)
    dr.dedup_resolve(torch.zeros(4), t, torch.zeros(4), t,
                     torch.ones(4, dtype=torch.bool), t, t, GATE, CAP)
    assert (it.launches, dr.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        it.ingest_topk(st.emb.to("meta"), *[torch.zeros(1)] * 8, 0, 1)


# ------------------------------------------------------- the whole slice
FUSED_INGEST = dict(CLASSIC, ingest_fused=True, ingest_dedup_fused=True)


@pytest.fixture(scope="module")
def both_fused_ingest(tmp_path_factory):
    root = tmp_path_factory.mktemp("dialogue_fused_ingest")
    with pytest.MonkeyPatch.context() as mp:
        jrec, jret = run(JaxSystem, JaxConfig, JaxEmbedder, JaxLLM,
                         str(root / "jax_db"), mp, config_kw=FUSED_INGEST)
        trec, tret = run(TorchSystem, TorchConfig, TorchEmbedder, TorchLLM,
                         str(root / "torch_db"), mp, device="cpu",
                         config_kw=FUSED_INGEST)
    return jrec, jret, trec, tret


def test_fused_ingest_dialogue_matches_jax(both_fused_ingest):
    """The scripted dialogue under the fused dedup ingest in both packages:
    chat-turn ids, node snapshots (contents, shards, saliences, access
    counts, super-node children), edges, searches."""
    jrec, jret, trec, tret = both_fused_ingest
    assert tret == jret
    assert [r[0] for r in trec] == [r[0] for r in jrec]
    for j, t in zip(jrec, trec):
        if j[0] in ("nodes", "nodes_bob"):
            assert_snapshots_match(j[1], t[1])
        elif j[0] == "ranked":
            for (jids, js), (tids, ts) in zip(j[1], t[1]):
                assert_same_ranking(jids, js, tids, ts)
        elif j[0] == "top5":
            for ids, (ranked, _) in zip(t[1], t_ranked(trec)):
                assert ids == [i.partition(":")[2] for i in ranked[:5]]
        else:
            assert t == j, j[0]


def test_fused_ingest_dialogue_equals_the_classic_run(both_fused_ingest,
                                                      tmp_path, monkeypatch):
    """The port's fused dialogue equals its own classic one."""
    _, _, trec, tret = both_fused_ingest
    crec, cret = run(TorchSystem, TorchConfig, TorchEmbedder, TorchLLM,
                     str(tmp_path / "classic"), monkeypatch, device="cpu")
    assert cret == tret
    for c, t in zip(crec, trec):
        if c[0] in ("nodes", "nodes_bob"):
            assert_snapshots_match(c[1], t[1])
        elif c[0] != "ranked":
            assert t == c, c[0]


def test_ingest_route_rule():
    """K1's stage-1 route: the tensor cores for bf16; for f32 the whole
    scan (probe and link lists, one launch) streams where ``masked_topk``
    streams the same batch (so the fused and the classic ingest's probes
    score alike), else the FMA stage; by shape alone, never by N."""
    assert it.route_for(torch.bfloat16, 8, 768) == "wgmma"
    assert it.route_for(torch.bfloat16, 8192, 768) == "wgmma"
    for nq, d in ((1, 768), (8, 768), (16, 768), (4, 3072), (8, 1536)):
        assert it.route_for(torch.float32, nq, d) == "stream"
    for nq, d in ((17, 768), (8192, 768), (8, 3072), (16, 1536)):
        assert it.route_for(torch.float32, nq, d) == "fma"
    for nq in range(1, 33):
        for d in (8, 64, 72, 768, 1536, 3072, 4096):
            want = "stream" if mt.stream_fits(d, nq) else "fma"
            assert it.route_for(torch.float32, nq, d) == want
            assert mt.route_for(torch.float32, nq, d) == want


@pytest.mark.parametrize("dtype,nq,d", [
    (torch.float32, 16, 3072),      # the queries do not fit a lane's registers
    (torch.float32, 16, 1536),      # nor past 8 facts at 1,536
    (torch.float32, 17, 64),        # past STREAM_MAX_Q
    (torch.bfloat16, 8, 768)])      # bf16 takes the tensor cores
def test_ingest_refuses_a_forced_stream_route_the_shape_cannot_take(dtype, nq, d):
    """A forced ``route="stream"`` is refused before any launch where the
    shape rule would not stream the batch (the streaming stage holds a
    lane's queries in registers and reads f32 rows only); so is a route
    that does not exist. No launch is counted."""
    n = 64
    emb = torch.zeros((n, d), dtype=dtype)
    alive = torch.ones(n, dtype=torch.bool)
    zeros = torch.zeros(n, dtype=torch.int32)
    none = torch.zeros(n, dtype=torch.bool)
    q = torch.zeros((nq, d), dtype=dtype)
    args = (emb, alive, zeros, none, zeros, none, none, q,
            torch.zeros(nq, dtype=torch.int32), 0, 3, (1, 0), True)
    before = (it.launches, it.launches_stream)
    with pytest.raises(ValueError, match="streaming route"):
        it._launch(*args, route="stream")
    with pytest.raises(ValueError, match="no route"):
        it._launch(*args, route="tiles")
    assert (it.launches, it.launches_stream) == before
