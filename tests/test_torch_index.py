"""Parity of ``lazzaro_tpu_torch.core.index.MemoryIndex`` (device="cpu")
with ``lazzaro_tpu.core.index.MemoryIndex``: the same call sequence on the
same numpy inputs, and ``from_numpy`` carrying a filled JAX index across.

Tolerances: ids, rows, slots and edge keys equal; f32 scores, saliences and
edge weights within 1e-6 (f32 sums in another order). A bf16 arena carried
across serves scores within 1e-2 and the same ids wherever neighbouring
scores differ by more than that (queries round to bf16 after a norm summed
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lazzaro_tpu.core import state as JS
from lazzaro_tpu.core.index import MemoryIndex as JaxIndex
from lazzaro_tpu_torch.core import state as TS
from lazzaro_tpu_torch.core.index import MemoryIndex as TorchIndex

DIM = 32
EPOCH = 1_000_000.0
NOW = EPOCH + 50.0
ATOL = 1e-6


def unit(rng, n):
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def fill(index, rng_seed=0, n=60, tenants=("a", "b")):
    rng = np.random.default_rng(rng_seed)
    emb = unit(rng, n)
    for t, tenant in enumerate(tenants):
        sl = slice(t * n // len(tenants), (t + 1) * n // len(tenants))
        m = sl.stop - sl.start
        index.add([f"{tenant}:n{i}" for i in range(sl.start, sl.stop)], emb[sl],
                  list(rng.random(m)), [NOW - i for i in range(m)],
                  ["semantic", "episodic"] * (m // 2) + ["semantic"] * (m % 2),
                  [("work", "home", "fun")[i % 3] for i in range(m)], tenant,
                  [i % 17 == 0 for i in range(m)])
    return emb


def assert_columns(jidx, tidx):
    for name in TS.ARENA_FIELDS:
        a = np.asarray(getattr(jidx.state, name)).astype(np.float32
                                                          if name == "emb" else None)
        b = getattr(tidx.state, name).float().numpy() if name == "emb" \
            else getattr(tidx.state, name).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    for name in TS.EDGE_FIELDS:
        a = np.asarray(getattr(jidx.edge_state, name))
        b = getattr(tidx.edge_state, name).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def assert_results(jres, tres):
    assert len(jres) == len(tres)
    for (jids, js), (tids, ts) in zip(jres, tres):
        assert tids == jids
        np.testing.assert_allclose(ts, js, rtol=0, atol=ATOL)


def test_index_sequence_parity():
    jidx = JaxIndex(DIM, capacity=40, edge_capacity=16, epoch=EPOCH)
    tidx = TorchIndex(DIM, capacity=40, edge_capacity=16, epoch=EPOCH, device="cpu")
    emb = fill(jidx)
    fill(tidx)                     # grows 40 -> 81 rows on the way
    assert tidx.capacity == jidx.capacity
    assert tidx.id_to_row == jidx.id_to_row
    assert_columns(jidx, tidx)

    rng = np.random.default_rng(1)
    q = unit(rng, 5)
    for tenant, sf in (("a", 0), ("a", -1), ("b", 1)):
        assert_results(jidx.search_batch(q, tenant, k=7, super_filter=sf),
                       tidx.search_batch(q, tenant, k=7, super_filter=sf))
    assert_results([jidx.search(emb[3], "a", 3)], [tidx.search(emb[3], "a", 3)])

    new_ids = ["a:n1", "a:n5", "a:n9", "a:n28"]
    jl = jidx.link_candidates_multi(new_ids, "a", k=3, shard_modes=(1, 0))
    tl = tidx.link_candidates_multi(new_ids, "a", k=3, shard_modes=(1, 0))
    assert jl.keys() == tl.keys()
    for sm in jl:
        for nid in jl[sm]:
            assert [c for c, _ in tl[sm][nid]] == [c for c, _ in jl[sm][nid]]
            np.testing.assert_allclose([s for _, s in tl[sm][nid]],
                                       [s for _, s in jl[sm][nid]], atol=ATOL)
    for sm in (1, -1):                 # the single-mode view, other-shard mode too
        jone = jidx.link_candidates(new_ids, "a", k=3, shard_mode=sm)
        tone = tidx.link_candidates(new_ids, "a", k=3, shard_mode=sm)
        assert {n: [c for c, _ in p] for n, p in tone.items()} == \
            {n: [c for c, _ in p] for n, p in jone.items()}

    triples = [(nid, c, s * 0.8) for nid in new_ids for c, s in jl[0][nid]]
    triples += triples[:3]         # repeats inside one batch reinforce
    for index in (jidx, tidx):
        index.add_edges(triples, "a", now=NOW)
        index.add_edges(triples[:5], "a", now=NOW + 1)
        index.update_access(["a:n2", "a:n3"], now=NOW + 2)
        index.boost(["a:n4", "b:n40"], now=NOW + 3)
        index.merge_touch(["a:n6", "a:n7"], [0.99, 0.01], now=NOW + 4)
        index.apply_boosts({"a:n8": (2, 1, NOW + 5), "a:n9": (0, 3, NOW + 6)},
                           0.05, 0.02)
    assert tidx.edge_slots == jidx.edge_slots
    assert_columns(jidx, tidx)
    jw = jidx.edge_weights_for(list(jidx.edge_slots))
    tw = tidx.edge_weights_for(list(jidx.edge_slots))
    assert tw.keys() == jw.keys()
    for key, (w, co) in jw.items():
        assert tw[key][1] == co and abs(tw[key][0] - w) <= ATOL

    for index in (jidx, tidx):
        for _ in range(3):
            index.decay("a", 0.1, 0.2)
    assert_columns(jidx, tidx)
    assert tidx.prune_edges("a", 0.5) == jidx.prune_edges("a", 0.5)
    assert tidx.edge_slots == jidx.edge_slots
    assert tidx._free_edge_slots == jidx._free_edge_slots
    assert_columns(jidx, tidx)

    je = jidx.evict_candidates("a", 5, now=NOW + 10)
    te = tidx.evict_candidates("a", 5, now=NOW + 10)
    assert [i for i, _ in te] == [i for i, _ in je]
    np.testing.assert_allclose([v for _, v in te], [v for _, v in je], atol=ATOL)
    for index in (jidx, tidx):
        index.delete(["a:n1", "a:n2", "b:n31"])
    assert tidx.id_to_row == jidx.id_to_row
    assert tidx._free_rows == jidx._free_rows
    assert tidx.edge_slots == jidx.edge_slots
    assert_columns(jidx, tidx)
    np.testing.assert_allclose(tidx.mean_embedding(["a:n3", "a:n4"]),
                               jidx.mean_embedding(["a:n3", "a:n4"]), atol=ATOL)
    np.testing.assert_allclose(tidx.get_embedding("a:n3"),
                               jidx.get_embedding("a:n3"), atol=ATOL)
    rows = [jidx.id_to_row["a:n3"], jidx.id_to_row["b:n40"]]
    for key in ("salience", "last_accessed", "access_count"):
        np.testing.assert_allclose(tidx.pull_numeric_rows(rows)[key],
                                   jidx.pull_numeric_rows(rows)[key], atol=ATOL)
    js, ts = jidx.stats(), tidx.stats()
    for key in ("rows", "capacity", "edge_capacity", "edges", "dim", "tenants"):
        assert ts[key] == js[key]


def carry(jidx):
    arena = {f: np.asarray(getattr(jidx.state, f)) for f in TS.ARENA_FIELDS}
    edges = {f: np.asarray(getattr(jidx.edge_state, f)) for f in TS.EDGE_FIELDS}
    meta = {"id_to_row": jidx.id_to_row, "tenants": jidx._tenants,
            "shards": jidx._shards, "edge_slots": dict(jidx.edge_slots),
            "free_rows": jidx._free_rows,
            "free_edge_slots": jidx._free_edge_slots, "epoch": jidx.epoch}
    return TorchIndex.from_numpy(arena, edges, meta, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_numpy_serves_the_same_topk(dtype):
    jidx = JaxIndex(DIM, capacity=JS.TOPK_BLOCK, edge_capacity=64,
                    dtype=jnp.dtype(dtype), epoch=EPOCH)
    emb = fill(jidx, rng_seed=5, n=300)
    jidx.add_edges([("a:n1", "a:n2", 0.7), ("a:n3", "a:n4", 0.4)], "a", now=NOW)
    jidx.delete(["a:n10"])
    tidx = carry(jidx)
    assert tidx.dtype == getattr(torch, dtype)
    assert tidx.capacity == jidx.capacity
    assert tidx.tenant_nodes == jidx.tenant_nodes

    rng = np.random.default_rng(6)
    q = np.concatenate([unit(rng, 12), emb[[0, 11, 150, 299]]])    # 16 queries
    for tenant in ("a", "b"):
        jres = jidx.search_batch(q, tenant, k=10, super_filter=-1)
        tres = tidx.search_batch(q, tenant, k=10, super_filter=-1)
        if dtype == "float32":
            assert_results(jres, tres)
            continue
        for (jids, js), (tids, ts) in zip(jres, tres):
            np.testing.assert_allclose(ts, js, rtol=0, atol=1e-2)
            for i, (a, b) in enumerate(zip(jids, tids)):
                if a != b:
                    gaps = np.abs(np.asarray(js) - js[i])
                    gaps[i] = np.inf
                    assert gaps.min() <= 1e-2
    # the carried index keeps working: same rows for the next insert
    for index in (jidx, tidx):
        index.add(["a:new"], emb[:1], [0.5], [NOW], ["semantic"], ["work"], "a")
    assert tidx.id_to_row["a:new"] == jidx.id_to_row["a:new"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tenant_reload_matches_jax(dtype):
    """A reload's index calls on both packages: the whole tenant deleted
    (its edges freed in the order a scan of every slot frees them), its
    rows added back in one call and their access history restored; every
    column, the row and slot maps and the free lists equal."""
    jidx = JaxIndex(DIM, capacity=40, edge_capacity=16, epoch=EPOCH,
                    dtype=jnp.dtype(dtype))
    tidx = TorchIndex(DIM, capacity=40, edge_capacity=16, epoch=EPOCH,
                      device="cpu", dtype=dtype)
    emb = fill(jidx)
    fill(tidx)
    rng = np.random.default_rng(3)
    pairs = [(f"a:n{i}", f"a:n{j}", float(rng.random()))
             for i, j in rng.integers(0, 30, (40, 2)) if i != j]
    pairs += [(f"b:n{i}", f"b:n{j}", 0.5) for i, j in ((31, 40), (45, 33))]
    for index in (jidx, tidx):
        index.add_edges(pairs, "a", now=NOW)
        index.delete(sorted(index.tenant_nodes["a"]))
    assert tidx.edge_slots == jidx.edge_slots
    assert list(tidx.edge_slots) == list(jidx.edge_slots)
    assert tidx._free_edge_slots == jidx._free_edge_slots
    assert tidx._free_rows == jidx._free_rows
    ids = [f"a:n{i}" for i in range(30)]
    acs, las = rng.integers(0, 9, 30), NOW - 100 * rng.random(30)
    for index in (jidx, tidx):
        index.add(ids, emb[:30], rng.random(30) * 0 + 0.4, [NOW] * 30,
                  ["semantic"] * 30, ["work"] * 30, "a", [False] * 30)
        index.restore_access(ids, acs, las)
        index.add_edges(pairs[:10], "a", now=NOW)
    assert tidx.id_to_row == jidx.id_to_row
    assert tidx.edge_slots == jidx.edge_slots
    assert_columns(jidx, tidx)


def test_delete_frees_the_slots_a_full_scan_frees():
    """``delete`` finds the dead edges through the per-node key index: the
    same keys, freed in the same order, as a scan of every slot, through
    inserts, re-inserts, prunes and deletes."""
    idx = TorchIndex(DIM, capacity=200, edge_capacity=64, epoch=EPOCH,
                     device="cpu")
    rng = np.random.default_rng(5)
    ids = [f"t:n{i}" for i in range(150)]
    idx.add(ids, unit(rng, 150), [0.5] * 150, [NOW] * 150, ["semantic"] * 150,
            ["work"] * 150, "t")
    live = set(ids)
    for step in range(6):
        pool = sorted(live)
        pairs = [(pool[i], pool[j], float(w)) for (i, j), w in zip(
            rng.integers(0, len(pool), (120, 2)), rng.random(120)) if i != j]
        idx.add_edges(pairs, "t", now=NOW)
        idx.prune_edges("t", 0.2)
        gone = list(rng.choice(pool, 7, replace=False))
        want_order = [k for k in idx.edge_slots if k[0] in gone or k[1] in gone]
        want_slots = [idx.edge_slots[k] for k in want_order]
        free_before = list(idx._free_edge_slots)
        idx.delete(gone)
        live -= set(gone)
        assert idx._free_edge_slots == free_before + want_slots
        assert all(a in live and b in live for a, b in idx.edge_slots)
        assert set(idx.edge_slots.by_slot.values()) == set(idx.edge_slots)
