"""The mesh slice as a whole: ``MemorySystem(mesh=make_mesh(devices=["cpu"] *
8), device="cpu")`` of the port against the JAX ``MemorySystem`` on the
8-device CPU mesh and against the port's own single-device run, with fused
serving and with the classic ``serve_fused=False`` path, on the scripted
dialogue of ``tests/test_torch_memory_system.py`` (classic ingest: dedup
probe, links, a super node, eviction, ``switch_user``). Then the row layout
of the sharded index (capacity rounding, growth, ``from_numpy``) and the
launches and readbacks of one dispatch.

Tolerances: against the port's single-device run everything is equal,
saliences and edge weights included (the same f32 operations, per shard).
Against the JAX system: node ids, contents, shard keys, access counts,
super-node children, edge keys, chat-turn retrieved ids and
``search_memories`` ids are equal; saliences, edge weights and scores agree
within 1e-6 (f32 sums in another order; the JAX sharded programs differ
from its single-device ones by about one f32 ulp at n = 8).
"""

import numpy as np
import pytest

import jax
from lazzaro_tpu.core.index import MemoryIndex as JaxIndex
from lazzaro_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lazzaro_tpu_torch.core import state as TS
from lazzaro_tpu_torch.core.index import MemoryIndex as TorchIndex
from lazzaro_tpu_torch.parallel import make_mesh
from tests.test_torch_memory_system import (CLASSIC, FUSED, QUERIES, JaxConfig,
                                            JaxEmbedder, JaxLLM, JaxSystem,
                                            TorchConfig, TorchEmbedder,
                                            TorchLLM, TorchSystem,
                                            assert_same_ranking,
                                            assert_snapshots_match, run)


def jax_mesh(n):
    return jax_make_mesh(("data",), (n,), devices=jax.devices()[:n])


def cpu_mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


def three_runs(tmp_path_factory, config_kw):
    root = tmp_path_factory.mktemp("mesh_dialogue")
    with pytest.MonkeyPatch.context() as mp:
        jax_run = run(JaxSystem, JaxConfig, JaxEmbedder, JaxLLM,
                      str(root / "jax"), mp, config_kw=config_kw,
                      mesh=jax_mesh(8))
        mesh_run = run(TorchSystem, TorchConfig, TorchEmbedder, TorchLLM,
                       str(root / "mesh"), mp, config_kw=config_kw,
                       device="cpu", mesh=cpu_mesh())
        one_run = run(TorchSystem, TorchConfig, TorchEmbedder, TorchLLM,
                      str(root / "one"), mp, config_kw=config_kw,
                      device="cpu")
    return jax_run, mesh_run, one_run


@pytest.fixture(scope="module")
def classic(tmp_path_factory):
    return three_runs(tmp_path_factory, CLASSIC)


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    return three_runs(tmp_path_factory, FUSED)


def assert_matches_jax(jrun, trun):
    (jrec, jret), (trec, tret) = jrun, trun
    assert tret == jret                      # chat-turn retrieved ids + modes
    assert [r[0] for r in trec] == [r[0] for r in jrec]
    ranked = [r[1] for r in trec if r[0] == "ranked"][0]
    for j, t in zip(jrec, trec):
        if j[0] in ("nodes", "nodes_bob"):
            assert_snapshots_match(j[1], t[1])
        elif j[0] == "ranked":
            for (jids, js), (tids, ts) in zip(j[1], t[1]):
                assert_same_ranking(jids, js, tids, ts)
        elif j[0] == "top5":
            # the JAX system reloaded the first tenant's rows from its store
            # into new rows, so exact ties rank tie-aware: check the port's
            # top 5 against its own full ranking, as the single-device test
            for ids, (r_ids, _) in zip(t[1], ranked):
                assert ids == [i.partition(":")[2] for i in r_ids[:5]]
        else:
            assert t == j, j[0]


@pytest.mark.parametrize("mode", ["classic", "fused"])
def test_mesh_dialogue_matches_jax_mesh(mode, request):
    jax_run, mesh_run, _ = request.getfixturevalue(mode)
    assert_matches_jax(jax_run, mesh_run)


@pytest.mark.parametrize("mode", ["classic", "fused"])
def test_mesh_dialogue_equals_the_single_device_run(mode, request):
    """Every record (ids, saliences, edge weights, rankings with scores,
    stats) equal to the port's single-device run."""
    _, mesh_run, one_run = request.getfixturevalue(mode)
    assert mesh_run == one_run


def test_mesh_dialogue_exercises_the_slice(classic, fused):
    """Both runs merge a duplicate, build a super node, evict and switch
    tenants; the fused run serves its chat turns on the device."""
    for (_, (trec, tret), _) in (classic, fused):
        nodes = [r[1] for r in trec if r[0] == "nodes"][-1][0]
        assert any(v[4] for v in nodes.values())             # a super node
        assert len([r for r in trec if r[0] == "nodes"][0][1][0]) - 1 <= 40
        assert [r[1] for r in trec if r[0] == "batch_is_top5"] == [True]
    modes = {m for _, _, m in fused[1][1]}
    assert "device" in modes


# --------------------------------------------------------------- layout
@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("capacity", [7, 100, 5000])
def test_capacity_rounds_to_the_jax_mesh_layout(n, capacity):
    """capacity + 1 rounds up to a multiple of lcm(TOPK_BLOCK, n) past a
    block, of n below it; the edge arena to a multiple of n."""
    j = JaxIndex(16, capacity=capacity, edge_capacity=capacity,
                 mesh=jax_mesh(n))
    t = TorchIndex(16, capacity=capacity, edge_capacity=capacity,
                   device="cpu", mesh=cpu_mesh(n))
    assert t.capacity == j.state.capacity
    assert t.edge_state.capacity == j.edge_state.capacity
    assert (t.capacity + 1) % n == 0
    assert [s.salience.shape[0] for s in t.shards] == [(t.capacity + 1) // n] * n


def test_mesh_and_device_must_agree():
    with pytest.raises(ValueError, match="first device"):
        TorchIndex(8, device="cuda", mesh=cpu_mesh(2))
    assert TorchIndex(8, device="cpu", mesh=cpu_mesh(2)).device.type == "cpu"


def _fill(idx, rng, tenants=("a", "b"), batches=5, per=9):
    emb = rng.standard_normal((batches * per, 16)).astype(np.float32)
    for b in range(batches):
        ids = [f"n{b * per + i}" for i in range(per)]
        idx.add(ids, emb[b * per:(b + 1) * per],
                list(rng.random(per) * 0.9), [1_000.0 + i for i in range(per)],
                ["semantic"] * per, ["s%d" % (i % 2) for i in range(per)],
                tenants[b % len(tenants)], [i == 0 for i in range(per)])
    return emb


def test_growth_resplits_rows_and_keeps_ids():
    """From 8 rows (L = 1) to 64 (L = 8) in 5 adds: rows equal the JAX mesh
    index's and the single-device port's, every column equal to the
    single-device port's, searches and link scans equal."""
    rng = np.random.default_rng(0)
    kw = dict(capacity=7, edge_capacity=8, epoch=0.0)
    mesh_idx = TorchIndex(16, device="cpu", mesh=cpu_mesh(8), **kw)
    one = TorchIndex(16, device="cpu", **kw)
    jidx = JaxIndex(16, mesh=jax_mesh(8), **kw)
    for idx in (mesh_idx, one, jidx):
        emb = _fill(idx, np.random.default_rng(0))
    assert mesh_idx.capacity == one.capacity == jidx.state.capacity == 63
    assert mesh_idx._local_n == 8
    assert mesh_idx.id_to_row == one.id_to_row == jidx.id_to_row
    for name in TS.ARENA_FIELDS:
        whole = mesh_idx._column(name)
        np.testing.assert_array_equal(whole[:-1].float().numpy(),
                                      getattr(one.state, name)[:-1].float().numpy(),
                                      err_msg=name)
    q = emb[[3, 20, 40]] + 0.1 * rng.standard_normal((3, 16)).astype(np.float32)
    for tenant in ("a", "b"):
        assert mesh_idx.search_batch(q, tenant, k=7) == \
            one.search_batch(q, tenant, k=7)
        got = mesh_idx.search_batch(q, tenant, k=7)
        want = jidx.search_batch(q, tenant, k=7)
        for (gi, gs), (wi, ws) in zip(got, want):
            assert gi == wi
            np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
    ids = [f"n{i}" for i in range(18, 27)]
    assert (mesh_idx.link_candidates_multi(ids, "a", k=3)
            == one.link_candidates_multi(ids, "a", k=3))
    assert mesh_idx.evict_candidates("a", 5, now=2_000.0) == \
        one.evict_candidates("a", 5, now=2_000.0)
    np.testing.assert_array_equal(mesh_idx.mean_embedding(ids),
                                  one.mean_embedding(ids))


def test_writes_and_reads_route_to_their_owner_shards():
    """Every write of MemorySystem's classic ingest and serving on an
    8-shard index leaves the same columns as on one device."""
    rng = np.random.default_rng(1)
    kw = dict(capacity=63, edge_capacity=64, epoch=0.0)
    mesh_idx = TorchIndex(16, device="cpu", mesh=cpu_mesh(8), **kw)
    one = TorchIndex(16, device="cpu", **kw)
    for idx in (mesh_idx, one):
        _fill(idx, np.random.default_rng(1))
        ids = [f"n{i}" for i in (1, 9, 17, 30, 44)]
        idx.update_access(ids, now=1_500.0)
        idx.boost(ids[:3], now=1_600.0)
        idx.merge_touch(ids[1:], [0.95, 0.1, 0.99, 0.5], now=1_700.0)
        idx.apply_boosts({"n2": (2, 1, 1_800.0), "n40": (0, 3, 1_900.0)},
                         0.05, 0.02)
        idx.add_edges([("n1", "n9", 0.5), ("n9", "n30", 0.3)], "a", now=1.0)
        idx.decay("a", 0.1)
        idx.delete(["n17", "n44"])
        assert idx.prune_edges("a", 0.4) == [("n9", "n30")]
    # every row but the sentinel, which only the single-device index's
    # padded writes touch (a shard's write carries no padding)
    for name, col in mesh_idx.pull_numeric().items():
        np.testing.assert_array_equal(col[:-1], one.pull_numeric()[name][:-1],
                                      err_msg=name)
    rows = [one.id_to_row[i] for i in ("n2", "n40", "n1")]
    for name, col in mesh_idx.pull_numeric_rows(rows).items():
        np.testing.assert_array_equal(col, one.pull_numeric_rows(rows)[name])
    np.testing.assert_array_equal(mesh_idx.get_embedding("n30"),
                                  one.get_embedding("n30"))
    assert mesh_idx.edge_weights() == one.edge_weights()
    assert mesh_idx.stats()["mesh"] == "8x data" and one.stats()["mesh"] is None


def test_from_numpy_splits_a_jax_mesh_index():
    """A JAX 8-way index read back as numpy and loaded into the port's
    meshed index serves the same fused results."""
    from lazzaro_tpu.serve import RetrievalRequest as JaxRequest
    from lazzaro_tpu_torch.serve import RetrievalRequest

    jidx = JaxIndex(16, capacity=63, edge_capacity=64, epoch=0.0,
                    mesh=jax_mesh(8), serve_k_max=16)
    emb = _fill(jidx, np.random.default_rng(2))
    jidx.add_edges([(f"n{i}", f"n{i + 1}", 0.5) for i in range(20)], "a",
                   now=1.0)
    arena = {f: np.asarray(getattr(jidx.state, f)) for f in TS.ARENA_FIELDS}
    edges = {f: np.asarray(getattr(jidx.edge_state, f))
             for f in TS.EDGE_FIELDS}
    meta = {"id_to_row": jidx.id_to_row, "tenants": jidx._tenants,
            "shards": jidx._shards, "edge_slots": dict(jidx.edge_slots),
            "free_rows": jidx._free_rows,
            "free_edge_slots": jidx._free_edge_slots, "epoch": jidx.epoch}
    tidx = TorchIndex.from_numpy(arena, edges, meta, device="cpu",
                                 mesh=cpu_mesh(8), serve_k_max=16)
    kw = dict(cap_take=3, max_nbr=4, super_gate=0.9, acc_boost=0.05,
              nbr_boost=0.02, now=50.0)
    specs = [(emb[2], "a", 5, True), (emb[12], "b", 16, True),
             (emb[30], "a", 3, False)]
    got = tidx.search_fused_requests(
        [RetrievalRequest(query=v, tenant=t, k=k, boost=b)
         for v, t, k, b in specs], **kw)
    want = jidx.search_fused_requests(
        [JaxRequest(query=v, tenant=t, k=k, boost=b)
         for v, t, k, b in specs], **kw)
    for g, w in zip(got, want):
        assert g.ids == w.ids and g.fast == w.fast and g.gate_id == w.gate_id
        np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=1e-6)
    t_num, j_num = tidx.pull_numeric(), jidx.pull_numeric()
    np.testing.assert_array_equal(t_num["access_count"], j_num["access_count"])
    np.testing.assert_allclose(t_num["salience"], j_num["salience"], rtol=0,
                               atol=1e-6)


# ------------------------------------------------------- launches, copies
def test_mesh_chat_turn_is_one_dispatch_and_one_readback(tmp_path,
                                                         monkeypatch):
    """Under a mesh a fused chat turn is one ``search_fused_sharded`` call:
    one two-tier scan per shard, two merges, one packed readback and no
    classic launch; a classic search is one scan per shard and one merge
    (the counterpart of ``tests/test_mesh_system.py``'s dispatch count).
    On the CPU the wrappers run their plain versions, counted here."""
    from lazzaro_tpu_torch.core import index as TI
    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import masked_topk as mt
    from lazzaro_tpu_torch.ops import sharded_merge as sm

    calls = {"fused": 0, "masked": 0, "merge": 0, "serve": 0, "readback": 0}

    def counting(module, name, key):
        orig = getattr(module, name)

        def wrapped(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)

    counting(ft, "fused_topk_reference", "fused")
    counting(mt, "masked_topk_reference", "masked")
    counting(sm, "sharded_merge_reference", "merge")
    counting(TI.S, "search_fused_sharded", "serve")
    counting(TI.MemoryIndex, "_readback", "readback")
    ms = TorchSystem(enable_async=False, db_dir=str(tmp_path), verbose=False,
                     load_from_disk=False, mesh=cpu_mesh(8), device="cpu",
                     config=TorchConfig(ingest_fused=False,
                                        ingest_dedup_fused=False,
                                        auto_consolidate=False))
    try:
        ms.start_conversation()
        ms.chat("I work as a data engineer on a big ETL project.")
        ms.end_conversation()
        ms.start_conversation()
        ms.chat("What do I do for work?")        # builds the CSR
        for key in calls:
            calls[key] = 0
        ms.chat("What do I do for work, the ETL project?")
        assert calls == {"fused": 8, "masked": 0, "merge": 2, "serve": 1,
                         "readback": 1}
        ms.config.serve_fused = False
        for key in calls:
            calls[key] = 0
        ms.search_memories("data engineer")
        assert (calls["masked"], calls["merge"], calls["fused"]) == (8, 1, 0)
        assert ms.get_stats()["mesh_size"] == 8
        assert ms.get_stats()["index"]["mesh"] == "8x data"
    finally:
        ms.close()
