"""Fused IVF serving in the port against the JAX package: the four
``search_fused_ivf*`` programs leaf for leaf (exact and int8 forms, f32 and
bf16 arenas, per-query ``nprobe``), the dedup counter on a fixture with
repeated candidates and a tenant that fills its list at NEG_INF, super rows
that sit in their cluster and in the extras, and the port's versions of
the eleven cases of ``tests/test_fused_ivf_serving.py``.

Tolerances: rows, gate rows, gate verdicts and the integer counters of the
packed readback (``dedup`` included) are equal, and so are access counts
after the boosts. Scores agree within 1e-6 on f32 arenas and 1e-5 on bf16
ones (products exact in f32, summed over d in another order than XLA's
einsum); salience and ``last_accessed`` after the boosts within 1e-6.
"""

import tempfile

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lazzaro_tpu.core import state as JS
from lazzaro_tpu.ops import ivf as JI
from lazzaro_tpu.ops.quant import quantize_rows as jax_quantize_rows
from lazzaro_tpu.utils.batching import unpack_retrieval as jax_unpack
from lazzaro_tpu_torch.config import MemoryConfig
from lazzaro_tpu_torch.core import state as TS
from lazzaro_tpu_torch.core.index import MemoryIndex
from lazzaro_tpu_torch.core.memory_system import MemorySystem
from lazzaro_tpu_torch.ops.quant import quantize_rows
from lazzaro_tpu_torch.serve import RetrievalRequest
from lazzaro_tpu_torch.utils.batching import unpack_retrieval
from tests.test_torch_fused_ingest import ClusteredEmb, QueueLLM
from tests.test_torch_fused_serving import (BOOSTS, CAP_TAKE, K, MAX_NBR,
                                            _args, arena, batch, graph)
from lazzaro_tpu.core.index import build_host_csr as jax_build_host_csr

SCORE_TOL = {np.float32: 1e-6, ml_dtypes.bfloat16: 1e-5}
NPROBE = 6
SLACK = 8


def _tables(cols, seed):
    """A JAX build over the fixture's live rows (16 clusters), extras that
    repeat member rows (a reused slot in a member slot and the fresh
    residual) and carry every super row, as ``pack_extras`` lays them out;
    numpy arrays for both packages."""
    alive = cols["alive"]
    build = JI.build_ivf(jnp.asarray(cols["emb"].astype(np.float32)), alive,
                         n_clusters=16, seed=seed)
    members = np.array(build.members)
    m = members[members >= 0]
    rng = np.random.default_rng(seed)
    fresh = rng.choice(m, size=12, replace=False)
    supers = np.nonzero(cols["is_super"])[0]
    extras = JI.pack_extras(np.asarray(build.residual), fresh.tolist(),
                            supers.tolist())
    return np.array(build.centroids), members, extras


def _fixture(seed, dtype, int8):
    cols = arena(seed)
    cols["emb"] = cols["emb"].astype(dtype)
    keys, id_to_row = graph(cols, seed)
    indptr, nbr = jax_build_host_csr(keys, id_to_row, len(cols["alive"]))
    jstate = JS.ArenaState(**{k: jnp.asarray(v) for k, v in cols.items()})
    tstate = TS.arena_from_numpy(cols, "cpu")
    cent, members, extras = _tables(cols, seed)
    jtabs = (jax_quantize_rows(jstate.emb) if int8 else None,
             jnp.asarray(cent), jnp.asarray(members), jnp.asarray(extras))
    ttabs = (quantize_rows(tstate.emb) if int8 else None,
             torch.from_numpy(cent), torch.from_numpy(members),
             torch.from_numpy(extras))
    return cols, jstate, tstate, (indptr, nbr), jtabs, ttabs


def _nprobe_q(valid):
    npq = np.array([1, 6, 2, 6, 3, 4, 6, 1, 5, 6, 2, 6, 0, 0, 0, 0], np.int32)
    return np.where(valid, npq, 0).astype(np.int32)


def _run(twin, jstate, tstate, csr, jtabs, ttabs, q, valid, tenant, gate_on,
         boost_on, k_q, cap_q, npq, k):
    indptr, nbr = csr
    ja = jtabs + (jnp.asarray(indptr), jnp.asarray(nbr)) + _args(
        q, valid, tenant, gate_on, True)
    ta = ttabs + (torch.from_numpy(indptr), torch.from_numpy(nbr)) + _args(
        q, valid, tenant, gate_on, False)
    scal = tuple(BOOSTS[n] for n in ("now", "super_gate", "acc_boost",
                                     "nbr_boost"))
    st = dict(cap_take=CAP_TAKE, max_nbr=MAX_NBR, slack=SLACK, nprobe=NPROBE,
              k=k)
    jst = None
    if twin == "ragged":
        jst, jp = JS.search_fused_ivf_ragged_copy(
            jstate, *ja, jnp.asarray(boost_on), jnp.asarray(k_q),
            jnp.asarray(cap_q), jnp.asarray(npq),
            *(jnp.float32(v) for v in scal), **st)
        _, tp = TS.search_fused_ivf_ragged(
            tstate, *ta, torch.from_numpy(boost_on), torch.from_numpy(k_q),
            torch.from_numpy(cap_q), torch.from_numpy(npq), *scal, **st)
    elif twin == "static":
        jst, jp = JS.search_fused_ivf_copy(
            jstate, *ja, jnp.asarray(boost_on),
            *(jnp.float32(v) for v in scal), **st)
        _, tp = TS.search_fused_ivf(tstate, *ta, torch.from_numpy(boost_on),
                                    *scal, **st)
    elif twin == "ragged_read":
        jp = JS.search_fused_ivf_ragged_read(
            jstate, *ja, jnp.asarray(k_q), jnp.asarray(npq),
            jnp.float32(BOOSTS["super_gate"]), **st)
        tp = TS.search_fused_ivf_ragged_read(
            tstate, *ta, torch.from_numpy(k_q), torch.from_numpy(npq),
            BOOSTS["super_gate"], **st)
    else:
        jp = JS.search_fused_ivf_read(jstate, *ja,
                                      jnp.float32(BOOSTS["super_gate"]), **st)
        tp = TS.search_fused_ivf_read(tstate, *ta, BOOSTS["super_gate"], **st)
    return jst, np.asarray(jp), tp.numpy()


@pytest.mark.parametrize("int8", [False, True], ids=["exact", "int8"])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("twin", ["ragged", "ragged_read", "static",
                                  "static_read"])
def test_ivf_programs_match_jax(twin, dtype, int8):
    """``search_fused_ivf[_ragged][_read]`` against the JAX programs on one
    arena, one CSR, one build and one batch (per-query k, cap and nprobe,
    pad queries, gate hits and misses, a tenant with three live rows):
    rows, gate rows, verdicts and every counter equal, the dedup counter
    non-zero somewhere, scores within the stated tolerance, the boosted
    columns as the dense programs' test holds them."""
    tol = SCORE_TOL[dtype]
    cols, jstate, tstate, csr, jtabs, ttabs = _fixture(7, dtype, int8)
    q, valid, tenant, gate_on, boost_on, k_q, cap_q = batch(cols, 7)
    k = K if twin.startswith("ragged") else 16
    jst, jp, tp = _run(twin, jstate, tstate, csr, jtabs, ttabs, q, valid,
                       tenant, gate_on, boost_on, k_q, cap_q,
                       _nprobe_q(valid), k)
    assert tp.shape == jp.shape
    j, t = jax_unpack(jp, k), unpack_retrieval(tp, k)
    for i in (1, 3, 4, 5):            # gate rows, ANN rows, verdicts, counters
        np.testing.assert_array_equal(t[i], j[i])
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=tol)
    np.testing.assert_allclose(t[2], j[2], rtol=0, atol=tol)
    assert t[5][:, 1].any()           # the IVF dedup dropped repeats
    assert t[4][[0, 1, 4]].all()      # gate hits through the extras' supers
    if jst is not None:
        for name in ("salience", "last_accessed"):
            np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                       np.asarray(getattr(jst, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(tstate.access_count.numpy(),
                                      np.asarray(jst.access_count))


@pytest.mark.parametrize("int8", [False, True], ids=["exact", "int8"])
def test_dedup_counter_with_fill_and_duplicate_supers(int8):
    """The ``dedup`` counter on a tenant with fewer candidates than k +
    slack in its probed clusters: tenant 3 holds three live rows, so its
    lists fill at NEG_INF with -1 padding and other tenants' rows; every
    member row of the probed clusters also sits in the extras (each valid
    row appears twice) and every super row sits in its cluster and in the
    extras. Counter, rows and gate equal to JAX's."""
    cols, jstate, tstate, csr, _, _ = _fixture(11, np.float32, int8)
    cent, members, _ = _tables(cols, 11)
    m = members[members >= 0]
    supers = np.nonzero(cols["is_super"])[0]
    extras = JI.pack_extras(np.zeros((8,), np.int32) - 1,
                            list(m) + [100, 400, 700], list(supers))
    sh = int8
    jtabs = (jax_quantize_rows(jstate.emb) if sh else None,
             jnp.asarray(cent), jnp.asarray(members), jnp.asarray(extras))
    ttabs = (quantize_rows(tstate.emb) if sh else None,
             torch.from_numpy(cent), torch.from_numpy(members),
             torch.from_numpy(extras))
    q, valid, tenant, gate_on, boost_on, k_q, cap_q = batch(cols, 11)
    _, jp, tp = _run("ragged_read", jstate, tstate, csr, jtabs, ttabs, q,
                     valid, tenant, gate_on, boost_on, k_q, cap_q,
                     _nprobe_q(valid), K)
    j, t = jax_unpack(jp, K), unpack_retrieval(tp, K)
    for i in (1, 3, 4, 5):
        np.testing.assert_array_equal(t[i], j[i])
    np.testing.assert_allclose(t[2], j[2], rtol=0, atol=1e-6)
    ten3 = np.nonzero(tenant == 3)[0]
    assert (t[5][ten3, 0] == 3).all()          # three live rows, the rest fill
    assert (t[5][ten3, 1] > 0).all()           # their repeats counted
    assert (j[3][ten3, 3:] == len(cols["alive"]) - 1).all()   # fill: sentinel


# ------------------------ port of tests/test_fused_ivf_serving.py
def _system(tmp, serve_fused=True, nprobe=4, per=20, super_threshold=100,
            int8=False):
    ms = MemorySystem(
        enable_async=False, db_dir=tmp, verbose=False, load_from_disk=False,
        llm_provider=QueueLLM(per), embedding_provider=ClusteredEmb(),
        auto_prune=False, max_buffer_size=10_000,
        super_node_threshold=super_threshold, device="cpu",
        config=MemoryConfig(journal=False, auto_consolidate=False,
                            decay_rate=0.0, ivf_serving=nprobe,
                            int8_serving=int8, serve_k_max=16))
    ms.config.serve_fused = serve_fused
    return ms


def _ingest_built(ms, convs=2):
    for c in range(convs):
        ms.start_conversation()
        ms.add_to_short_term(f"conv {c}", "episodic", 0.7)
        ms.end_conversation()
    ms.index._IVF_MIN_ROWS = 1
    assert ms.index.ivf_maintenance()
    return ms


_COUNTED = ("search_fused_ivf", "search_fused_ivf_read",
            "search_fused_ivf_ragged", "search_fused_ivf_ragged_read",
            "search_fused_quant", "search_fused_quant_read",
            "search_fused_quant_ragged", "search_fused_quant_ragged_read",
            "search_fused", "search_fused_read", "search_fused_ragged",
            "search_fused_ragged_read", "arena_search",
            "_arena_update_access", "_arena_boost", "_arena_apply_boosts")


def _count_dispatches(monkeypatch):
    calls = {name: 0 for name in _COUNTED}
    for name in _COUNTED:
        orig = getattr(TS, name)

        def wrapped(*a, __orig=orig, __name=name, **kw):
            calls[__name] += 1
            return __orig(*a, **kw)

        monkeypatch.setattr(TS, name, wrapped)
    return calls


def test_one_ivf_dispatch_per_chat_turn(monkeypatch):
    with tempfile.TemporaryDirectory() as tmp:
        ms = _ingest_built(_system(tmp))
        ms.start_conversation()
        ms.chat("fact 3 body")
        calls = _count_dispatches(monkeypatch)
        copies = []
        orig = ms.index._readback
        monkeypatch.setattr(ms.index, "_readback",
                            lambda p: copies.append(1) or orig(p))
        ms.chat("fact 7 body")
        assert calls["search_fused_ivf_ragged"] == 1
        for name in calls:
            if name != "search_fused_ivf_ragged":
                assert calls[name] == 0, (name, calls)
        assert len(copies) == 1
        ms.close()


def test_ivf_search_memories_takes_readonly_twin(monkeypatch):
    with tempfile.TemporaryDirectory() as tmp:
        ms = _ingest_built(_system(tmp))
        ms.search_memories("fact 1 body")
        calls = _count_dispatches(monkeypatch)
        assert ms.search_memories("fact 3 body")
        assert calls["search_fused_ivf_ragged_read"] == 1
        assert calls["search_fused_ivf_ragged"] == 0
        ms.search_memories_batch([f"fact {i} body" for i in range(8)])
        assert calls["search_fused_ivf_ragged_read"] == 2
        ms.close()


def test_ivf_cached_hit_turn_pays_zero_dispatches(monkeypatch):
    with tempfile.TemporaryDirectory() as tmp:
        ms = _ingest_built(_system(tmp))
        ms.start_conversation()
        ms.chat("fact 7 body")
        calls = _count_dispatches(monkeypatch)
        ms.chat("fact 7 body")                 # cache hit
        for name in calls:
            assert calls[name] == 0, (name, calls)
        assert ms._pending_boosts
        ms.end_conversation()
        assert calls["_arena_apply_boosts"] == 1
        ms.close()


def _clustered_fixture(n=10_000, d=48, n_centers=64, seed=42, spread=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lbl = rng.integers(0, n_centers, n)
    emb = centers[lbl] + (spread / np.sqrt(d)) * rng.standard_normal(
        (n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return rng, emb


def _recall(result_rows, truth_rows, k):
    hits = sum(len(set(r) & set(t[:k])) for r, t in
               zip(result_rows, truth_rows))
    return hits / (k * len(result_rows))


_KW = dict(cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
           nbr_boost=0.02)


def _index(emb, nprobe, **kw):
    n = len(emb)
    idx = MemoryIndex(dim=emb.shape[1], capacity=n + 64, ivf_nprobe=nprobe,
                      device="cpu", **kw)
    idx.add([f"m{i}" for i in range(n)], emb, [0.5] * n, [0.0] * n,
            ["semantic"] * n, ["default"] * n, "u0")
    assert idx.ivf_maintenance()
    return idx


@pytest.mark.parametrize("nprobe", [4, 8])
def test_fused_ivf_recall_parity_with_classic_ivf_10k(nprobe):
    n, d, k, nq = 10_000, 48, 10, 64
    rng, emb = _clustered_fixture(n=n, d=d)
    idx = _index(emb, nprobe)
    base = rng.integers(0, n, size=nq)
    queries = emb[base] + (0.3 / np.sqrt(d)) * rng.standard_normal(
        (nq, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    truth = np.argsort(-(queries @ emb.T), axis=1)[:, :k]
    classic = idx.search_batch(queries, "u0", k=k)
    classic_rows = [[idx.id_to_row[i] for i in ids_] for ids_, _ in classic]
    fused = idx.search_fused_requests(
        [RetrievalRequest(query=queries[i], tenant="u0", k=k)
         for i in range(nq)], **_KW)
    fused_rows = [[idx.id_to_row[i] for i in r.ids] for r in fused]
    r_classic = _recall(classic_rows, truth, k)
    r_fused = _recall(fused_rows, truth, k)
    assert r_fused >= r_classic - 1e-9, (r_fused, r_classic)
    assert r_fused >= 0.85, r_fused
    for rows in fused_rows:
        assert len(rows) == len(set(rows))
    # on an f32 arena the fused and classic candidate scans score alike:
    # the same rows
    assert fused_rows == classic_rows


def test_ivf_residual_freshness_through_fused_path():
    n, d = 5_000, 32
    _, emb = _clustered_fixture(n=n, d=d, seed=7)
    idx = _index(emb, 4)
    fresh = np.zeros((4, d), np.float32)
    for i in range(4):
        fresh[i, i] = 1.0
    idx.add([f"f{i}" for i in range(4)], fresh, [0.5] * 4, [0.0] * 4,
            ["semantic"] * 4, ["default"] * 4, "u0")
    res = idx.search_fused_requests(
        [RetrievalRequest(query=fresh[i], tenant="u0", k=3)
         for i in range(4)], **dict(_KW, cap_take=3))
    for i, r in enumerate(res):
        assert r.ids and r.ids[0] == f"f{i}", (i, r.ids)
        assert r.scores[0] > 0.999


def _numeric_cols(ms):
    cols = ms.index.pull_numeric()
    n = len(ms.index.id_to_row)
    return {k: cols[k][: n + 2] for k in ("salience", "access_count")}


def test_ivf_matches_classic_ivf_chat_turns():
    a = _ingest_built(_system(tempfile.mkdtemp(), serve_fused=True))
    b = _ingest_built(_system(tempfile.mkdtemp(), serve_fused=False))
    try:
        a.start_conversation()
        b.start_conversation()
        for q in ("fact 3 body", "fact 17 body", "fact 31 body",
                  "fact 3 body"):
            assert a.chat(q) == b.chat(q)
        a.end_conversation()
        b.end_conversation()
        ca, cb = _numeric_cols(a), _numeric_cols(b)
        np.testing.assert_allclose(ca["salience"], cb["salience"], atol=1e-6)
        np.testing.assert_array_equal(ca["access_count"], cb["access_count"])
        ha = {n: (round(a.buffer.nodes[n].salience, 5),
                  a.buffer.nodes[n].access_count) for n in a.buffer.nodes}
        hb = {n: (round(b.buffer.nodes[n].salience, 5),
                  b.buffer.nodes[n].access_count) for n in b.buffer.nodes}
        assert ha == hb
    finally:
        a.close()
        b.close()


def test_ivf_matches_classic_super_gate_hit():
    def build(serve_fused):
        ms = _ingest_built(_system(tempfile.mkdtemp(),
                                   serve_fused=serve_fused,
                                   super_threshold=5))
        assert ms.super_nodes
        return ms

    a, b = build(True), build(False)
    try:
        sid = sorted(a.super_nodes)[0]
        centroid = np.asarray(a.super_nodes[sid].embedding, np.float32)
        ids_a, mode_a = a._retrieve_for_chat(centroid.tolist(), "probe-q")
        ids_b, mode_b = b._retrieve_for_chat(centroid.tolist(), "probe-q")
        assert ids_a == ids_b
        assert mode_a == "classic" and mode_b == "classic"
        assert ids_a[0] == a.super_nodes[sid].child_ids[0]
        a.start_conversation()
        b.start_conversation()
        a.chat("fact 5 body")
        b.chat("fact 5 body")
        ca, cb = _numeric_cols(a), _numeric_cols(b)
        np.testing.assert_allclose(ca["salience"], cb["salience"], atol=1e-6)
        np.testing.assert_array_equal(ca["access_count"], cb["access_count"])
    finally:
        a.close()
        b.close()


def test_ivf_k_shortfall_guard():
    n, d, k = 256, 16, 10
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    idx = MemoryIndex(dim=d, capacity=511, ivf_nprobe=1, device="cpu")
    ids = [f"m{i}" for i in range(n)]
    idx.add(ids, emb, [0.5] * n, [0.0] * n, ["semantic"] * n,
            ["default"] * n, "u0")
    idx._IVF_MIN_ROWS = 1
    assert idx.ivf_maintenance()
    idx.delete(ids[: n - 12])
    res = idx.search_fused_requests(
        [RetrievalRequest(query=emb[n - 1], tenant="u0", k=k)], **_KW)
    got = res[0].ids
    assert got and len(got) == len(set(got)) and len(got) <= k
    assert all(g in set(ids[n - 12:]) for g in got), got


def test_ivf_int8_composition_single_dispatch(monkeypatch):
    n, d = 5_000, 32
    _, emb = _clustered_fixture(n=n, d=d, seed=13)
    idx = _index(emb, 4, int8_serving=True)
    reqs = [RetrievalRequest(query=emb[i], tenant="u0", k=5)
            for i in range(8)]
    idx.search_fused_requests(reqs, **_KW)
    calls = _count_dispatches(monkeypatch)
    res = idx.search_fused_requests(reqs, **_KW)
    assert calls["search_fused_ivf_ragged_read"] == 1
    assert sum(calls.values()) == 1
    for i, r in enumerate(res):
        assert r.ids[0] == f"m{i}"
        assert r.scores[0] > 0.999


def test_ivf_multi_tenant_batch_isolation():
    n, d = 5_000, 32
    _, emb = _clustered_fixture(n=n, d=d, seed=21)
    idx = MemoryIndex(dim=d, capacity=n + 64, ivf_nprobe=4, device="cpu")
    idx.add([f"m{i}" for i in range(n)], emb, [0.5] * n, [0.0] * n,
            ["semantic"] * n, ["default"] * n, "u0")
    idx.add(["alien"], emb[:1], [0.9], [0.0], ["semantic"], ["default"], "t2")
    assert idx.ivf_maintenance()
    res = idx.search_fused_requests(
        [RetrievalRequest(query=emb[0], tenant="u0", k=5),
         RetrievalRequest(query=emb[0], tenant="t2", k=5)], **_KW)
    assert res[0].ids and res[0].ids[0] == "m0"
    assert "alien" not in res[0].ids
    assert res[1].ids == ["alien"]


def test_no_build_falls_back_to_dense_fused(monkeypatch):
    with tempfile.TemporaryDirectory() as tmp:
        ms = _system(tmp)
        for c in range(2):
            ms.start_conversation()
            ms.add_to_short_term(f"conv {c}", "episodic", 0.7)
            ms.end_conversation()
        assert ms.index._ivf is None
        ms.search_memories("fact 1 body")
        calls = _count_dispatches(monkeypatch)
        assert ms.search_memories("fact 3 body")
        assert calls["search_fused_ragged_read"] == 1
        assert calls["search_fused_ivf_ragged_read"] == 0
        ms.close()


# ------------------------------------------------ per-request nprobe, mesh
def test_per_request_nprobe_and_nprobe_c_is_exact():
    """A request's own ``nprobe`` masks the clusters past it (one clamped to
    [1, the build's]), and ``nprobe = C`` serves the exact ranking."""
    n, d = 5_000, 32
    _, emb = _clustered_fixture(n=n, d=d, seed=31)
    idx = _index(emb, 256)
    c = idx._ivf.n_clusters
    q = emb[:6]
    exact = idx.search_batch(q, "u0", k=10, exact=True)
    full = idx.search_fused_requests(
        [RetrievalRequest(query=q[i], tenant="u0", k=10) for i in range(6)],
        **_KW)
    assert [r.ids for r in full] == [ids for ids, _ in exact]
    assert idx._ivf_fused_pack(16)[3] == c
    one = idx.search_fused_requests(
        [RetrievalRequest(query=q[i], tenant="u0", k=10, nprobe=1)
         for i in range(6)], **_KW)
    zero = idx.search_fused_requests(
        [RetrievalRequest(query=q[i], tenant="u0", k=10, nprobe=-5)
         for i in range(6)], **_KW)
    assert [r.ids for r in one] != [r.ids for r in full]
    assert [r.ids for r in zero] == [r.ids for r in one]   # clamped to 1


def test_mesh_ignores_ivf_with_jax_warning():
    """Under a mesh ``ivf_nprobe`` (and ``MemoryConfig(ivf_serving=...)``)
    warns and serves the exact sharded path, as the JAX index does."""
    from lazzaro_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cpu"] * 2)
    with pytest.warns(UserWarning, match="ivf_serving"):
        idx = MemoryIndex(dim=16, capacity=63, mesh=mesh, ivf_nprobe=8)
    assert idx.ivf_nprobe == 0 and idx.stats()["ivf"] is None
    emb = np.eye(16, dtype=np.float32)
    idx.add([f"m{i}" for i in range(16)], emb, [0.5] * 16, [0.0] * 16,
            ["semantic"] * 16, ["default"] * 16, "u0")
    assert not idx.ivf_maintenance()
    (ids, _), = idx.search_batch(emb[3:4], "u0", k=1)
    assert ids == ["m3"]
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.warns(UserWarning, match="ivf_serving"):
        ms = MemorySystem(enable_async=False, db_dir=tmp, verbose=False,
                          load_from_disk=False, mesh=mesh,
                          embedding_provider=ClusteredEmb(),
                          config=MemoryConfig(
                              journal=False, ivf_serving=8,
                              ingest_fused=False, ingest_dedup_fused=False,
                              auto_consolidate=False))
        assert ms.index.ivf_nprobe == 0
        ms.close()


def test_scheduler_degrade_clamps_nprobe():
    """The breaker's cheap rung clamps ``nprobe`` beside ``cap_take``."""
    from lazzaro_tpu_torch.serve.scheduler import QueryScheduler

    sch = QueryScheduler(lambda reqs: [], degrade_cap_take=2,
                         degrade_nprobe=3)
    try:
        r = sch._degrade(RetrievalRequest(query=np.zeros(4), tenant="u"))
        assert (r.cap_take, r.nprobe) == (2, 3)
        r = sch._degrade(RetrievalRequest(query=np.zeros(4), tenant="u",
                                          cap_take=1, nprobe=8))
        assert (r.cap_take, r.nprobe) == (1, 3)
    finally:
        sch.close()
