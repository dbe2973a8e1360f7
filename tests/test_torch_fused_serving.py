"""Parity of the port's fused serving programs with the JAX twins
(``lazzaro_tpu.core.state.search_fused[_ragged][_read]``) on one arena and
one CSR, and of ``MemoryIndex.search_fused_requests`` on a JAX index carried
across with ``from_numpy``.

The arena has two tenants with super rows, a tenant with no super row (its
gate is empty: score -1e30, row 0), a tenant with fewer live non-super rows
than its k (its tail fills with the lowest other rows at -1e30), dead rows,
and a chain-and-random edge graph. The batch mixes per-query k, pad queries,
gate hits (queries on a super row) and misses, boosting and reading queries.

Tolerances: rows, gate verdicts and the integer counters of the packed
readback must be equal, and so must ``access_count``; f32 scores within 1e-5
(the dot products sum in another order); salience and ``last_accessed``
after the boost scatter within 1e-6 (the same f32 operations in the JAX
order; ``last_accessed`` holds small relative times).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lazzaro_tpu.core import state as JS
from lazzaro_tpu.core.index import MemoryIndex as JaxIndex
from lazzaro_tpu.core.index import build_host_csr as jax_build_host_csr
from lazzaro_tpu.serve import RetrievalRequest as JaxRequest
from lazzaro_tpu.utils.batching import unpack_retrieval as jax_unpack
from lazzaro_tpu_torch.core import state as TS
from lazzaro_tpu_torch.core.index import MemoryIndex as TorchIndex
from lazzaro_tpu_torch.core.index import build_host_csr
from lazzaro_tpu_torch.ops import fused_topk as ft
from lazzaro_tpu_torch.serve import RetrievalRequest
from lazzaro_tpu_torch.utils.batching import unpack_retrieval
from lazzaro_tpu_torch.utils.telemetry import Telemetry

N = 1024                 # rows, the last one the sentinel
CAP = N - 1
D = 32
K = 32                   # the ragged ceiling
CAP_TAKE = 5
MAX_NBR = 8
GATE = 0.9
BOOSTS = dict(now=40.0, super_gate=GATE, acc_boost=0.05, nbr_boost=0.02)


def arena(seed=0):
    """Tenants 0 and 1 with ~3% super rows, tenant 2 without super rows,
    tenant 3 with three live non-super rows, ~10% dead rows."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    tenant = rng.integers(0, 3, N).astype(np.int32)
    tenant[[100, 400, 700]] = 3
    alive = rng.random(N) > 0.1
    alive[[100, 400, 700]] = True
    is_super = (rng.random(N) < 0.03) & (tenant < 2)
    alive[-1], is_super[-1] = False, False
    tenant = np.where(alive, tenant, -1).astype(np.int32)
    return {
        "emb": emb,
        "salience": rng.random(N).astype(np.float32) * 0.9,
        "timestamp": (rng.random(N) * 100).astype(np.float32),
        "last_accessed": (rng.random(N) * 30).astype(np.float32),
        "access_count": rng.integers(0, 20, N).astype(np.int32),
        "type_id": rng.integers(0, 3, N).astype(np.int32),
        "shard_id": rng.integers(0, 3, N).astype(np.int32),
        "tenant_id": tenant,
        "alive": alive,
        "is_super": is_super,
    }


def graph(cols, seed=0):
    """Edge keys over live rows (chains within a tenant plus random pairs,
    one node of high degree) and the id map, as the index keeps them."""
    rng = np.random.default_rng(seed + 1)
    live = np.nonzero(cols["alive"])[0]
    id_to_row = {f"r{r}": int(r) for r in live}
    keys = [(f"r{a}", f"r{b}") for a, b in zip(live[:-1], live[1:])
            if cols["tenant_id"][a] == cols["tenant_id"][b]][::2]
    pairs = rng.choice(live, size=(300, 2))
    keys += [(f"r{a}", f"r{b}") for a, b in pairs if a != b]
    keys += [(f"r{live[5]}", f"r{b}") for b in live[10:40]]
    keys.append(("r_gone", f"r{live[0]}"))           # an id with no row
    return keys, id_to_row


def batch(cols, seed=0, nq=16):
    """A padded batch: 12 live queries, 4 pad rows (tenant -1, k 0)."""
    rng = np.random.default_rng(seed + 2)
    q = rng.standard_normal((nq, D)).astype(np.float32)
    tenant = np.array([0, 1, 2, 3, 0, 1, 0, 1, 2, 0, 1, 3] + [-1] * 4, np.int32)
    sup = {t: np.nonzero(cols["is_super"] & (cols["tenant_id"] == t))[0]
           for t in (0, 1)}
    q[0] = cols["emb"][sup[0][0]] + 0.01 * q[0]       # gate hits
    q[1] = cols["emb"][sup[1][1]] + 0.01 * q[1]
    q[4] = cols["emb"][sup[0][2]] + 0.01 * q[4]
    valid = tenant >= 0
    k_q = np.array([10, 5, 32, 10, 1, 32, 7, 16, 5, 5, 10, 32] + [0] * 4,
                   np.int32)
    cap_q = np.array([5, 5, 5, 5, 1, 5, 3, 5, 5, 2, 5, 5] + [0] * 4, np.int32)
    gate_on = valid & (np.arange(nq) % 5 != 3)
    boost_on = valid & (np.arange(nq) % 4 != 2)
    return q, valid, tenant, gate_on, boost_on, k_q, cap_q


def both(seed=0):
    cols = arena(seed)
    keys, id_to_row = graph(cols, seed)
    indptr, nbr = jax_build_host_csr(keys, id_to_row, N)
    jstate = JS.ArenaState(**{k: jnp.asarray(v) for k, v in cols.items()})
    tstate = TS.arena_from_numpy(cols, "cpu")
    return cols, jstate, tstate, (indptr, nbr)


def assert_packed(jp, tp, k):
    jp, tp = np.asarray(jp), tp.numpy()
    assert tp.shape == jp.shape
    j = jax_unpack(jp, k)
    t = unpack_retrieval(tp, k)
    np.testing.assert_array_equal(t[1], j[1])             # gate rows
    np.testing.assert_array_equal(t[3], j[3])             # ANN rows
    np.testing.assert_array_equal(t[4], j[4])             # gate verdicts
    np.testing.assert_array_equal(t[5], j[5])             # counters
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t[2], j[2], rtol=0, atol=1e-5)
    return t


def assert_boosted_state(jstate, tstate):
    for name in ("salience", "last_accessed"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tstate.access_count.numpy(),
                                  np.asarray(jstate.access_count))


def test_build_host_csr_matches_jax():
    cols = arena()
    keys, id_to_row = graph(cols)
    for min_pad in (0, 4096):
        j = jax_build_host_csr(keys, id_to_row, N, min_pad=min_pad)
        t = build_host_csr(keys, id_to_row, N, min_pad=min_pad)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype


def test_two_tier_plain_version_matches_the_xla_scan():
    """``fused_topk_reference`` equals ``_exact_two_tier`` followed by
    ``_ragged_topk_mask``, the function the kernel is held to."""
    cols, jstate, tstate, _ = both()
    q, _, tenant, _, _, k_q, _ = batch(cols)
    qn = JS.normalize(jnp.asarray(q))
    gs, gr, as_, ar = JS._exact_two_tier(jstate, qn, jnp.asarray(tenant), 1, K)
    as_, ar = JS._ragged_topk_mask(as_, ar, jnp.asarray(k_q), CAP)
    t = ft.fused_topk(tstate.emb, tstate.alive, tstate.tenant_id,
                      tstate.is_super, TS.normalize(torch.from_numpy(q)),
                      torch.from_numpy(tenant), torch.from_numpy(k_q), K,
                      k_live=int(k_q.max()))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(gr)[:, 0])
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(ar))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(gs)[:, 0], atol=1e-5)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(as_), atol=1e-5)
    # the corners the kernel must reproduce
    assert t[1][2].item() == 0 and t[0][2] == -1e30         # no super rows
    live3 = int((t[2][3] > -1e29).sum())
    assert live3 == 3 and t[3][3, 3:10].tolist() == [0, 1, 2, 3, 4, 5, 6]
    assert (t[3][12:] == CAP).all() and (t[2][12:] == -1e30).all()


def _args(q, valid, tenant, gate_on, jax):
    conv = jnp.asarray if jax else torch.from_numpy
    return conv(q), conv(valid), conv(tenant), conv(gate_on)


@pytest.mark.parametrize("ragged", [True, False])
def test_serve_twin_matches_jax(ragged):
    cols, jstate, tstate, (indptr, nbr) = both(1)
    q, valid, tenant, gate_on, boost_on, k_q, cap_q = batch(cols, 1)
    ja = (jnp.asarray(indptr), jnp.asarray(nbr)) + _args(q, valid, tenant,
                                                         gate_on, True)
    ta = (torch.from_numpy(indptr), torch.from_numpy(nbr)) + _args(
        q, valid, tenant, gate_on, False)
    scal = tuple(BOOSTS[n] for n in ("now", "super_gate", "acc_boost",
                                     "nbr_boost"))
    statics = dict(cap_take=CAP_TAKE, max_nbr=MAX_NBR)
    if ragged:
        jstate2, jp = JS.search_fused_ragged_copy(
            jstate, *ja, jnp.asarray(boost_on), jnp.asarray(k_q),
            jnp.asarray(cap_q), *(jnp.float32(v) for v in scal), k=K,
            **statics)
        tstate2, tp = TS.search_fused_ragged(
            tstate, *ta, torch.from_numpy(boost_on), torch.from_numpy(k_q),
            torch.from_numpy(cap_q), *scal, k=K, k_live=int(k_q.max()),
            **statics)
        k = K
    else:
        k = 16
        jstate2, jp = JS.search_fused_copy(
            jstate, *ja, jnp.asarray(boost_on), *(jnp.float32(v) for v in scal),
            k=k, **statics)
        tstate2, tp = TS.search_fused(tstate, *ta, torch.from_numpy(boost_on),
                                      *scal, k=k, **statics)
    assert tstate2 is tstate                              # updated in place
    t = assert_packed(jp, tp, k)
    assert_boosted_state(jstate2, tstate)
    counters, fast = t[5], t[4]
    assert fast[[0, 1, 4]].all() and not fast[2:4].any()    # hits and misses
    assert counters[:, 2].sum() > 0 and counters[:, 3].sum() > 0
    assert (counters[~boost_on, 2:4] == 0).all()


@pytest.mark.parametrize("ragged", [True, False])
def test_read_twin_matches_jax_and_mutates_nothing(ragged):
    cols, jstate, tstate, (indptr, nbr) = both(2)
    q, valid, tenant, gate_on, _, k_q, _ = batch(cols, 2)
    ja = (jnp.asarray(indptr), jnp.asarray(nbr)) + _args(q, valid, tenant,
                                                         gate_on, True)
    ta = (torch.from_numpy(indptr), torch.from_numpy(nbr)) + _args(
        q, valid, tenant, gate_on, False)
    statics = dict(cap_take=CAP_TAKE, max_nbr=MAX_NBR)
    before = {n: getattr(tstate, n).clone() for n in TS.ARENA_FIELDS}
    if ragged:
        jp = JS.search_fused_ragged_read(jstate, *ja, jnp.asarray(k_q),
                                         jnp.float32(GATE), k=K, **statics)
        tp = TS.search_fused_ragged_read(tstate, *ta, torch.from_numpy(k_q),
                                         GATE, k=K, **statics)
        k = K
    else:
        k = 8
        jp = JS.search_fused_read(jstate, *ja, jnp.float32(GATE), k=k,
                                  **statics)
        tp = TS.search_fused_read(tstate, *ta, GATE, k=k, **statics)
    t = assert_packed(jp, tp, k)
    assert (t[5][:, 2:] == 0).all()
    for n in TS.ARENA_FIELDS:
        assert torch.equal(getattr(tstate, n), before[n]), n


def test_boost_scatter_counts_repeats_and_caps_salience():
    """Two queries retrieving the same row bump it twice; the sentinel row
    absorbs every masked entry and stays untouched; salience caps at 1."""
    cols = arena(3)
    cols["salience"][[3, 4]] = 0.99
    jstate = JS.ArenaState(**{k: jnp.asarray(v) for k, v in cols.items()})
    tstate = TS.arena_from_numpy(cols, "cpu")
    acc = np.array([[3, 4, CAP], [3, 7, CAP]], np.int32)
    nbr = np.array([[9, CAP, CAP, CAP], [9, 4, 11, CAP]], np.int32)
    j = JS._boost_scatter(jstate, jnp.asarray(acc), jnp.asarray(nbr),
                          jnp.float32(50.0), jnp.float32(0.05),
                          jnp.float32(0.02))
    TS._boost_scatter(tstate, torch.from_numpy(acc), torch.from_numpy(nbr),
                      torch.tensor(50.0), torch.tensor(0.05),
                      torch.tensor(0.02))
    assert_boosted_state(j, tstate)
    assert tstate.access_count[3] == cols["access_count"][3] + 2
    assert tstate.salience[3] == 1.0
    assert tstate.access_count[CAP] == cols["access_count"][CAP]


# ----------------------------------------------------------- index level
EPOCH = 1_000_000.0


def jax_index(serve_k_max=32, seed=4):
    rng = np.random.default_rng(seed)
    idx = JaxIndex(D, capacity=511, edge_capacity=1024, epoch=EPOCH,
                   serve_k_max=serve_k_max)
    emb = rng.standard_normal((300, D)).astype(np.float32)
    for t, (lo, hi) in enumerate(((0, 150), (150, 290), (290, 300))):
        ids = [f"t{t}:n{i}" for i in range(lo, hi)]
        idx.add(ids, emb[lo:hi], list(rng.random(hi - lo) * 0.8),
                [EPOCH + i for i in range(hi - lo)], ["semantic"] * (hi - lo),
                ["s"] * (hi - lo), f"t{t}",
                [t == 0 and i % 23 == 0 for i in range(hi - lo)])
        idx.add_edges([(a, b, 0.6) for a, b in zip(ids, ids[1:])]
                      + [(ids[0], x, 0.5) for x in ids[2:12]], f"t{t}",
                      now=EPOCH + 5)
    idx.delete(["t1:n160"])
    return idx, emb


def carry(jidx, **kw):
    arena = {f: np.asarray(getattr(jidx.state, f)) for f in TS.ARENA_FIELDS}
    edges = {f: np.asarray(getattr(jidx.edge_state, f)) for f in TS.EDGE_FIELDS}
    meta = {"id_to_row": jidx.id_to_row, "tenants": jidx._tenants,
            "shards": jidx._shards, "edge_slots": dict(jidx.edge_slots),
            "free_rows": jidx._free_rows,
            "free_edge_slots": jidx._free_edge_slots, "epoch": jidx.epoch}
    return TorchIndex.from_numpy(arena, edges, meta, device="cpu", **kw)


def requests(cls, emb):
    sup = emb[0] + 0.01
    specs = [(sup, "t0", 10, True, True), (emb[5], "t0", 5, True, True),
             (emb[200], "t1", 32, False, True), (emb[295], "t2", 10, True, True),
             (emb[7], "t0", 3, False, False), (emb[170], "t1", 100, True, False),
             (emb[9], "nobody", 5, False, True)]
    return [cls(query=q, tenant=t, k=k, gate_enabled=g, boost=b)
            for q, t, k, g, b in specs]


@pytest.mark.parametrize("ragged", [True, False])
def test_index_serves_a_carried_jax_index_alike(ragged):
    jidx, emb = jax_index()
    jidx.serve_ragged = ragged
    tidx = carry(jidx, serve_ragged=ragged, serve_k_max=32)
    kw = dict(cap_take=CAP_TAKE, max_nbr=MAX_NBR, super_gate=0.4,
              acc_boost=0.05, nbr_boost=0.02, now=EPOCH + 30)
    for boost_round in (True, False):
        reqs_j, reqs_t = requests(JaxRequest, emb), requests(RetrievalRequest, emb)
        if not boost_round:
            for r in reqs_j + reqs_t:
                r.boost = False
        jres = jidx.search_fused_requests(reqs_j, **kw)
        tres = tidx.search_fused_requests(reqs_t, **kw)
        for j, t in zip(jres, tres):
            assert t.ids == j.ids
            np.testing.assert_allclose(t.scores, j.scores, rtol=0, atol=1e-5)
            assert (t.gate_id, t.fast, t.boosted) == (j.gate_id, j.fast,
                                                      j.boosted)
            np.testing.assert_allclose(t.gate_score, j.gate_score, atol=1e-5)
        assert tres[0].fast and tres[0].gate_id == "t0:n0"
        assert len(tres[5].ids) == (32 if ragged else 100)
        assert tres[6].ids == []
        pulled_j = jidx.pull_numeric()
        pulled_t = tidx.pull_numeric()
        np.testing.assert_allclose(pulled_t["salience"], pulled_j["salience"],
                                   atol=1e-6)
        np.testing.assert_array_equal(pulled_t["access_count"],
                                      pulled_j["access_count"])


def test_index_csr_follows_edge_and_row_changes():
    jidx, emb = jax_index(seed=5)
    tidx = carry(jidx)
    indptr, nbr = tidx._csr_for(tidx.state)
    assert tidx._csr_for(tidx.state)[0] is indptr        # cached
    j = jax_build_host_csr(list(jidx.edge_slots), jidx.id_to_row, CAP + 1)
    np.testing.assert_array_equal(nbr.numpy(), j[1])
    tidx.add_edges([("t0:n3", "t0:n90", 0.9)], "t0")
    assert tidx._csr_dirty
    indptr2, _ = tidx._csr_for(tidx.state)
    assert indptr2[4] - indptr2[3] == indptr[4] - indptr[3] + 1
    tidx.delete(["t0:n90"])
    assert tidx._csr_dirty
    tidx._csr_for(tidx.state)
    assert not tidx._csr_dirty and tidx.csr_builds == 3


def test_warmup_serving_is_a_no_op_on_the_arena():
    jidx, _ = jax_index(seed=6)
    tidx = carry(jidx, telemetry=Telemetry())
    before = tidx.pull_numeric()
    out = tidx.warmup_serving((1, 8, 20), cap_take=CAP_TAKE, max_nbr=MAX_NBR)
    assert sorted(out) == [("exact", 1), ("exact", 8), ("exact", 24)]
    after = tidx.pull_numeric()
    for name in before:
        np.testing.assert_array_equal(after[name], before[name])
    # serving counters stay muted while warming; the warmup times land
    assert tidx.telemetry.counter_total("serve.dispatches") == 0
    assert len(tidx.telemetry.timer_values("kernel.warmup_ms")) == 3


def test_concurrent_boosts_and_writes_lose_no_update():
    """The scheduler's worker scatters boosts in place while other threads
    write the same columns: the state lock must keep every update. Each
    boosting request bumps exactly ``cap_take`` rows, each ``update_access``
    call its rows once."""
    import sys
    import threading

    from lazzaro_tpu_torch.serve import QueryScheduler

    jidx, emb = jax_index(seed=7)
    tidx = carry(jidx)
    kw = dict(cap_take=CAP_TAKE, max_nbr=MAX_NBR, super_gate=0.99,
              acc_boost=0.0, nbr_boost=0.0)
    sched = QueryScheduler(lambda reqs: tidx.search_fused_requests(reqs, **kw),
                           max_batch=4)
    before = int(tidx.state.access_count[:-1].sum())     # sentinel aside
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def reader(j):
            futs = [sched.submit(RetrievalRequest(
                query=emb[(7 * j + i) % 140], tenant="t0", k=5, boost=True))
                for i in range(10)]
            for f in futs:
                assert len(f.result(timeout=60).ids) == 5

        def writer(j):
            for i in range(20):
                tidx.update_access([f"t1:n{170 + j * 20 + i}"], boost=0.0)

        threads = ([threading.Thread(target=reader, args=(j,)) for j in range(6)]
                   + [threading.Thread(target=writer, args=(j,)) for j in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        sched.close()
    after = int(tidx.state.access_count[:-1].sum())
    assert after - before == 6 * 10 * CAP_TAKE + 2 * 20


def test_host_stage_packs_one_upload_into_typed_views():
    """A dispatch's host columns go up as one buffer; each comes back as a
    view of it with its own dtype and shape, on 16-byte boundaries."""
    from lazzaro_tpu_torch.core.index import HostStage

    rng = np.random.default_rng(4)
    cols = [rng.standard_normal((3, 5)).astype(np.float32),
            np.array([True, False, True]), np.array([2, -1, 9], np.int32),
            np.array([False]), rng.standard_normal((3,)).astype(np.float32)]
    views = HostStage(torch.device("cpu")).upload(cols)
    base = views[0].untyped_storage().data_ptr()
    for v, c in zip(views, cols):
        assert v.dtype == torch.from_numpy(c).dtype and v.shape == c.shape
        assert v.untyped_storage().data_ptr() == base
        assert (v.data_ptr() - base) % HostStage.ALIGN == 0
        assert np.array_equal(v.numpy(), c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_tier_plain_version_matches_xla_at_the_fleet_shape(dtype):
    """``fused_topk_reference`` against ``_exact_two_tier`` +
    ``_ragged_topk_mask`` at the shape the tensor-core route serves: Q = 64,
    K = 128, k_q cycling 5 / 10 / 128, tenants 0 and 1 and the short tenant
    3 (three live rows). Grid rows and unit-axis queries make every score
    exact, so the lists hold long runs of exact ties that must come back in
    row order, and the short tenant's tail lists the lowest other rows."""
    cols = arena(9)
    rng = np.random.default_rng(9)
    cols["emb"] = (rng.integers(-8, 9, size=(N, D)) / 64).astype(np.float32)
    q = np.zeros((64, D), np.float32)
    q[np.arange(64), np.arange(64) % D] = np.where(np.arange(64) < 32, 1.0, -1.0)
    tenant = np.array([(0, 1, 3)[i % 3] for i in range(64)], np.int32)
    k_q = np.array([(5, 10, 128)[i % 3] for i in range(64)], np.int32)
    jcols = {k: jnp.asarray(v) for k, v in cols.items()}
    tcols = TS.arena_from_numpy(cols, "cpu")
    if dtype == "bfloat16":
        jcols["emb"] = jcols["emb"].astype(jnp.bfloat16)
        tcols.emb = tcols.emb.to(torch.bfloat16)
    jstate = JS.ArenaState(**jcols)
    gs, gr, as_, ar = JS._exact_two_tier(jstate, JS.normalize(jnp.asarray(q)),
                                         jnp.asarray(tenant), 1, 128)
    as_, ar = JS._ragged_topk_mask(as_, ar, jnp.asarray(k_q), CAP)
    t = ft.fused_topk(tcols.emb, tcols.alive, tcols.tenant_id, tcols.is_super,
                      TS.normalize(torch.from_numpy(q)), torch.from_numpy(tenant),
                      torch.from_numpy(k_q), 128, k_live=128)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(gr)[:, 0])
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(ar))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(gs)[:, 0])
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(as_))
    ann = t[2].numpy()
    assert (ann[:, 1:] == ann[:, :-1])[ann[:, 1:] > -1e29].any()   # exact ties
    short = [i for i in range(64) if tenant[i] == 3 and k_q[i] > 3]
    assert short and all(t[3][i, 3:6].tolist() == [0, 1, 2] for i in short)
