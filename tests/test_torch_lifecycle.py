"""The all-tenant lifecycle sweep of the port (``MemoryIndex.lifecycle_sweep``,
``MemorySystem.lifecycle_tick``) against the JAX package's and against the
port's own classic loop, on the fixtures of ``tests/test_lifecycle.py``.

The cases of ``tests/test_lifecycle.py``: one sweep is one dispatch and one
device-to-host copy with no classic decay, prune or evict call (one device
and a 2-way CPU mesh); bit parity with the classic loop (both, churn after
the sweep); the multi-pass closed form; the ``_EdgeSlotMap`` reverse index;
freed prune slots reused; the tenant-scoped cache flush; the fused tick
equal to the classic one at system level (no tiering: ``archived`` is 0);
deferral while the scheduler is busy; the pump; the decay replay across a
store restart. Left out: ``test_classic_decay_is_one_dispatch`` (the port
has no jitted programs to count: its ``decay`` is one plain function),
``test_demote_queue_feeds_watermark_demotions`` (tiering, ROADMAP
Queue 1 item 17) and ``test_lifecycle_geometry_admission`` (the planner,
item 19).

Against the JAX package: the payload, the arena and edge columns, the
removed edges and the verdicts of one sweep on the same fixture, to the bit
at one pass, on one device and on a 2-way mesh; at 2 to 64 owed passes the
closed form ``(1 - rate) ** p`` goes through each package's ``pow``
(XLA's on the CPU, ``torch.pow``), which need not agree in the last bit, so
saliences and weights are held within 1 ulp there (rows, verdicts, removed
edges and counters still exact). The importance of every row is bit-equal
to the JAX program's (the compiled JAX program fuses the weighted sum's
multiply-adds; eager f32 ops rounding each apart differ on some rows).
"""

import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lazzaro_tpu.core import state as JS
from lazzaro_tpu.core.index import MemoryIndex as JaxIndex
from lazzaro_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lazzaro_tpu_torch import MemoryConfig, MemorySystem
from lazzaro_tpu_torch.core import state as S
from lazzaro_tpu_torch.core.index import MemoryIndex, _EdgeSlotMap
from lazzaro_tpu_torch.core.query_cache import QueryCache
from lazzaro_tpu_torch.parallel import make_mesh
from tests.test_lifecycle import (FLOOR, RATE, TENANTS, THRESH, WEIGHTS, D,
                                  _ClusteredEmb, _FactLLM, _fill)


def _index(mesh=None, cap=64, ecap=128, pkg="port"):
    if pkg == "jax":
        return _fill(JaxIndex(dim=D, capacity=cap, edge_capacity=ecap,
                              mesh=mesh, epoch=0.0))
    return _fill(MemoryIndex(dim=D, capacity=cap, edge_capacity=ecap,
                             mesh=mesh, epoch=0.0,
                             device=None if mesh is not None else "cpu"))


def _mesh2():
    return make_mesh(devices=["cpu"] * 2)


def _classic(idx, archive_k=4, now=200.0):
    removed, verdicts = [], {}
    for t in TENANTS:
        idx.decay(t, RATE, FLOOR)
        removed.extend(idx.prune_edges(t, THRESH))
        verdicts[t] = idx.evict_candidates(t, archive_k, now=now,
                                           weights=WEIGHTS)
    return removed, verdicts


def _sweep(idx, archive_k=4, now=200.0, passes=None):
    return idx.lifecycle_sweep(passes or {t: 1 for t in TENANTS},
                               rate=RATE, salience_floor=FLOOR,
                               prune_threshold=THRESH, weights=WEIGHTS,
                               archive_k=archive_k, now=now)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _arena_col(idx, col):
    if isinstance(idx, MemoryIndex):
        return _np(idx._column(col))
    return np.asarray(getattr(idx.state, col))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_parity(a, b):
    """Arena columns and the edge pool bit-equal between two indexes of
    either package (``b`` may be mesh-padded: the prefix is compared)."""
    ncap = a.capacity if isinstance(a, MemoryIndex) else a.state.capacity
    for col in ("salience", "last_accessed", "access_count", "tenant_id"):
        np.testing.assert_array_equal(_bits(_arena_col(a, col)[:ncap]),
                                      _bits(_arena_col(b, col)[:ncap]),
                                      err_msg=col)
    ecap = a.edge_state.capacity
    for col in ("src", "tgt", "weight", "alive", "tenant_id"):
        np.testing.assert_array_equal(
            _bits(_np(getattr(a.edge_state, col))[:ecap]),
            _bits(_np(getattr(b.edge_state, col))[:ecap]), err_msg=f"edge.{col}")


# ----------------------------------------------------- dispatch counters
_COUNTED = ("lifecycle_sweep", "lifecycle_sweep_sharded", "_decay_fused",
            "_arena_decay", "_edges_decay", "_edges_prune",
            "arena_evict_candidates", "sharded_merge")


def _count_calls(monkeypatch, idx):
    calls = {name: 0 for name in _COUNTED + ("readback",)}
    for name in _COUNTED:
        orig = getattr(S, name)

        def wrapped(*a, __orig=orig, __name=name, **kw):
            calls[__name] += 1
            return __orig(*a, **kw)

        monkeypatch.setattr(S, name, wrapped)
    orig_rb = idx._readback

    def readback(packed):
        calls["readback"] += 1
        return orig_rb(packed)

    monkeypatch.setattr(idx, "_readback", readback)
    return calls


@pytest.mark.parametrize("meshed", [False, True], ids=["one_device", "mesh2"])
def test_sweep_is_one_dispatch_and_one_copy(monkeypatch, meshed):
    """An all-tenant sweep (3 tenants x decay + prune + verdicts) is ONE
    call of the sweep program and ONE device-to-host copy, with no classic
    decay, prune or evict call; under the mesh its verdicts merge in ONE
    ``sharded_merge`` call."""
    idx = _index(mesh=_mesh2() if meshed else None)
    calls = _count_calls(monkeypatch, idx)
    before = idx.lifecycle_dispatch_count
    out = _sweep(idx)
    assert idx.lifecycle_dispatch_count - before == 1
    assert out["dispatches"] == 1
    program = "lifecycle_sweep_sharded" if meshed else "lifecycle_sweep"
    assert calls[program] == 1 and calls["readback"] == 1, calls
    assert calls["sharded_merge"] == int(meshed), calls
    for name in _COUNTED:
        if name not in (program, "sharded_merge"):
            assert calls[name] == 0, (name, calls)
    assert out["decayed_rows"] == 30 and out["decayed_edges"] == 27
    assert out["pruned_edges"] > 0 and not out["prune_overflow"]


# ------------------------------------------------------------ bit parity
def test_sweep_bit_parity_single_device():
    """Sweep vs the classic loop of the port: arena columns, edge pool,
    removed edges, free list and verdicts bit-equal, and after churn."""
    a, b = _index(), _index()
    removed_a, verdicts_a = _classic(a)
    out = _sweep(b)
    _assert_parity(a, b)
    assert sorted(removed_a) == sorted(out["removed_edges"])
    assert sorted(a._free_edge_slots) == sorted(b._free_edge_slots)
    assert set(a.edge_slots) == set(b.edge_slots)
    for t in TENANTS:
        assert verdicts_a[t] == [(n, i) for n, i, _r in out["verdicts"][t]]
    for idx in (a, b):
        rng = np.random.RandomState(11)
        idx.add([f"alice:x{i}" for i in range(4)],
                rng.randn(4, D).astype(np.float32), [0.6] * 4,
                [210.0] * 4, ["episodic"] * 4, ["s0"] * 4, "alice")
    _assert_parity(a, b)
    assert _sweep(a)["verdicts"] == _sweep(b)["verdicts"]
    _assert_parity(a, b)


def test_sweep_bit_parity_mesh():
    """2-way mesh sweep vs the one-device classic loop: per-shard decay,
    the edge prune and the merged verdicts reproduce it bit for bit,
    before and after churn."""
    a, b = _index(), _index(mesh=_mesh2())
    removed_a, verdicts_a = _classic(a)
    out = _sweep(b)
    _assert_parity(a, b)
    assert sorted(removed_a) == sorted(out["removed_edges"])
    for t in TENANTS:
        assert verdicts_a[t] == [(n, i) for n, i, _r in out["verdicts"][t]]
    for idx in (a, b):
        rng = np.random.RandomState(11)
        idx.add([f"bob:x{i}" for i in range(5)],
                rng.randn(5, D).astype(np.float32), [0.3] * 5,
                [150.0] * 5, ["episodic"] * 5, ["s0"] * 5, "bob")
    removed_a, verdicts_a = _classic(a, now=260.0)
    out = _sweep(b, now=260.0)
    _assert_parity(a, b)
    assert sorted(removed_a) == sorted(out["removed_edges"])
    for t in TENANTS:
        assert verdicts_a[t] == [(n, i) for n, i, _r in out["verdicts"][t]]


def test_sweep_multi_pass_matches_closed_form():
    """Catch-up ticks (owed passes > 1) take the closed form; a tenant that
    owes nothing is untouched."""
    idx = _index()
    _sweep(idx, passes={"alice": 3})
    sal = idx.state.salience.numpy()
    want = FLOOR + (0.5 - FLOOR) * (1.0 - RATE) ** 3
    assert sal[idx.id_to_row["alice:n5"]] == pytest.approx(want, abs=1e-6)
    assert sal[idx.id_to_row["bob:n5"]] == np.float32(0.5)


# ---------------------------------------------- O(pruned) host cleanup
def test_edge_slot_map_reverse_index_stays_consistent():
    idx = _index()
    es = idx.edge_slots
    assert isinstance(es, _EdgeSlotMap)
    assert es.by_slot == {v: k for k, v in es.items()}
    out = _sweep(idx)
    assert out["removed_edges"]
    es = idx.edge_slots
    assert es.by_slot == {v: k for k, v in es.items()}
    for key in out["removed_edges"]:
        assert key not in es
    rebuilt = _EdgeSlotMap(dict(es))
    assert rebuilt.by_slot == es.by_slot
    rebuilt[("x", "y")] = 97
    assert rebuilt.by_slot[97] == ("x", "y")
    del rebuilt[("x", "y")]
    assert 97 not in rebuilt.by_slot


def test_prune_returns_slots_and_frees_them():
    """Freed prune slots go back to the free list, are dead on the device
    and are the next edges' slots."""
    idx = _index()
    free0 = len(idx._free_edge_slots)
    live0 = len(idx.edge_slots)
    out = _sweep(idx)
    removed = out["removed_edges"]
    assert removed
    assert len(idx._free_edge_slots) == free0 + len(removed)
    assert len(idx.edge_slots) == live0 - len(removed)
    freed = idx._free_edge_slots[-len(removed):]
    alive = idx.edge_state.alive.numpy()
    assert not alive[freed].any()
    m = min(8, len(removed))                   # the free list pops its end
    idx.add_edges([("alice:n0", f"alice:n{i}", 0.9) for i in range(2, 2 + m)],
                  "alice")
    assert {idx.edge_slots[("alice:n0", f"alice:n{i}")]
            for i in range(2, 2 + m)} == set(freed[-m:])


def test_query_cache_invalidate_is_tenant_scoped():
    qc = QueryCache(max_size=16)
    qc.set_results("qa", ["n1"], tenant="alice")
    qc.set_results("qb", ["n2"], tenant="bob")
    qc.set_results("qu", ["n3"])
    qc.invalidate_results("alice")
    assert qc.get_results("qa", "alice") is None
    assert qc.get_results("qb", "bob") == ["n2"]
    assert qc.get_results("qu") is None
    qc.invalidate_results()
    assert qc.get_results("qb", "bob") is None


# -------------------------------------------------- against the JAX package
def _jax_mesh2():
    return jax_make_mesh(("data",), (2,), devices=jax.devices()[:2])


@pytest.mark.parametrize("meshed", [False, True], ids=["one_device", "mesh2"])
def test_sweep_equals_jax(meshed):
    """One sweep at one pass: arena and edge columns, removed edges,
    counters, verdict ids, rows and importance bits equal to
    ``lazzaro_tpu``'s on the same fixture, and again after churn."""
    j = _index(mesh=_jax_mesh2() if meshed else None, pkg="jax")
    t = _index(mesh=_mesh2() if meshed else None)
    for now in (200.0, 5e5):
        oj, ot = _sweep(j, now=now), _sweep(t, now=now)
        _assert_parity(j, t)
        assert sorted(oj["removed_edges"]) == sorted(ot["removed_edges"])
        for key in ("decayed_rows", "decayed_edges", "pruned_edges",
                    "prune_total", "prune_overflow", "dispatches"):
            assert oj[key] == ot[key], key
        for tenant in TENANTS:
            vj, vt = oj["verdicts"][tenant], ot["verdicts"][tenant]
            assert [(n, r) for n, _, r in vj] == [(n, r) for n, _, r in vt]
            np.testing.assert_array_equal(
                np.float32([i for _, i, _ in vj]).view(np.int32),
                np.float32([i for _, i, _ in vt]).view(np.int32))
        for idx in (j, t):
            rng = np.random.RandomState(5)
            idx.add([f"carol:y{i}" for i in range(3)],
                    rng.randn(3, D).astype(np.float32), [0.21] * 3,
                    [90.0] * 3, ["semantic"] * 3, ["s1"] * 3, "carol")


def _state_pair(seed, n=96, e=160, tenants=3):
    """The same random arena and edge pool as JAX states and port states:
    saliences, access counts and ages over every range the sweep reads."""
    rng = np.random.default_rng(seed)
    arena = {
        "emb": rng.standard_normal((n, 8)).astype(np.float32),
        "salience": rng.random(n).astype(np.float32),
        "timestamp": np.zeros(n, np.float32),
        "last_accessed": (rng.random(n) * 4e5).astype(np.float32),
        "access_count": rng.integers(0, 25, n).astype(np.int32),
        "type_id": np.zeros(n, np.int32),
        "shard_id": np.zeros(n, np.int32),
        "tenant_id": rng.integers(-1, tenants, n).astype(np.int32),
        "alive": rng.random(n) < 0.85,
        "is_super": rng.random(n) < 0.1}
    edges = {
        "src": rng.integers(0, n, e).astype(np.int32),
        "tgt": rng.integers(0, n, e).astype(np.int32),
        "weight": rng.random(e).astype(np.float32),
        "co": np.ones(e, np.int32),
        "last_updated": np.zeros(e, np.float32),
        "alive": rng.random(e) < 0.8,
        "tenant_id": rng.integers(-1, tenants, e).astype(np.int32)}
    ja = JS.ArenaState(**{k: jnp.asarray(v) for k, v in arena.items()})
    je = JS.EdgeState(**{k: jnp.asarray(v) for k, v in edges.items()})
    return ja, je, S.arena_from_numpy(arena, "cpu"), S.edges_from_numpy(edges, "cpu")


def _both_sweeps(seed, passes, prune_cap=256, archive_k=8, rate=0.05):
    ja, je, ta, te = _state_pair(seed)
    tids = np.asarray([0, 1, 2, -1, -1, -1, -1, -1], np.int32)
    scal = (rate, 0.2, 0.4, 4e5, 0.37, 0.41, 0.22)
    ja, je, jp = JS.lifecycle_sweep(
        ja, je, jnp.asarray(passes), jnp.asarray(tids),
        *map(jnp.float32, scal), prune_cap=prune_cap, archive_k=archive_k)
    _, _, tp = S.lifecycle_sweep(ta, te, torch.from_numpy(passes),
                                 torch.from_numpy(tids), *scal,
                                 prune_cap=prune_cap, archive_k=archive_k)
    return (ja, je, np.asarray(jp)), (ta, te, tp.numpy())


def test_sweep_payload_bits_equal_jax_at_one_pass():
    """The flat payload (verdict importances and rows, pruned slots,
    counters) and the written columns bit-equal to JAX's program at one
    owed pass, with padded verdict tenants and weights that are not powers
    of two (the importance rounding shows)."""
    passes = np.asarray([1, 1, 0, 0, 0, 0, 0, 0], np.int32)
    (ja, je, jp), (ta, te, tp) = _both_sweeps(3, passes)
    np.testing.assert_array_equal(jp.view(np.int32), tp.view(np.int32))
    np.testing.assert_array_equal(np.asarray(ja.salience).view(np.int32),
                                  ta.salience.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(je.weight).view(np.int32),
                                  te.weight.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(je.alive), te.alive.numpy())


@pytest.mark.parametrize("p", [2, 3, 5, 16, 64])
def test_sweep_closed_form_within_one_ulp_of_jax(p):
    """At p > 1 owed passes each package takes its own ``pow``: saliences
    and weights within 1 ulp of JAX's (every row and counter exact where no
    weight straddles the threshold)."""
    passes = np.asarray([p, 1, p, 0, 0, 0, 0, 0], np.int32)
    (ja, je, jp), (ta, te, tp) = _both_sweeps(7, passes)

    def ulps(a, b):
        return np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max()

    assert ulps(np.asarray(ja.salience), ta.salience.numpy()) <= 1
    assert ulps(np.asarray(je.weight), te.weight.numpy()) <= 1
    np.testing.assert_array_equal(np.asarray(je.alive), te.alive.numpy())
    tail = S.LIFECYCLE_TAIL
    np.testing.assert_array_equal(jp[-tail:].view(np.int32),
                                  tp[-tail:].view(np.int32))
    k = 8 * 8
    np.testing.assert_array_equal(jp[k:].view(np.int32), tp[k:].view(np.int32))
    np.testing.assert_allclose(tp[:k], jp[:k], rtol=1e-6)


def test_prune_cap_overflow_and_total_equal_jax():
    """Every weak edge of the tick in one tenant past a small cap: the
    overflow flag and the weak total (counted past the cap) equal JAX's,
    and the edges past the cap stay alive."""
    passes = np.asarray([1, 1, 1, 0, 0, 0, 0, 0], np.int32)
    (ja, je, jp), (ta, te, tp) = _both_sweeps(11, passes, prune_cap=8)
    np.testing.assert_array_equal(jp.view(np.int32), tp.view(np.int32))
    tail = tp[-S.LIFECYCLE_TAIL:].view(np.int32)
    assert tail[4] == 1 and tail[3] > tail[2] == 8
    np.testing.assert_array_equal(np.asarray(je.alive), te.alive.numpy())


def test_importance_bits_equal_jax():
    """``arena_importance`` gives the JAX program's bits on every row: the
    compiled JAX form fuses its multiply-adds (one rounding each); an
    eager f32 sum, each step rounded, differs on some rows (5,802 of
    200,000 random ones)."""
    ja, _, ta, _ = _state_pair(1, n=4096)
    for w in ((0.5, 0.3, 0.2), (0.37, 0.41, 0.22)):
        for now in (0.0, 1234.5, 4e5, 3.3e7):
            got = S.arena_importance(ta, now, *w).numpy()
            want = np.asarray(JS.arena_importance(
                ja, jnp.float32(now), *map(jnp.float32, w)))
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


def test_sweep_read_twin_mutates_nothing():
    ja, je, ta, te = _state_pair(2)
    passes = torch.tensor([1, 2, 1, 0, 0, 0, 0, 0], dtype=torch.int32)
    tids = torch.tensor([0, 1, 2, -1, -1, -1, -1, -1], dtype=torch.int32)
    scal = (0.05, 0.2, 0.4, 4e5, 0.5, 0.3, 0.2)
    sal, w, alive = (ta.salience.clone(), te.weight.clone(), te.alive.clone())
    read = S.lifecycle_sweep_read(ta, te, passes, tids, *scal, prune_cap=64,
                                  archive_k=8)
    assert torch.equal(ta.salience, sal) and torch.equal(te.weight, w)
    assert torch.equal(te.alive, alive)
    _, _, payload = S.lifecycle_sweep(ta, te, passes, tids, *scal,
                                      prune_cap=64, archive_k=8)
    assert torch.equal(read.view(torch.int32), payload.view(torch.int32))


def test_mesh_verdicts_with_a_tenant_absent_from_a_shard():
    """A tenant with fewer live rows than ``archive_k`` on one shard and
    none on the other: the masked entries ride the merge as the sentinel
    and the decode drops them, as one device and JAX's mesh give."""
    rows = {"port": [], "jax": [], "one": []}
    for pkg, mesh in (("port", _mesh2()), ("jax", _jax_mesh2()),
                      ("one", None)):
        cls = JaxIndex if pkg == "jax" else MemoryIndex
        kw = {} if pkg == "jax" else ({"device": "cpu"} if mesh is None else {})
        idx = cls(dim=D, capacity=63, edge_capacity=16, mesh=mesh,
                  epoch=0.0, **kw)
        rng = np.random.RandomState(3)
        idx.add([f"a{i}" for i in range(40)],
                rng.randn(40, D).astype(np.float32), [0.5] * 40, [0.0] * 40,
                ["semantic"] * 40, ["s"] * 40, "alice")
        idx.add(["d0", "d1", "d2"], rng.randn(3, D).astype(np.float32),
                [0.3, 0.2, 0.4], [0.0] * 3, ["semantic"] * 3, ["s"] * 3,
                "dave")
        out = idx.lifecycle_sweep({"alice": 1, "dave": 1}, rate=RATE,
                                  salience_floor=FLOOR,
                                  prune_threshold=THRESH, weights=WEIGHTS,
                                  archive_k=8, now=100.0)
        rows[pkg] = out["verdicts"]
    assert [r for _, _, r in rows["one"]["dave"]] == [41, 40, 42]   # shard 1
    assert rows["port"] == rows["one"] == rows["jax"]


# ------------------------------------------------------ system tick + pump
def _system(tmp, fused=True, interval=0.0, load=False, per=12, **cfg_kw):
    return MemorySystem(
        enable_async=False, db_dir=tmp, verbose=False, load_from_disk=load,
        llm_provider=_FactLLM(per), embedding_provider=_ClusteredEmb(),
        auto_prune=False, max_buffer_size=10_000, device="cpu",
        config=MemoryConfig(journal=False, auto_consolidate=False,
                            decay_rate=RATE, salience_floor=FLOOR,
                            prune_threshold=THRESH, lifecycle_fused=fused,
                            lifecycle_interval_s=interval,
                            lifecycle_archive_k=4,
                            importance_w_salience=WEIGHTS[0],
                            importance_w_access=WEIGHTS[1],
                            importance_w_recency=WEIGHTS[2], **cfg_kw))


def _seed_system(ms):
    ms.start_conversation()
    ms.add_to_short_term("conv 0", "episodic", 0.7)
    ms.end_conversation()
    return sorted(nid for nid in ms.buffer.nodes)


def test_lifecycle_tick_fused_matches_classic():
    """``lifecycle_fused`` on vs off over identical graphs: the same
    salience bits, pruned edges and verdicts; no tiering, so nothing is
    archived; host mirrors synced to the arena."""
    with tempfile.TemporaryDirectory() as ta, \
            tempfile.TemporaryDirectory() as tb:
        msa, msb = _system(ta, fused=False), _system(tb, fused=True)
        try:
            _seed_system(msa)
            _seed_system(msb)
            for now in (200.0, 9e5):
                outa = msa.lifecycle_tick(now=now, force=True)
                outb = msb.lifecycle_tick(now=now, force=True)
                assert not outa["deferred"] and not outb["deferred"]
                assert sorted(outa["removed_edges"]) == \
                    sorted(outb["removed_edges"])
                assert outa["pruned_hosts"] == outb["pruned_hosts"]
                assert {t: [n for n, *_ in v] for t, v in outa["verdicts"].items()} \
                    == {t: [n for n, *_ in v] for t, v in outb["verdicts"].items()}
                assert outb["verdicts"]["default"]
                np.testing.assert_array_equal(
                    msa.index.state.salience.numpy().view(np.int32),
                    msb.index.state.salience.numpy().view(np.int32))
                np.testing.assert_array_equal(
                    msa.index.edge_state.alive.numpy(),
                    msb.index.edge_state.alive.numpy())
                assert outa["archived"] == outb["archived"] == 0
            assert getattr(msb.index, "tiering", None) is None
            assert msa._decay_pass == msb._decay_pass == 3
            assert set(msa._edge_shard) == set(msb._edge_shard)
            sal = msb.index.state.salience.numpy()
            for qid, row in msb.index.id_to_row.items():
                node = msb.buffer.get_node(qid.partition(":")[2])
                if node is not None:
                    assert np.float32(node.salience) == sal[row], qid
        finally:
            msa.close()
            msb.close()


def test_lifecycle_tick_equals_jax_system():
    """The port's ``lifecycle_tick`` against the JAX system's on the same
    dialogue: salience bits, removed edges and verdicts."""
    from lazzaro_tpu.config import MemoryConfig as JaxConfig
    from lazzaro_tpu.core.memory_system import MemorySystem as JaxSystem

    with tempfile.TemporaryDirectory() as ta, \
            tempfile.TemporaryDirectory() as tb:
        cfg = dict(journal=False, auto_consolidate=False, decay_rate=RATE,
                   salience_floor=FLOOR, prune_threshold=THRESH,
                   lifecycle_archive_k=4)
        kw = dict(enable_async=False, verbose=False, load_from_disk=False,
                  auto_prune=False, max_buffer_size=10_000)
        jms = JaxSystem(db_dir=ta, llm_provider=_FactLLM(12),
                        embedding_provider=_ClusteredEmb(),
                        config=JaxConfig(**cfg), **kw)
        tms = MemorySystem(db_dir=tb, llm_provider=_FactLLM(12),
                           embedding_provider=_ClusteredEmb(),
                           config=MemoryConfig(**cfg), device="cpu", **kw)
        try:
            _seed_system(jms)
            _seed_system(tms)
            for now in (200.0, 3e6):
                oj = jms.lifecycle_tick(now=now, force=True)
                ot = tms.lifecycle_tick(now=now, force=True)
                assert sorted(oj["removed_edges"]) == sorted(ot["removed_edges"])
                assert oj["verdicts"] == ot["verdicts"]
                np.testing.assert_array_equal(
                    np.asarray(jms.index.state.salience).view(np.int32),
                    tms.index.state.salience.numpy().view(np.int32))
        finally:
            jms.close()
            tms.close()


def test_tick_defers_while_scheduler_busy():
    class Busy:
        closed = False

        @staticmethod
        def load():
            return 3

    with tempfile.TemporaryDirectory() as tmp:
        ms = _system(tmp)
        try:
            _seed_system(ms)
            ms.query_scheduler = Busy()
            assert ms.lifecycle_tick() == {"deferred": True}
            assert ms.telemetry.counter_total("lifecycle.deferred_busy") == 1
            assert not ms.lifecycle_tick(force=True)["deferred"]
            assert ms.telemetry.counter_total("lifecycle.ticks") == 1
        finally:
            ms.query_scheduler = None
            ms.close()


def test_lifecycle_pump_runs_ticks():
    """``lifecycle_interval_s > 0`` with ``enable_async`` starts the pump;
    ``close()`` stops it."""
    with tempfile.TemporaryDirectory() as tmp:
        ms = MemorySystem(
            enable_async=True, db_dir=tmp, verbose=False,
            load_from_disk=False, embedding_provider=_ClusteredEmb(),
            device="cpu",
            config=MemoryConfig(journal=False, auto_consolidate=False,
                                lifecycle_interval_s=0.05))
        try:
            assert ms.lifecycle_pump is not None
            deadline = time.time() + 10.0
            while (time.time() < deadline
                   and ms.telemetry.counter_total("lifecycle.ticks") == 0):
                time.sleep(0.05)
            assert ms.telemetry.counter_total("lifecycle.ticks") > 0
        finally:
            ms.close()
        assert not ms.lifecycle_pump._thread.is_alive()


def test_decay_replay_bit_parity_across_restart():
    """Stamps survive a store restart and the restarted system replays the
    missed passes to the bits of a system that never restarted, before
    and after further sweeps."""
    def bits(ms):
        sal = ms.index.state.salience.numpy()
        return {qid: sal[row].view(np.int32).item()
                for qid, row in ms.index.id_to_row.items()}

    with tempfile.TemporaryDirectory() as ta, \
            tempfile.TemporaryDirectory() as tb:
        msa, msb = _system(ta), _system(tb)
        try:
            _seed_system(msa)
            _seed_system(msb)
            for _ in range(3):
                msa.lifecycle_tick(now=200.0, force=True)
                msb.lifecycle_tick(now=200.0, force=True)
            msb.store.save_sys_meta(
                {"decay_pass": msb._decay_pass,
                 "node_counter": msb.node_counter}, user_id=msb.user_id)
            msb.close()
            msb = _system(tb, load=True)
            assert msb._decay_pass == msa._decay_pass == 4
            assert bits(msa) == bits(msb)
            for _ in range(2):
                msa.lifecycle_tick(now=300.0, force=True)
                msb.lifecycle_tick(now=300.0, force=True)
            assert msb._decay_pass == msa._decay_pass == 6
            assert bits(msa) == bits(msb)
        finally:
            msa.close()
            msb.close()


def test_default_config_runs_the_fused_tick(tmp_path):
    """``MemoryConfig()`` has ``lifecycle_fused=True`` as in JAX and its
    system ticks through the one-dispatch sweep."""
    assert MemoryConfig().lifecycle_fused is True
    ms = MemorySystem(enable_async=False, load_from_disk=False, verbose=False,
                      db_dir=str(tmp_path), device="cpu")
    try:
        ms.start_conversation()
        ms.chat("I work as a data engineer on a big ETL project.")
        ms.end_conversation()
        before = ms.index.lifecycle_dispatch_count
        out = ms.lifecycle_tick(force=True)
        assert out["dispatches"] == 1
        assert ms.index.lifecycle_dispatch_count == before + 1
    finally:
        ms.close()
