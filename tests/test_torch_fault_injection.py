"""The port's recovery matrix: ``tests/test_fault_injection.py``'s cases
that need the state dispatch guard (``reliability.guard``) or the
``scheduler.worker`` fault point, in the one-device modes ``exact`` and
``quant``.

The port writes its state in place, so the guard tells a failure before a
program's first write (retried: the index ends bit-equal to a run that
never failed) from one after it (``ArenaPoisoned``: every later touch
raises, recovery is ``load_index``). ``faults.poison_states_hook`` models
the second by marking the states written before the injected raise.

The JAX matrix's other modes and points are cases here too, skipped with
the ROADMAP item that brings them: ``ivf`` (Queue 1 item 14), ``tiered``
and the ``pump.*`` / ``coldstore.*`` points (item 17), ``mesh2`` (item
21), ``plan.oom`` (item 19).

Parity: arena, edge and int8 shadow columns bit-equal; result rows, gate
ids and verdicts equal and scores within 2e-6, as the JAX matrix holds
them.
"""

import numpy as np
import pytest

from lazzaro_tpu_torch.core import checkpoint as C
from lazzaro_tpu_torch.core import state as S
from lazzaro_tpu_torch.core.index import MemoryIndex
from lazzaro_tpu_torch.reliability.errors import (ArenaPoisoned, DeviceOom,
                                                  WorkerCrashed)
from lazzaro_tpu_torch.reliability.faults import (INJECTOR, oom_error,
                                                  poison_states_hook)
from lazzaro_tpu_torch.serve.scheduler import (QueryScheduler,
                                               RetrievalRequest)
from lazzaro_tpu_torch.utils.telemetry import Telemetry

D = 32
EPOCH = 1000.0
KW = dict(cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
          nbr_boost=0.02, now=1234.5)
_UNPORTED_MODES = {"ivf": "ROADMAP Queue 1 item 14, IVF",
                   "tiered": "ROADMAP Queue 1 item 17, tiering",
                   "mesh2": "ROADMAP Queue 1 item 21, the sharded int8 "
                            "and fused programs"}
MODES = ["exact", "quant"] + [
    pytest.param(m, marks=pytest.mark.skip(reason=f"not ported: {item}"))
    for m, item in _UNPORTED_MODES.items()]
_PLAN = "not ported: ROADMAP Queue 1 item 19, the HBM planner (plan.oom)"
_TIER = "not ported: ROADMAP Queue 1 item 17, tiering (pump / cold store)"


@pytest.fixture(autouse=True)
def _clean_faults():
    INJECTOR.clear()
    yield
    INJECTOR.clear()


def _vecs(n, seed):
    r = np.random.default_rng(seed)
    nz = r.standard_normal((n, D)).astype(np.float32)
    return nz / np.linalg.norm(nz, axis=1, keepdims=True)


def _fill(idx, n=200, seed=0):
    emb = _vecs(n, seed)
    ids = [f"n{i}" for i in range(n)]
    idx.add(ids, emb, [0.5] * n, [0.0] * n, ["semantic"] * n,
            ["default"] * n, "u0", is_super=[i % 29 == 0 for i in range(n)])
    idx.add_edges([(f"n{i}", f"n{i + 1}", 0.7) for i in range(n - 1)],
                  "u0", now=EPOCH)
    return emb


def _reqs(emb, nq=8, k=10, boost=True, seed=9):
    r = np.random.default_rng(seed)
    q = emb[:nq] + 0.01 * r.standard_normal((nq, D)).astype(np.float32)
    return [RetrievalRequest(query=q[i], tenant="u0", k=k,
                             gate_enabled=True, boost=boost)
            for i in range(nq)]


def _build_mode(mode):
    idx = MemoryIndex(dim=D, capacity=255, epoch=EPOCH, device="cpu",
                      int8_serving=(mode == "quant"),
                      coarse_slack=(8 if mode == "exact" else 512),
                      telemetry=Telemetry())
    return idx, _fill(idx)


def _assert_results_equal(a_list, b_list):
    for a, b in zip(a_list, b_list):
        assert a.ids == b.ids
        assert np.allclose(a.scores, b.scores, atol=2e-6)
        assert a.fast == b.fast
        assert a.gate_id == b.gate_id


def _assert_state_parity(ia, ib):
    for col in S.ARENA_FIELDS:
        assert np.array_equal(getattr(ia.state, col).numpy(),
                              getattr(ib.state, col).numpy()), col
    for col in S.EDGE_FIELDS:
        assert np.array_equal(getattr(ia.edge_state, col).numpy(),
                              getattr(ib.edge_state, col).numpy()), col
    sa, sb = ia._int8_shadow, ib._int8_shadow
    if (sa is not None and sb is not None
            and not ia._int8_dirty and not ib._int8_dirty):
        assert np.array_equal(sa[0].numpy(), sb[0].numpy())
        assert np.array_equal(sa[1].numpy(), sb[1].numpy())


# ------------------------------------------ transient dispatch faults
@pytest.mark.parametrize("mode", MODES)
def test_dispatch_raise_recovers_to_parity(mode):
    """A boosting serve dispatch that fails before its first write retries:
    the caller sees a normal result, the retry is counted, and the state is
    bit-equal to a fault-free run's."""
    idx_f, emb = _build_mode(mode)
    idx_c, _ = _build_mode(mode)
    INJECTOR.arm("index.dispatch", times=1)
    r_f = idx_f.search_fused_requests(_reqs(emb), **KW)
    r_c = idx_c.search_fused_requests(_reqs(emb), **KW)
    assert INJECTOR.fired("index.dispatch") == 1
    assert idx_f.telemetry.counter_total("serve.dispatch_retries") >= 1
    _assert_results_equal(r_f, r_c)
    _assert_state_parity(idx_f, idx_c)


def test_dispatch_raise_on_ingest_recovers_to_parity():
    """The fused ingest under the guard: one injected failure, one retry,
    node, edge and shadow parity (the shadow maintained in the program)."""
    idx_f, emb = _build_mode("quant")
    idx_c, _ = _build_mode("quant")
    for idx in (idx_f, idx_c):                  # build the shadow first
        idx.search_batch(emb[:1], "u0", k=3)
    new = _vecs(8, 7)
    args = (["m%d" % i for i in range(8)], new, [0.5] * 8, [0.0] * 8,
            ["semantic"] * 8, ["default"] * 8, "u0")
    INJECTOR.arm("index.dispatch", times=1)
    idx_f.ingest_batch(*args, chain_pairs=[("m0", "m1")], now=1200.0)
    idx_c.ingest_batch(*args, chain_pairs=[("m0", "m1")], now=1200.0)
    assert INJECTOR.fired("index.dispatch") == 1
    assert idx_f.telemetry.counter_total("serve.dispatch_retries") >= 1
    assert not idx_f._int8_dirty and not idx_c._int8_dirty
    _assert_state_parity(idx_f, idx_c)


def test_mutation_dispatch_raise_recovers():
    idx_f, _ = _build_mode("exact")
    idx_c, _ = _build_mode("exact")
    INJECTOR.arm("index.dispatch", times=1)
    idx_f.update_access(["n0", "n3"], now=2000.0)
    idx_c.update_access(["n0", "n3"], now=2000.0)
    _assert_state_parity(idx_f, idx_c)


# ------------------------------------------------------- typed OOM
def test_oom_dispatch_not_retried_as_transient():
    """An allocation failure is not a transient: it fires once, becomes the
    typed DeviceOom, and no retry runs."""
    idx, _ = _build_mode("exact")
    INJECTOR.arm("index.dispatch", times=3, exc=oom_error)
    with pytest.raises(DeviceOom):
        idx.update_access(["n0"], now=2000.0)
    assert INJECTOR.fired("index.dispatch") == 1
    assert idx.telemetry.counter_total("serve.dispatch_retries") == 0
    assert idx.telemetry.counter_total("reliability.oom") == 1
    assert not idx.poisoned


@pytest.mark.skip(reason=_PLAN)
@pytest.mark.parametrize("mode", MODES)
def test_plan_oom_replan_recovers_to_parity(mode):
    pass


@pytest.mark.skip(reason=_PLAN)
def test_plan_oom_without_planner_stays_typed():
    pass


# ------------------------------------------------------ poisoned arena
def test_poisoned_arena_raises_typed_and_fast():
    """A program that failed after its first write leaves nothing to retry:
    ArenaPoisoned on the failing call and on every later touch."""
    idx, emb = _build_mode("exact")
    INJECTOR.arm("index.dispatch", times=1, hook=poison_states_hook)
    with pytest.raises(ArenaPoisoned):
        idx.update_access(["n0"], now=2000.0)
    assert idx.poisoned
    with pytest.raises(ArenaPoisoned):
        idx.update_access(["n1"], now=2001.0)
    with pytest.raises(ArenaPoisoned):
        idx.search_fused_requests(_reqs(emb, nq=2), **KW)
    with pytest.raises(ArenaPoisoned):
        idx.search_batch(emb[:1], "u0", k=3)
    with pytest.raises(ArenaPoisoned):
        idx.ingest_batch(["x"], emb[:1], [0.5], [0.0], ["semantic"],
                         ["default"], "u0")
    with pytest.raises(ArenaPoisoned):
        idx.lifecycle_sweep({"u0": 1}, rate=0.1, salience_floor=0.2,
                            prune_threshold=0.1)
    assert idx.telemetry.counter_total("reliability.poisoned") == 1


def test_poisoned_arena_recovers_via_checkpoint(tmp_path):
    """Recovery: the last checkpoint, loaded with int8 serving, is
    bit-equal to a never-poisoned twin and serves alike."""
    idx, emb = _build_mode("quant")
    ck = str(tmp_path / "ck")
    C.save_index(idx, ck)
    INJECTOR.arm("index.dispatch", times=1, hook=poison_states_hook)
    with pytest.raises(ArenaPoisoned):
        idx.update_access(["n0"], now=2000.0)
    restored = C.load_index(ck, int8_serving=True, coarse_slack=512,
                            device="cpu", telemetry=Telemetry())
    control, _ = _build_mode("quant")
    _assert_state_parity(restored, control)
    r_r = restored.search_fused_requests(_reqs(emb), **KW)
    r_c = control.search_fused_requests(_reqs(emb), **KW)
    _assert_results_equal(r_r, r_c)
    _assert_state_parity(restored, control)


# ----------------------------------------------- scheduler worker death
@pytest.mark.parametrize("mode", MODES)
def test_worker_death_fails_futures_and_restarts(mode):
    """The admitted batch fails with the typed WorkerCrashed, the worker
    restarts, the next submit serves normally, and the dead batch never
    touched the device."""
    idx_f, emb = _build_mode(mode)
    idx_c, _ = _build_mode(mode)
    tel = Telemetry()
    sched = QueryScheduler(
        lambda rs: idx_f.search_fused_requests(rs, **KW), telemetry=tel)
    INJECTOR.arm("scheduler.worker", times=1)
    futs = sched.submit_many(_reqs(emb, nq=4))
    for f in futs:
        with pytest.raises(WorkerCrashed):
            f.result(timeout=30)
    futs2 = sched.submit_many(_reqs(emb, nq=4))
    res_f = [f.result(timeout=30) for f in futs2]
    sched.close()
    assert tel.counter_total("reliability.worker_restarts") >= 1
    res_c = idx_c.search_fused_requests(_reqs(emb, nq=4), **KW)
    _assert_results_equal(res_f, res_c)
    _assert_state_parity(idx_f, idx_c)


# --------------------------------------------- ingest dispatch failure
def test_ingest_dispatch_failure_requeues_and_retries(tmp_path):
    """The fused ingest fails past its retries: the facts go back to the
    front of the coalescer and stay journaled, the worker survives, and the
    next conversation end lands them exactly once."""
    from lazzaro_tpu_torch import MemorySystem
    from lazzaro_tpu_torch.config import MemoryConfig
    from tests.test_torch_fused_ingest import ClusteredEmb, QueueLLM

    ms = MemorySystem(
        enable_async=False, db_dir=str(tmp_path / "db"), verbose=False,
        load_from_disk=False, llm_provider=QueueLLM(4),
        embedding_provider=ClusteredEmb(), auto_prune=False,
        max_buffer_size=10_000, device="cpu",
        config=MemoryConfig(journal=True, auto_consolidate=False,
                            decay_rate=0.0))

    def count(content):
        return sum(1 for shard in ms.shards.values()
                   for n in shard.nodes.values() if n.content == content)

    ms.start_conversation()
    ms.add_to_short_term("turn one", "semantic", 0.6)
    rows_before = len(ms.index._free_rows)
    # the first attempt and dispatch_retry_max (2) retries of the one ingest
    INJECTOR.arm("index.dispatch", times=3)
    ms.end_conversation()
    assert INJECTOR.fired("index.dispatch") == 3
    assert len(ms._ingest_coalescer) == 4         # the facts, requeued
    assert ms._ingest_journal.pending_count == 1
    assert ms.telemetry.counter_total("reliability.ingest_failures") == 1
    assert ms.telemetry.counter_total("serve.dispatch_retries") == 2
    assert len(ms.index._free_rows) == rows_before   # no row leaked
    assert not ms.index.poisoned
    INJECTOR.clear()
    ms.start_conversation()
    ms.add_to_short_term("turn two", "semantic", 0.6)
    ms.end_conversation()
    assert count("fact 0 body") == 1
    assert count("fact 4 body") == 1
    assert ms._ingest_journal.pending_count == 0
    ms.close()


# ------------------------------------------ tiering's fault points
@pytest.mark.skip(reason=_TIER)
def test_pump_mid_chunk_crash_leaves_rows_hot():
    pass


@pytest.mark.skip(reason=_TIER)
def test_pump_thread_survives_injected_crash():
    pass


@pytest.mark.skip(reason=_TIER)
def test_coldstore_read_error_typed_and_recovers():
    pass


@pytest.mark.skip(reason=_TIER)
def test_coldstore_read_error_on_promote_recovers():
    pass


# --------------------------------- the fault-free path: one dispatch
@pytest.mark.parametrize("mode", ["exact", "quant"])
def test_fault_free_serve_still_one_dispatch(monkeypatch, mode):
    """The guard wraps the same one dispatch and one packed copy: no probe,
    no retry, no second program on the healthy path."""
    counted = ("search_fused_ragged", "search_fused_ragged_read",
               "search_fused", "search_fused_read", "search_fused_quant",
               "search_fused_quant_read", "search_fused_quant_ragged",
               "search_fused_quant_ragged_read", "arena_search")
    calls = {name: 0 for name in counted}
    for name in counted:
        orig = getattr(S, name)

        def wrapped(*a, __orig=orig, __name=name, **kw):
            calls[__name] += 1
            return __orig(*a, **kw)

        monkeypatch.setattr(S, name, wrapped)
    idx, emb = _build_mode(mode)
    copies = []
    orig_rb = idx._readback
    monkeypatch.setattr(idx, "_readback",
                        lambda p: copies.append(1) or orig_rb(p))
    idx.search_fused_requests(_reqs(emb, nq=4), **KW)
    want = ("search_fused_quant_ragged" if mode == "quant"
            else "search_fused_ragged")
    assert calls[want] == 1
    for name in counted:
        if name != want:
            assert calls[name] == 0, (name, calls)
    assert copies == [1]
    assert idx.telemetry.counter_total("serve.dispatch_retries") == 0
    assert not S.ArenaState.written and not idx.state.written
