"""The index checkpoint of the port (``lazzaro_tpu_torch.core.checkpoint``)
against the JAX package's format, and the fault points it and the ingest
journal carry (``lazzaro_tpu_torch.reliability.faults``).

The cases of ``tests/test_checkpoint.py`` on the port, all but
``test_nonzero_rank_never_touches_filesystem`` (the port runs one process;
multi-process checkpoints wait for ROADMAP Queue 1 item 21); from
``tests/test_fault_injection.py`` the torn checkpoint, the bit rot and the
ingest worker's death between the journal append and the ingest. Both
directions of the on-disk format, f32 and bf16: a checkpoint written by
``lazzaro_tpu.core.checkpoint.save_index`` loads in the port and serves the
JAX index's top-k (rows exact, scores within 1e-6), and one written by the
port loads in the JAX package with every column bit-equal; a checkpoint
with a section of an unported serving mode raises naming its item; a
row-sharded index saves its global rows and loads onto a mesh or one
device.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lazzaro_tpu.core import checkpoint as JC
from lazzaro_tpu.core.index import MemoryIndex as JaxIndex
from lazzaro_tpu_torch import MemoryConfig, MemorySystem
from lazzaro_tpu_torch.core import checkpoint as C
from lazzaro_tpu_torch.core.checkpoint import load_index, save_index
from lazzaro_tpu_torch.core.index import MemoryIndex
from lazzaro_tpu_torch.parallel import make_mesh
from lazzaro_tpu_torch.reliability.errors import CheckpointCorrupt
from lazzaro_tpu_torch.reliability.faults import INJECTOR, torn_write_hook
from tests.test_fused_ingest import ClusteredEmb, QueueLLM

CPU = {"device": "cpu"}
ARENA = C._ARENA_COLS
EDGES = C._EDGE_COLS


@pytest.fixture(autouse=True)
def _clean_faults():
    INJECTOR.clear()
    yield
    INJECTOR.clear()


def _fill(index, n, tenant="default", seed=0):
    rng = np.random.RandomState(seed)
    ids = [f"node_{i}" for i in range(n)]
    emb = rng.randn(n, index.dim).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    index.add(ids, emb, [0.5] * n, [1000.0 + i for i in range(n)],
              ["semantic"] * n, ["work"] * n, tenant)
    return ids, emb


def _host_col(idx, kind, col):
    """A column of either package's index as numpy, bf16 as its bits."""
    if isinstance(idx, MemoryIndex):
        t = idx._column(col) if kind == "arena" else getattr(idx.edge_state, col)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(getattr(idx.state if kind == "arena" else idx.edge_state, col))
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_columns_equal(a, b):
    for kind, cols in (("arena", ARENA), ("edge", EDGES)):
        for col in cols:
            x, y = _host_col(a, kind, col), _host_col(b, kind, col)
            if x.dtype == np.float32:
                x, y = x.view(np.int32), y.view(np.int32)
            np.testing.assert_array_equal(x, y, err_msg=f"{kind}_{col}")


# ------------------------------------------ tests/test_checkpoint.py cases
def test_round_trip_search_identical(tmp_path):
    idx = MemoryIndex(dim=32, capacity=64, edge_capacity=32, **CPU)
    ids, emb = _fill(idx, 20)
    idx.add_edges([("node_0", "node_1", 0.7), ("node_1", "node_2", 0.4)],
                  "default")
    ck = str(tmp_path / "ckpt")
    save_index(idx, ck)
    idx2 = load_index(ck, **CPU)
    assert len(idx2) == len(idx)
    assert idx2.id_to_row == idx.id_to_row
    assert idx2.edge_slots == idx.edge_slots
    assert idx2.edge_slots.by_slot == idx.edge_slots.by_slot
    assert idx2.epoch == idx.epoch
    _assert_columns_equal(idx, idx2)
    for q in emb[:5]:
        a = idx.search(q, "default", k=5)
        b = idx2.search(q, "default", k=5)
        assert a[0] == b[0]
        np.testing.assert_array_equal(np.float32(a[1]), np.float32(b[1]))


def test_round_trip_then_mutate(tmp_path):
    """The restored index keeps working: adds, deletes, edges, decay and a
    lifecycle sweep."""
    idx = MemoryIndex(dim=16, capacity=32, edge_capacity=16, **CPU)
    _fill(idx, 10)
    ck = str(tmp_path / "ckpt")
    save_index(idx, ck)
    idx2 = load_index(ck, **CPU)
    idx2.delete(["node_3"])
    assert "node_3" not in idx2.id_to_row
    rng = np.random.RandomState(1)
    more = rng.randn(40, 16).astype(np.float32)   # forces arena growth
    idx2.add([f"new_{i}" for i in range(40)], more, [0.5] * 40,
             [2000.0] * 40, ["episodic"] * 40, ["personal"] * 40, "default")
    assert len(idx2) == 49
    idx2.add_edges([("new_0", "new_1", 0.9)], "default")
    idx2.decay("default", 0.01)
    out = idx2.lifecycle_sweep({"default": 1}, rate=0.01, salience_floor=0.2,
                               prune_threshold=0.5, archive_k=4)
    assert out["decayed_rows"] == 49 and len(out["verdicts"]["default"]) == 4
    ids, _ = idx2.search(more[0], "default", k=3)
    assert ids[0] == "new_0"


def test_round_trip_bfloat16(tmp_path):
    idx = MemoryIndex(dim=16, capacity=32, edge_capacity=8,
                      dtype=torch.bfloat16, **CPU)
    _, emb = _fill(idx, 8)
    ck = str(tmp_path / "ck")
    save_index(idx, ck)
    idx2 = load_index(ck, **CPU)
    assert idx2.state.emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(idx.state.emb.view(torch.int16).numpy(),
                                  idx2.state.emb.view(torch.int16).numpy())
    a = idx.search(emb[0], "default", k=3)
    b = idx2.search(emb[0], "default", k=3)
    assert a[0] == b[0]


def test_multi_tenant_membership_restored(tmp_path):
    idx = MemoryIndex(dim=8, capacity=64, edge_capacity=8, **CPU)
    _fill(idx, 5, tenant="alice", seed=1)
    rng = np.random.RandomState(2)
    emb = rng.randn(3, 8).astype(np.float32)
    idx.add(["b_0", "b_1", "b_2"], emb, [0.5] * 3, [0.0] * 3,
            ["semantic"] * 3, ["work"] * 3, "bob")
    ck = str(tmp_path / "ck")
    save_index(idx, ck)
    idx2 = load_index(ck, **CPU)
    assert idx2.tenant_nodes["alice"] == idx.tenant_nodes["alice"]
    assert idx2.tenant_nodes["bob"] == {"b_0", "b_1", "b_2"}
    ids, _ = idx2.search(emb[0], "bob", k=2)
    assert ids[0] == "b_0"
    ids_a, _ = idx2.search(emb[0], "alice", k=2)
    assert "b_0" not in ids_a


def test_overwrite_existing_checkpoint(tmp_path):
    idx = MemoryIndex(dim=8, capacity=16, edge_capacity=8, **CPU)
    _fill(idx, 4)
    ck = str(tmp_path / "ck")
    save_index(idx, ck)
    idx.delete(["node_0"])
    save_index(idx, ck)
    idx2 = load_index(ck, **CPU)
    assert "node_0" not in idx2.id_to_row
    assert len(idx2) == 3
    assert len([e for e in os.listdir(ck) if e.startswith("v")]) == 1


def test_crash_between_payload_and_pointer_keeps_old_snapshot(tmp_path):
    idx = MemoryIndex(dim=8, capacity=16, edge_capacity=8, **CPU)
    _fill(idx, 4)
    ck = str(tmp_path / "ck")
    save_index(idx, ck)
    os.makedirs(os.path.join(ck, "v2"))
    (tmp_path / "ck" / "v2" / "meta.json").write_text("{corrupt")
    assert len(load_index(ck, **CPU)) == 4
    idx.delete(["node_1"])
    save_index(idx, ck)
    assert len(load_index(ck, **CPU)) == 3
    assert not os.path.isdir(os.path.join(ck, "v2"))


def test_load_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_index(str(tmp_path / "nope"), **CPU)


def test_scale_timing_vs_row_store(tmp_path):
    """A 50k x 256 snapshot saves and loads faster than the row store
    writes the same rows (the reason for the module)."""
    from lazzaro_tpu_torch.core.store import ArrowStore

    n, d = 50_000, 256
    idx = MemoryIndex(dim=d, capacity=n, edge_capacity=8, **CPU)
    rng = np.random.RandomState(0)
    emb = rng.randn(n, d).astype(np.float32)
    ids = [f"n{i}" for i in range(n)]
    idx.add(ids, emb, [0.5] * n, [0.0] * n, ["semantic"] * n, ["work"] * n,
            "default")
    t0 = time.perf_counter()
    save_index(idx, str(tmp_path / "ck"))
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx2 = load_index(str(tmp_path / "ck"), **CPU)
    t_load = time.perf_counter() - t0
    assert len(idx2) == n
    store = ArrowStore(str(tmp_path / "db"))
    rows = [{"id": i, "content": "", "embedding": e}
            for i, e in zip(ids, emb.tolist())]
    t0 = time.perf_counter()
    store.add_nodes(rows)
    t_store = time.perf_counter() - t0
    assert t_save < t_store, (t_save, t_store)
    assert t_load < t_store, (t_load, t_store)


def test_payload_fsynced_before_pointer_flip(tmp_path, monkeypatch):
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync",
                        lambda fd: (synced.append(fd), real_fsync(fd)))
    idx = MemoryIndex(dim=16, capacity=32, edge_capacity=16, **CPU)
    _fill(idx, 8)
    save_index(idx, str(tmp_path / "ck"))
    assert len(synced) >= 5


def test_round_trip_restores_super_row_tracking(tmp_path):
    idx = MemoryIndex(dim=16, capacity=64, edge_capacity=32, **CPU)
    rng = np.random.RandomState(1)
    idx.add([f"n{i}" for i in range(6)], rng.randn(6, 16).astype(np.float32),
            [0.5] * 6, [0.0] * 6, ["semantic"] * 6, ["work"] * 6, "default",
            is_super=[False, True, False, True, False, False])
    ck = str(tmp_path / "ckpt")
    save_index(idx, ck)
    idx2 = load_index(ck, **CPU)
    assert idx2._super_rows == idx._super_rows
    assert idx2._super_rows_frozen == idx._super_rows_frozen
    assert idx2._super_rows == {idx.id_to_row["n1"], idx.id_to_row["n3"]}
    idx2.delete(["n1"])
    assert idx2._super_rows_frozen == (idx.id_to_row["n3"],)


# ------------------------------------------------------- both directions
def _jax_pair(dtype, tmp_path, n=40, d=24):
    """The same rows, edges and tenants in a JAX index and a port index."""
    rng = np.random.RandomState(4)
    emb = rng.randn(n, d).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j = JaxIndex(dim=d, capacity=63, edge_capacity=32, dtype=jdt, epoch=500.0)
    t = MemoryIndex(dim=d, capacity=63, edge_capacity=32, dtype=dtype,
                    epoch=500.0, **CPU)
    for idx in (j, t):
        for tenant, lo, hi in (("alice", 0, 25), ("bob", 25, n)):
            idx.add([f"{tenant}:{i}" for i in range(lo, hi)], emb[lo:hi],
                    [0.3 + 0.01 * i for i in range(lo, hi)],
                    [600.0 + i for i in range(lo, hi)], ["semantic"] * (hi - lo),
                    ["s0", "s1"] * ((hi - lo) // 2) + ["s0"] * ((hi - lo) % 2),
                    tenant, is_super=[i % 7 == 0 for i in range(lo, hi)])
        idx.add_edges([(f"alice:{i}", f"alice:{i + 1}", 0.4 + 0.02 * i)
                       for i in range(20)], "alice", now=700.0)
        idx.add_edges([("bob:25", "bob:30", 0.9)], "bob", now=710.0)
        idx.delete(["alice:3", "bob:27"])
        idx.update_access(["alice:5", "bob:31"], now=800.0)
    return j, t, emb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_and_serves_jax_topk(dtype, tmp_path):
    j, _, emb = _jax_pair(dtype, tmp_path)
    ck = str(tmp_path / "jck")
    JC.save_index(j, ck)
    t = load_index(ck, **CPU)
    _assert_columns_equal(j, t)
    assert t.id_to_row == j.id_to_row and t._tenants == j._tenants
    assert dict(t.edge_slots) == dict(j.edge_slots)
    assert t._super_rows == j._super_rows
    assert t.tenant_nodes == j.tenant_nodes
    jl = JC.load_index(ck)                    # the free lists as JAX rebuilds
    assert t._free_rows == jl._free_rows
    assert t._free_edge_slots == jl._free_edge_slots
    for tenant in ("alice", "bob"):
        for q in emb[::7]:
            jid, js = j.search(q, tenant, k=6)
            tid, ts = t.search(q, tenant, k=6)
            assert tid == jid
            np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_loads_in_jax_bit_equal(dtype, tmp_path):
    _, t, _ = _jax_pair(dtype, tmp_path)
    ck = str(tmp_path / "tck")
    save_index(t, ck)
    back = JC.load_index(ck)
    _assert_columns_equal(t, back)
    assert back.id_to_row == t.id_to_row and back.epoch == t.epoch
    assert back.edge_slots == dict(t.edge_slots)
    assert back._super_rows == t._super_rows
    jmeta, tmeta = JC.read_meta(ck), C.read_meta(ck)
    assert jmeta == tmeta and tmeta["dtype"] == dtype
    assert tmeta["column_dtypes"]["arena_emb"] == dtype


def test_sharded_index_round_trip(tmp_path):
    """A 2-way mesh index saves its global rows; they load onto the mesh
    (each shard's rows to its owner) or onto one device, bit-equal, and the
    mesh serves the same top-k after the load."""
    mesh = make_mesh(devices=["cpu"] * 2)
    idx = MemoryIndex(dim=16, capacity=63, edge_capacity=16, mesh=mesh)
    ids, emb = _fill(idx, 30)
    idx.add_edges([("node_0", "node_9", 0.7)], "default")
    ck = str(tmp_path / "mck")
    save_index(idx, ck)
    on_mesh = load_index(ck, mesh=mesh)
    one = load_index(ck, **CPU)
    assert len(on_mesh.shards) == 2
    _assert_columns_equal(idx, on_mesh)
    _assert_columns_equal(idx, one)
    for q in emb[:4]:
        assert on_mesh.search(q, "default", k=5) == idx.search(q, "default", k=5)
    with pytest.raises(ValueError, match="axis"):
        load_index(ck, mesh=mesh, shard_axis="model")


@pytest.mark.parametrize("section,item", [s for s in C._UNPORTED_SECTIONS])
def test_unported_sections_raise_naming_their_item(section, item, tmp_path):
    idx = MemoryIndex(dim=8, capacity=16, edge_capacity=8, **CPU)
    _fill(idx, 3)
    ck = str(tmp_path / "ck")
    save_index(idx, ck, extra_meta={section: {}})
    with pytest.raises(NotImplementedError, match=item):
        load_index(ck, **CPU)


# ------------------------------------- tests/test_fault_injection.py cases
def test_torn_checkpoint_raises_typed_and_resave_recovers(tmp_path):
    """A payload torn after the CURRENT flip fails its checksum with the
    typed error; a re-save from the live index restores parity."""
    idx = MemoryIndex(dim=16, capacity=64, edge_capacity=32, **CPU)
    _, emb = _fill(idx, 30)
    idx.add_edges([("node_0", "node_1", 0.8)], "default")
    ck = str(tmp_path / "ck")
    INJECTOR.arm("checkpoint.torn", times=1, exc=None, hook=torn_write_hook())
    save_index(idx, ck)
    assert INJECTOR.fired("checkpoint.torn") == 1
    with pytest.raises(CheckpointCorrupt):
        load_index(ck, **CPU)
    save_index(idx, ck)
    restored = load_index(ck, **CPU)
    _assert_columns_equal(idx, restored)
    assert restored.search(emb[2], "default", k=4) == idx.search(emb[2], "default", k=4)


def test_checkpoint_checksum_catches_bit_rot(tmp_path):
    idx = MemoryIndex(dim=16, capacity=64, edge_capacity=32, **CPU)
    _fill(idx, 30)
    ck = str(tmp_path / "ck")
    save_index(idx, ck)
    cur = open(os.path.join(ck, "CURRENT")).read().strip()
    npz = os.path.join(ck, cur, "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(os.path.getsize(npz) // 2)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(CheckpointCorrupt):
        load_index(ck, **CPU)


def test_checkpoint_without_checksums_still_loads_and_bad_sidecar_raises(tmp_path):
    idx = MemoryIndex(dim=8, capacity=16, edge_capacity=8, **CPU)
    _fill(idx, 4)
    ck = str(tmp_path / "ck")
    save_index(idx, ck)
    vdir = os.path.join(ck, open(os.path.join(ck, "CURRENT")).read().strip())
    os.remove(os.path.join(vdir, "checksums.json"))
    assert len(load_index(ck, **CPU)) == 4
    with open(os.path.join(vdir, "checksums.json"), "w") as f:
        f.write("{torn")
    with pytest.raises(CheckpointCorrupt):
        load_index(ck, **CPU)


def _count_facts(ms, content):
    return sum(1 for shard in ms.shards.values()
               for n in shard.nodes.values() if n.content == content)


def test_ingest_worker_death_zero_lost_facts(tmp_path):
    """The worker dies between the journal append and the ingest: a fresh
    process on the same ``db_dir`` replays the journaled facts through the
    ingest, and none is lost."""
    db = str(tmp_path / "db")

    def system(load):
        return MemorySystem(
            enable_async=False, db_dir=db, verbose=False, load_from_disk=load,
            llm_provider=QueueLLM(4), embedding_provider=ClusteredEmb(),
            auto_prune=False, max_buffer_size=10_000, device="cpu",
            config=MemoryConfig(journal=True, auto_consolidate=False,
                                decay_rate=0.0))

    ms = system(False)
    ms.start_conversation()
    ms.add_to_short_term("turn one", "semantic", 0.6)
    INJECTOR.arm("ingest.worker", times=1)
    ms.end_conversation()
    assert INJECTOR.fired("ingest.worker") == 1
    assert ms._ingest_journal.pending_count == 1
    assert ms.telemetry.counter_total("reliability.ingest_failures") == 1
    assert _count_facts(ms, "fact 0 body") == 0
    ms2 = system(True)                        # the crash: no close() of ms
    assert ms2._ingest_journal.pending_count == 0
    assert ms2.telemetry.counter_total("reliability.journal_replayed") == 4
    assert _count_facts(ms2, "fact 0 body") == 1
    ms2.close()


def test_fault_points_are_bounded_and_scoped():
    """A plan fires its ``times`` then disarms; ``armed`` always disarms;
    a disarmed ``fire`` is a no-op."""
    from lazzaro_tpu_torch.reliability import faults

    faults.fire("checkpoint.torn", dir="nowhere")        # nothing armed
    INJECTOR.arm("ingest.worker", times=2)
    for _ in range(2):
        with pytest.raises(faults.InjectedFault):
            faults.fire("ingest.worker")
    faults.fire("ingest.worker")
    assert INJECTOR.fired("ingest.worker") == 2 and not INJECTOR.active
    with INJECTOR.armed("ingest.worker", exc=None):
        faults.fire("ingest.worker")
    assert not INJECTOR.active and INJECTOR.fired("ingest.worker") == 3
