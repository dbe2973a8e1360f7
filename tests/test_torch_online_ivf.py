"""Online IVF in the port against the JAX package: both fused ingest
programs with the live coarse tables (member appends, overflow, the
mini-batch centroid step and the six readback leaves), and the seven
single-device cases of ``tests/test_online_ivf.py``. The pod, mesh and
tiering cases of that file wait for ROADMAP Queue 1 items 21 and 17. Then
the occupancy K5 is given (``ops.ivf_topk``'s contract) through a fresh
build, overflowing appends, a repack and a rebuild, against JAX's
``online_counts``.

Tolerances: member tables, counts, assignments, member slots, overflow
flags and the integer counters are equal (the drift counter, a rounded
sum of f32 cosines, within 1 part per million); the centroids agree within
1e-6 (the cluster sums are bit-equal to XLA's scatter-add; the norms and
the blend sum in another order).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lazzaro_tpu.core import state as JS
from lazzaro_tpu.ops import ivf as JI
from lazzaro_tpu_torch.core import state as TS
from lazzaro_tpu_torch.core.index import MemoryIndex
from lazzaro_tpu_torch.ops import ivf as TI
from lazzaro_tpu_torch.ops import ivf_topk as K5
from lazzaro_tpu_torch.ops.ivf import assignment_staleness, build_ivf
from lazzaro_tpu_torch.serve import RetrievalRequest
from lazzaro_tpu_torch.utils.telemetry import Telemetry
from tests.test_torch_fused_ingest import (CAP, ECAP, GATE, assert_columns,
                                           batch_arrays, both_states, pad)

D = 24
SEED_N = 512
CENT_TOL = 1e-6


def _tables(cols, full=False):
    """JAX's build over the fixture's live rows and its live tables, for
    both packages; ``full`` keeps 8 slots a cluster, each one taken, so
    that every append overflows."""
    b = JI.build_ivf(jnp.asarray(cols["emb"].astype(np.float32)),
                     cols["alive"], n_clusters=8, seed=1)
    cent = np.array(b.centroids)
    members = np.array(b.members)
    if full:
        members = np.ascontiguousarray(members[:, :8])
        assert (members >= 0).all()
    counts = np.array(JI.online_counts(jnp.asarray(members)))
    jt = (jnp.asarray(cent), jnp.asarray(members), jnp.asarray(counts))
    tt = (torch.from_numpy(cent.copy()), torch.from_numpy(members.copy()),
          torch.from_numpy(counts.copy()))
    return jt, tt


def _assert_tail(jouts, touts):
    """Every leaf equal (floats within 1e-6), the drift counter within 1."""
    assert len(jouts) == len(touts)
    n = len(touts)
    for i, (j, t) in enumerate(zip(jouts, touts)):
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape, i
        if j.dtype.kind == "f":
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6, err_msg=str(i))
        elif i == n - 1:
            assert np.abs(t.astype(np.int64) - j).max() <= 1
        else:
            np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=str(i))


def _assert_tables(jt, tt):
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(jt[0]), rtol=0,
                               atol=CENT_TOL)
    np.testing.assert_array_equal(tt[1].numpy(), np.asarray(jt[1]))
    np.testing.assert_array_equal(tt[2].numpy(), np.asarray(jt[2]))


@pytest.mark.parametrize("full", [False, True], ids=["room", "full"])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_ingest_dedup_fused_online_ivf_matches_jax(dtype, full):
    """The dedup-fused program with the live tables: every leaf of the
    readback (the IVF tail last: assign, member slot, overflow, occupancy,
    appends, drift), the tables after it and every arena column. With
    every cluster full each append overflows (slot -1, flag set) and
    writes nothing."""
    ja, je, ta, te, cols = both_states(0, dtype)
    a = batch_arrays(cols, 1)
    jt, tt = _tables(cols, full)
    names = ("rows", "emb", "salience", "timestamp", "type_id", "shard_id",
             "tenant_id", "is_super", "chain_gid", "chain_slots", "link_pool")
    ja, je, _, jt2, _, _, jouts = JS.ingest_dedup_fused_copy(
        ja, je, None, jt, None, None, *(jnp.asarray(a[n]) for n in names),
        jnp.int32(a["pool_len"]), jnp.float32(50.0), jnp.int32(0),
        jnp.float32(GATE), jnp.float32(0.5), jnp.float32(0.5),
        jnp.float32(0.8), jnp.float32(0.7), k=3, shard_modes=(1, 0))
    _, _, touts = TS.ingest_dedup_fused(
        ta, te, *(torch.from_numpy(np.asarray(a[n])) for n in names),
        torch.tensor(a["pool_len"], dtype=torch.int32), torch.tensor(50.0),
        0, GATE, torch.tensor(0.5), 0.5, 0.8, k=3, shard_modes=(1, 0),
        ivf=tt, ivf_eta=0.7)
    _assert_tail(jouts, touts)
    _assert_tables(jt2, tt)
    assert_columns(ja, ta, TS.ARENA_FIELDS)
    tail = [t.numpy()[0, 0] for t in touts[-TS.IVF_INGEST_TAIL + 2:]]
    assert (tail[2] > 0) != full                    # appends
    assert tail[0] == full                          # overflow flag
    dup = touts[0][:, 0].numpy().astype(bool)
    assert (touts[-TS.IVF_INGEST_TAIL][:, 0].numpy()[dup] == -1).all()


def test_ingest_fused_online_ivf_matches_jax():
    """The plain fused ingest with the live tables, leaf for leaf."""
    ja, je, ta, te, cols = both_states(2, np.float32)
    a = batch_arrays(cols, 3)
    jt, tt = _tables(cols)
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
    ja, je, _, jt2, _, _, jouts = JS.ingest_fused_copy(
        ja, je, None, jt, None, None, *(jnp.asarray(x) for x in args),
        jnp.int32(a["pool_len"]), jnp.float32(50.0), jnp.int32(0),
        jnp.float32(0.5), jnp.float32(0.8), jnp.float32(1.0), k=3,
        shard_modes=(1, 0))
    _, _, touts = TS.ingest_fused(
        ta, te, *(torch.from_numpy(np.asarray(x)) for x in args),
        torch.tensor(a["pool_len"], dtype=torch.int32), torch.tensor(50.0), 0,
        0.5, 0.8, k=3, shard_modes=(1, 0), ivf=tt, ivf_eta=1.0)
    _assert_tail(jouts, touts)
    _assert_tables(jt2, tt)


# ---------------------------- port of tests/test_online_ivf.py (one device)
def _clustered(n, n_centers=8, seed=0, spread=0.15, centers=None, drift=0.0):
    rng = np.random.default_rng(seed)
    if centers is None:
        centers = rng.standard_normal((n_centers, D))
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    if drift:
        centers = centers + drift * rng.standard_normal(centers.shape)
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, len(centers), n)
    emb = centers[assign] + spread * rng.standard_normal((n, D))
    return emb.astype(np.float32), centers


def _seeded_index(n=SEED_N, nprobe=4, cap=2047, seed=0, online=True,
                  member_cap_factor=4, **kw):
    emb, centers = _clustered(n, seed=seed)
    idx = MemoryIndex(D, capacity=cap, ivf_nprobe=nprobe, ivf_online=online,
                      ivf_member_cap_factor=member_cap_factor, device="cpu",
                      **kw)
    ids = [f"n{i}" for i in range(n)]
    idx.add(ids, emb, [0.5] * n, [0.0] * n, ["semantic"] * n, ["s"] * n,
            "t0")
    idx._ivf = build_ivf(idx.state.emb, idx.state.alive.numpy(),
                         member_cap_factor=member_cap_factor)
    return idx, emb, centers


def _ingest(idx, emb, tenant="t0", prefix="x", gate=0.999):
    n = len(emb)
    pending = idx.ingest_batch_dedup(emb, [0.5] * n, [1.0] * n,
                                     ["semantic"] * n, ["s"] * n, tenant,
                                     dedup_gate=gate)
    ids = [None if pending["dup"][i] else f"{prefix}{i}" for i in range(n)]
    idx.commit_ingest_dedup(pending, ids)
    return [i for i in ids if i], pending


def _recall(idx, queries, truth_ids, k=10):
    got = idx.search_batch(queries, "t0", k=k)
    hits = sum(len(set(ids[:k]) & set(want[:k]))
               for (ids, _), want in zip(got, truth_ids))
    return hits / (k * len(queries))


def _exact_truth(idx, queries, k=10):
    return [ids for ids, _ in idx.search_batch(queries, "t0", k=k,
                                               exact=True)]


def test_online_append_routes_rows_and_keeps_residual_empty():
    idx, emb, centers = _seeded_index()
    occ0 = int(idx._ivf_dev[2].sum())
    batch, _ = _clustered(32, centers=centers, seed=5)
    live, pending = _ingest(idx, batch)
    assert pending["ivf_host"] is not None
    assert len(idx._ivf_fresh) == 0
    assert int(idx._ivf_dev[2].sum()) == occ0 + len(live)
    pos = np.asarray(pending["ivf_host"][1])[:, 0]
    assert (pos[:len(pending["dup"])][~pending["dup"]] >= 0).all()


def test_assignment_staleness_bounded_under_mild_drift():
    idx, emb, centers = _seeded_index()
    for r in range(6):
        batch, centers = _clustered(48, centers=centers, seed=10 + r,
                                    drift=0.01)
        _ingest(idx, batch, prefix=f"r{r}_")
    dev = idx._ivf_dev
    frac = assignment_staleness(idx.state.emb, idx.state.alive.numpy(),
                                dev[0], dev[1])
    assert 0.0 <= frac <= 0.05
    assert idx.ivf_staleness_probe() == pytest.approx(frac)


@pytest.mark.parametrize("nprobe", [4, 8])
def test_churn_recall_parity_vs_offline_rebuild(nprobe):
    idx, emb, centers = _seeded_index(nprobe=nprobe, seed=1)
    rng = np.random.default_rng(9)
    for r in range(5):
        batch, centers = _clustered(64, centers=centers, seed=20 + r,
                                    drift=0.02)
        _ingest(idx, batch, prefix=f"c{r}_")
        idx.delete([f"n{i}" for i in rng.integers(0, SEED_N, 8)])
    oracle = MemoryIndex(D, capacity=2047, ivf_nprobe=nprobe,
                         ivf_online=False, device="cpu")
    ids = list(idx.id_to_row)
    embs = idx.state.emb[[idx.id_to_row[i] for i in ids]].numpy()
    oracle.add(ids, embs, [0.5] * len(ids), [0.0] * len(ids),
               ["semantic"] * len(ids), ["s"] * len(ids), "t0")
    oracle._ivf = build_ivf(oracle.state.emb, oracle.state.alive.numpy())
    queries, _ = _clustered(32, centers=centers, seed=77)
    truth = _exact_truth(idx, queries)
    assert _recall(idx, queries, truth) >= _recall(oracle, queries, truth) - 0.05


def test_member_pool_overflow_reinserts_into_extras():
    idx, emb, centers = _seeded_index(member_cap_factor=1,
                                      telemetry=Telemetry(256))
    batch = (np.tile(centers[0], (96, 1))
             + 0.05 * np.random.default_rng(3).standard_normal((96, D))
             ).astype(np.float32)
    live, pending = _ingest(idx, batch)
    dup = np.asarray(pending["dup"])
    pos = np.asarray(pending["ivf_host"][1])[:len(dup), 0]
    spilled = int(((pos < 0) & ~dup).sum())
    assert spilled > 0
    assert len(idx._ivf_fresh) == spilled
    assert idx.telemetry.counter_total("ivf.member_overflows") == spilled
    got = idx.search(batch[-1], "t0", k=10)
    assert set(got[0]) & set(live)


def test_one_dispatch_per_conversation_with_online_ivf(monkeypatch):
    idx, emb, centers = _seeded_index(telemetry=Telemetry(256))
    batch, _ = _clustered(16, centers=centers, seed=6)
    calls = {"ingest_dedup_fused": 0, "ingest_fused": 0,
             "_ivf_online_update": 0}
    for name in calls:
        orig = getattr(TS, name)

        def wrapped(*a, __orig=orig, __name=name, **kw):
            calls[__name] += 1
            return __orig(*a, **kw)

        monkeypatch.setattr(TS, name, wrapped)
    copies = []
    orig_rb = idx._readback
    monkeypatch.setattr(idx, "_readback",
                        lambda p: copies.append(1) or orig_rb(p))
    _ingest(idx, batch)
    assert calls == {"ingest_dedup_fused": 1, "ingest_fused": 0,
                     "_ivf_online_update": 1}
    assert copies == [1]
    assert idx.telemetry.counter_total("ivf.appends") > 0
    assert "ivf.member_pool_occupancy" in idx.telemetry.gauges


def test_ingest_growth_never_triggers_reseed_but_count_change_does():
    idx, emb, centers = _seeded_index(cap=2 ** 14 - 1)
    idx._IVF_MIN_ROWS = 1
    batch, _ = _clustered(256, centers=centers, seed=11)
    _ingest(idx, batch)
    assert idx.ivf_maintenance() is False
    more, _ = _clustered(8 * SEED_N, centers=centers, seed=12)
    for i in range(0, len(more), 512):
        _ingest(idx, more[i:i + 512], prefix=f"g{i}_")
    assert idx.ivf_maintenance() is True
    assert len(idx._ivf_fresh) == 0


def test_offline_mode_keeps_classic_rebuild_semantics():
    idx, emb, centers = _seeded_index(online=False)
    assert idx._ivf_dev is None
    batch, _ = _clustered(40, centers=centers, seed=13)
    _ingest(idx, batch)
    assert len(idx._ivf_fresh) == 40


def _scan_args(idx, monkeypatch):
    """The occupancy every K5 call of the index's two IVF paths passes:
    a classic search (``ops.ivf.ivf_search``) and a fused read batch
    (``state._ivf_two_tier``), each run through the plain version, which
    checks the contract."""
    import lazzaro_tpu_torch.ops.ivf as ivf_mod

    seen = []
    for mod in (TS, ivf_mod):
        real = mod.ivf_topk

        def rec(*a, __real=real, **kw):
            seen.append((a[1], kw["occ"], kw["n_extras"], a[2]))
            return __real(*a, **kw)

        monkeypatch.setattr(mod, "ivf_topk", rec)
    q = idx.state.emb[:4].numpy()
    idx.search_batch(q, "t0", k=5)
    idx.search_fused_requests(
        [RetrievalRequest(query=v, tenant="t0", k=5, nprobe=1 + i)
         for i, v in enumerate(q)], cap_take=2, max_nbr=4, super_gate=0.4,
        acc_boost=0.0, nbr_boost=0.0)
    monkeypatch.undo()
    assert len(seen) == 2
    return seen


def _assert_occupancy(idx, monkeypatch):
    """K5's occupancy as the index passes it keeps the contract (every slot
    at or past ``occ`` holds -1, every extra past ``n_extras`` too) and
    equals JAX's ``online_counts`` of the member table it goes with."""
    for members, occ, n_ex, extras in _scan_args(idx, monkeypatch):
        K5.check_occupancy(members, extras, occ, n_ex)
        want = np.asarray(JI.online_counts(jnp.asarray(members.numpy())))
        np.testing.assert_array_equal(occ.numpy(), want)
        assert n_ex == TI.packed_len(extras.numpy())
    return members, occ


@pytest.mark.parametrize("online", [True, False], ids=["online", "sealed"])
def test_occupancy_of_a_fresh_build_matches_jax_counts(online, monkeypatch):
    """A fresh build: the live tables' cursor (online) or the sealed
    members' counts, computed once per build (the same tensor on every
    call), as JAX's ``online_counts`` gives them."""
    idx, _, _ = _seeded_index(online=online)
    _, occ = _assert_occupancy(idx, monkeypatch)
    assert idx._ivf_live_tables(idx._ivf)[2] is occ
    assert int(occ.min()) < idx._ivf.members.shape[1]      # sparse clusters


def test_occupancy_after_overflowing_appends_matches_jax_counts(monkeypatch):
    """Online appends that overflow a cluster: the cursor stops at the
    cluster's width, the spilled rows sit in the extras' packed prefix."""
    idx, _, centers = _seeded_index(member_cap_factor=1)
    batch = (np.tile(centers[0], (96, 1))
             + 0.05 * np.random.default_rng(3).standard_normal((96, D))
             ).astype(np.float32)
    _, pending = _ingest(idx, batch)
    assert (np.asarray(pending["ivf_host"][1]) < 0).any()     # spilled
    _, occ = _assert_occupancy(idx, monkeypatch)
    assert int(occ.max()) == idx._ivf_dev[1].shape[1]          # a full cluster


def test_occupancy_after_repack_and_rebuild_matches_jax_counts(monkeypatch):
    """After deletes and ``ivf_member_repack`` (holes moved behind the live
    rows, cursors reset), then after a rebuild that the churn triggers."""
    idx, _, centers = _seeded_index()
    batch, _ = _clustered(64, centers=centers, seed=21)
    _ingest(idx, batch)
    idx.delete([f"n{i}" for i in range(0, SEED_N, 3)])
    assert idx.ivf_member_repack(hole_frac=0.0)
    _, occ = _assert_occupancy(idx, monkeypatch)
    assert int(occ.sum()) == len(idx.id_to_row) - len(idx._ivf_fresh)
    built = idx._ivf
    idx._IVF_MIN_ROWS = 1
    idx.delete([f"n{i}" for i in range(1, SEED_N, 3)])
    assert idx.ivf_maintenance() and idx._ivf is not built
    _assert_occupancy(idx, monkeypatch)
