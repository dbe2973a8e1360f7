"""The port's IVF build, coarse stage and classic IVF search against the JAX
package: ``tests/test_ivf.py``'s eleven cases on both packages' fixtures,
the build and K5's plain version held to JAX, and the parity traps of the
candidate scan (ties and fill by candidate position, deterministic cluster
sums).

Tolerances: member tables, residuals, cluster ids, assignments, rows and
candidate positions are equal. Cluster sums are bit-equal to XLA's CPU
scatter-add (``ops.ivf.segment_sum`` adds each cluster's rows in row
order, as XLA does); the centroids agree within 1e-6 (the norms sum in
another order). Scores agree within 1e-5 (f32 products summed over d in
another order than XLA's einsum), and exactly on grid values, whose sums
are exact in any order.
"""

import json as _json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lazzaro_tpu.core.index import MemoryIndex as JaxIndex
from lazzaro_tpu.ops import ivf as JI
from lazzaro_tpu_torch.config import MemoryConfig
from lazzaro_tpu_torch.core.index import MemoryIndex
from lazzaro_tpu_torch.core.memory_system import MemorySystem
from lazzaro_tpu_torch.ops import ivf as TI
from lazzaro_tpu_torch.ops import ivf_topk as K5

CENT_TOL = 1e-6
SCORE_TOL = 1e-5


def _clustered(n_centers, per, d, seed=0, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    pts = np.repeat(centers, per, axis=0) + spread * rng.standard_normal(
        (n_centers * per, d))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts.astype(np.float32), centers.astype(np.float32)


def _exact_topk(emb, mask, q, k):
    scores = q @ emb.T
    scores[:, ~mask] = -np.inf
    return np.argsort(-scores, axis=1)[:, :k]


def _builds(emb, mask, **kw):
    """The same build on both packages, held equal."""
    jb = JI.build_ivf(jnp.asarray(emb), mask, **kw)
    tb = TI.build_ivf(torch.from_numpy(emb), mask, **kw)
    np.testing.assert_array_equal(tb.members.numpy(), np.asarray(jb.members))
    np.testing.assert_array_equal(tb.residual.numpy(), np.asarray(jb.residual))
    np.testing.assert_allclose(tb.centroids.numpy(), np.asarray(jb.centroids),
                               rtol=0, atol=CENT_TOL)
    assert tb.built_rows == jb.built_rows
    return jb, tb


def _searches(jb, tb, emb, mask, q, k, nprobe):
    """Both packages' ``ivf_search`` on one build: rows equal, scores
    within the stated tolerance. Returns the port's rows."""
    js, jr = JI.ivf_search(jb.centroids, jb.members, jb.residual,
                           jnp.asarray(emb), jnp.asarray(mask),
                           jnp.asarray(q), k=k, nprobe=nprobe)
    ts, tr = TI.ivf_search(tb.centroids, tb.members, tb.residual,
                           torch.from_numpy(emb), torch.from_numpy(mask),
                           torch.from_numpy(q), k=k, nprobe=nprobe)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_TOL)
    return tr.numpy()


def test_nprobe_full_is_exact():
    emb, _ = _clustered(16, 50, 32)
    mask = np.ones(len(emb), bool)
    mask[13] = False
    jb, tb = _builds(emb, mask, n_clusters=16, seed=1)
    q = emb[::97][:12]
    rows = _searches(jb, tb, emb, mask, q, 5, tb.n_clusters)
    np.testing.assert_array_equal(np.sort(rows, axis=1),
                                  np.sort(_exact_topk(emb, mask, q, 5), axis=1))


def test_high_recall_at_small_nprobe_on_clustered_data():
    emb, _ = _clustered(32, 120, 48, seed=2)
    mask = np.ones(len(emb), bool)
    jb, tb = _builds(emb, mask, n_clusters=32, iters=10, seed=3)
    qidx = np.random.default_rng(4).integers(0, len(emb), 64)
    rows = _searches(jb, tb, emb, mask, emb[qidx], 1, 4)
    assert (rows[:, 0] == qidx).mean() >= 0.95


def test_residual_serves_fresh_rows_without_rebuild():
    emb, _ = _clustered(8, 40, 24, seed=5)
    mask = np.ones(len(emb), bool)
    jb, tb = _builds(emb, mask, n_clusters=8, seed=6)
    fresh = np.zeros((1, 24), np.float32)
    fresh[0, 0] = 1.0
    emb2 = np.concatenate([emb, fresh])
    mask2 = np.ones(len(emb2), bool)
    fresh_row = len(emb2) - 1
    residual = tb.residual.numpy()
    residual = np.concatenate([residual[residual >= 0], [fresh_row]]).astype(
        np.int32)
    residual = np.concatenate(
        [residual, np.full((-len(residual) % 8,), -1, np.int32)])
    jb2 = JI.IvfIndex(jb.centroids, jb.members, jnp.asarray(residual),
                      jb.built_rows)
    tb2 = TI.IvfIndex(tb.centroids, tb.members, torch.from_numpy(residual),
                      tb.built_rows)
    rows = _searches(jb2, tb2, emb2, mask2, fresh, 1, 1)
    assert int(rows[0, 0]) == fresh_row


def test_overflow_goes_to_residual_not_dropped():
    emb, _ = _clustered(1, 300, 16, seed=7, spread=0.02)
    mask = np.ones(len(emb), bool)
    jb, tb = _builds(emb, mask, n_clusters=4, iters=4, member_cap_factor=1,
                     seed=8)
    assert (int((tb.members >= 0).sum()) + int((tb.residual >= 0).sum())
            == 300)
    rows = _searches(jb, tb, emb, mask, emb[::55][:5], 1, 1)
    assert (rows[:, 0] == np.arange(0, 300, 55)[:5]).all()


def _unit_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _both_indexes(n, d, seed, nprobe=8, tenant="u1", **kw):
    emb = _unit_rows(n, d, seed)
    ids = [f"m{i}" for i in range(n)]
    args = (ids, emb, [0.5] * n, [0.0] * n, ["semantic"] * n, ["default"] * n,
            tenant)
    j = JaxIndex(dim=d, capacity=n + 64, ivf_nprobe=nprobe, **kw)
    t = MemoryIndex(dim=d, capacity=n + 64, ivf_nprobe=nprobe, device="cpu",
                    **kw)
    j.add(*args)
    t.add(*args)
    return j, t, emb


def _same_results(a, b):
    assert len(a) == len(b)
    for (ia, sa), (ib, sb) in zip(a, b):
        assert ia == ib
        np.testing.assert_allclose(sa, sb, rtol=0, atol=SCORE_TOL)


def test_memory_index_ivf_serving_and_freshness():
    d, n = 32, 5000
    rng = np.random.default_rng(10)
    j, idx, emb = _both_indexes(n, d, 10)
    probe = rng.integers(0, n, 50)
    idx.search_batch(emb[probe[:2]], "u1", k=1)
    assert idx._ivf is None               # a serving query builds nothing
    assert idx.ivf_maintenance() and j.ivf_maintenance()
    assert idx._ivf is not None
    assert not idx.ivf_maintenance()      # no fresh rows: no rebuild
    res = idx.search_batch(emb[probe], "u1", k=1)
    _same_results(res, j.search_batch(emb[probe], "u1", k=1))
    hits = sum(1 for p, (got, _) in zip(probe, res) if got == [f"m{p}"])
    assert hits >= 47, f"ivf self-recall {hits}/50"
    fresh = np.zeros((1, d), np.float32)
    fresh[0, 5] = 1.0
    idx.add(["fresh"], fresh, [0.5], [0.0], ["semantic"], ["default"], "u1")
    assert idx._ivf_fresh
    (got, _), = idx.search_batch(fresh, "u1", k=1)
    assert got == ["fresh"]
    (got_exact, _), = idx.search_batch(fresh, "u1", k=1, exact=True)
    assert got_exact == ["fresh"]


def test_build_runs_outside_the_state_lock(monkeypatch):
    """``ivf_maintenance`` runs the k-means without holding the index's
    state lock, so another thread's add and delete go through while it
    runs (with the lock held they would wait for the whole build); the
    build is then published with both replayed: the added row in the fresh
    residual and served, the deleted member row un-routed and counted
    toward the re-seed trigger."""
    import threading

    import lazzaro_tpu_torch.core.index as index_mod

    d, n = 32, 5000
    _, idx, emb = _both_indexes(n, d, 12)
    late = np.zeros((1, d), np.float32)
    late[0, 7] = 1.0
    gone = idx.id_to_row["m3"]
    real, wrote = index_mod.build_ivf, []

    def build(*args, **kwargs):
        def writer():
            idx.add(["late"], late, [0.5], [0.0], ["semantic"], ["default"],
                    "u1")
            idx.delete(["m3"])
            wrote.append(True)

        t = threading.Thread(target=writer)
        t.start()
        t.join(timeout=30)
        assert wrote, "a write waited for the build"
        return real(*args, **kwargs)

    monkeypatch.setattr(index_mod, "build_ivf", build)
    assert idx.ivf_maintenance()
    assert bool((idx._ivf.members == gone).any())    # built while alive
    assert not idx._ivf_routed[gone] and idx._ivf_stale == 1
    assert idx._ivf_fresh == [idx.id_to_row["late"]]
    (got, _), = idx.search_batch(late, "u1", k=1)
    assert got == ["late"]
    (got, _), = idx.search_batch(emb[3:4], "u1", k=1)
    assert got != ["m3"]


def test_system_maintenance_hook_builds_ivf(tmp_path):
    """With ``ivf_serving`` on, the consolidation's maintenance hook builds
    the coarse index once ingest passes the threshold; no serving query
    pays for the k-means."""
    d, per, convs = 16, 1600, 3

    class Emb:
        dim = d

        def _v(self, t):
            rng = np.random.default_rng(abs(hash(t)) % (1 << 31))
            v = rng.standard_normal(d)
            return (v / np.linalg.norm(v)).tolist()

        def embed(self, t):
            return self._v(t)

        def batch_embed(self, ts):
            return [self._v(t) for t in ts]

    class LLM:
        def __init__(self):
            self.c = 0

        def completion(self, messages, response_format=None):
            base = self.c * per
            self.c += 1
            return _json.dumps({"memories": [
                {"content": f"fact {base + i} body", "type": "semantic",
                 "salience": 0.6} for i in range(per)]})

        def completion_stream(self, messages, response_format=None):
            yield self.completion(messages, response_format)

    ms = MemorySystem(enable_async=False, db_dir=str(tmp_path / "db"),
                      verbose=False, load_from_disk=False,
                      llm_provider=LLM(), embedding_provider=Emb(),
                      max_buffer_size=20000, device="cpu",
                      config=MemoryConfig(journal=False, ivf_serving=4,
                                          initial_capacity=8192,
                                          auto_consolidate=False))
    for c in range(convs):
        ms.start_conversation()
        ms.add_to_short_term(f"conversation {c}", "episodic", 0.7)
        ms.end_conversation()
        if c < convs - 1:
            assert ms.index._ivf is None
    assert ms.index._ivf is not None
    assert ms.index.stats()["ivf"] == "nprobe=4, built, online"
    assert ms.get_stats()["ivf_add_extras_spills"] == 0
    assert ms.search_memories("fact 42 body")
    ms.close()


def test_delete_readd_churn_triggers_rebuild_and_serves_new_vector():
    d, n = 32, 5000
    rng = np.random.default_rng(11)
    emb = _unit_rows(n, d, 11)
    rng = np.random.default_rng(12)
    idx = MemoryIndex(dim=d, capacity=n + 64, ivf_nprobe=8, device="cpu")
    ids = [f"m{i}" for i in range(n)]
    idx.add(ids, emb, [0.5] * n, [0.0] * n, ["semantic"] * n,
            ["default"] * n, "u1")
    assert idx.ivf_maintenance()
    built = idx._ivf
    churn = [f"m{i}" for i in range(0, n, 3)]
    idx.delete(churn)
    emb2 = _unit_rows(len(churn), d, 13)
    idx.add(churn, emb2, [0.5] * len(churn), [0.0] * len(churn),
            ["semantic"] * len(churn), ["default"] * len(churn), "u1")
    for want, (got, _) in zip(churn[:20], idx.search_batch(emb2[:20], "u1",
                                                           k=3)):
        assert got and got[0] == want
        assert len(got) == len(set(got))
    for _ in range(3):
        idx.delete(churn[:50])
        idx.add(churn[:50], emb2[:50], [0.5] * 50, [0.0] * 50,
                ["semantic"] * 50, ["default"] * 50, "u1")
    fresh = idx._ivf_fresh
    assert len(fresh) == len(set(fresh))
    assert idx._ivf_stale > built.built_rows // 4
    assert idx.ivf_maintenance()
    assert idx._ivf is not built
    assert idx._ivf_stale == 0


def _built_index(n=5000, d=32, seed=20):
    emb = _unit_rows(n, d, seed)
    idx = MemoryIndex(dim=d, capacity=n + 64, ivf_nprobe=8, device="cpu")
    idx.add([f"m{i}" for i in range(n)], emb, [0.5] * n, [0.0] * n,
            ["semantic"] * n, ["default"] * n, "u1")
    assert idx.ivf_maintenance()
    return idx, emb


def test_stale_residual_cache_cross_slot_churn():
    d = 32
    idx, emb = _built_index(d=d)
    fresh_v = np.zeros((1, d), np.float32)
    fresh_v[0, 5] = 1.0
    idx.add(["f1"], fresh_v, [0.5], [0.0], ["semantic"], ["default"], "u1")
    f1_row = idx.id_to_row["f1"]
    (got, _), = idx.search_batch(fresh_v, "u1", k=1)
    assert got == ["f1"]
    assert idx._ivf_res_cache is not None
    idx.delete(["f1", "m0"])
    fresh_v2 = np.zeros((1, d), np.float32)
    fresh_v2[0, 7] = 1.0
    idx.add(["f2"], fresh_v2, [0.5], [0.0], ["semantic"], ["default"], "u1")
    assert idx.id_to_row["f2"] != f1_row
    assert len(idx._ivf_fresh) == 1
    (got, _), = idx.search_batch(fresh_v2, "u1", k=1)
    assert got == ["f2"], "stale cached residual dropped the live row"


def test_ivf_setter_reconstructs_routed_bitmaps():
    idx, emb = _built_index(seed=21)
    build = idx._ivf
    idx._ivf = build
    assert idx._ivf_routed is not None and idx._ivf_routed.any()
    assert idx._ivf_in_residual is not None
    for _ in range(3):
        idx.add(["m1", "m2"], emb[1:3], [0.5] * 2, [0.0] * 2,
                ["semantic"] * 2, ["default"] * 2, "u1")
    assert idx._ivf_fresh == []
    v = np.zeros((1, emb.shape[1]), np.float32)
    v[0, 3] = 1.0
    for _ in range(2):
        idx.add(["fresh1"], v, [0.5], [0.0], ["semantic"], ["default"], "u1")
    assert idx._ivf_fresh == [idx.id_to_row["fresh1"]]


def test_ivf_duplicate_rows_do_not_shorten_results():
    idx, emb = _built_index(seed=22)
    row = idx.id_to_row["m0"]
    idx.delete(["m0"])
    idx.add(["m0"], emb[:1], [0.5], [0.0], ["semantic"], ["default"], "u1")
    assert idx.id_to_row["m0"] == row
    assert row in idx._ivf_fresh
    (got, _), = idx.search_batch(emb[:1], "u1", k=5)
    assert got[0] == "m0"
    assert len(got) == 5 and len(set(got)) == 5


def test_residual_cache_keyed_on_residual_buffer_identity():
    idx, emb = _built_index(seed=23)
    ivf, fresh = idx._ivf_pack
    dev0 = idx._ivf_residual_dev(ivf, fresh)
    assert idx._ivf_residual_dev(ivf, fresh) is dev0
    new_res = np.full(tuple(ivf.residual.shape), -1, np.int32)
    new_res[0] = idx.id_to_row["m3"]
    ivf.residual = torch.from_numpy(new_res.copy())
    dev1 = idx._ivf_residual_dev(ivf, fresh)
    assert dev1 is not dev0
    assert idx.id_to_row["m3"] in dev1.tolist()
    dev2 = idx._ivf_extras_dev(ivf, fresh)
    assert idx._ivf_extras_dev(ivf, fresh) is dev2
    new_res[1] = idx.id_to_row["m4"]
    ivf.residual = torch.from_numpy(new_res.copy())
    dev3 = idx._ivf_extras_dev(ivf, fresh)
    assert dev3 is not dev2
    assert idx.id_to_row["m4"] in dev3.tolist()


# ------------------------------------------------------------ parity traps
def test_segment_sums_bit_equal_to_xla_scatter_add():
    """The k-means and online cluster sums add each cluster's rows in row
    order, as XLA's CPU scatter-add does: bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5000, 48)).astype(np.float32)
    seg = rng.integers(0, 33, 5000)
    want = jnp.zeros((33, 48), jnp.float32).at[jnp.asarray(seg)].add(
        jnp.asarray(x))
    got = TI.segment_sum(33, torch.from_numpy(seg), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_build_is_deterministic_and_assignments_match_jax():
    """Two builds of one arena are equal bit for bit; the final
    assignments equal JAX's on a separated fixture."""
    emb, _ = _clustered(24, 60, 32, seed=30)
    mask = np.ones(len(emb), bool)
    mask[::17] = False
    a = TI.build_ivf(torch.from_numpy(emb), mask, seed=5)
    b = TI.build_ivf(torch.from_numpy(emb), mask, seed=5)
    for f in ("centroids", "members", "residual"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    jb = JI.build_ivf(jnp.asarray(emb), mask, seed=5)
    ja = np.asarray(JI._assign_device(jnp.asarray(emb), jnp.asarray(mask),
                                      jb.centroids))
    ta = TI._assign_masked(torch.from_numpy(emb), torch.from_numpy(mask),
                           a.centroids).numpy()
    np.testing.assert_array_equal(ta, ja)
    assert TI.assignment_staleness(torch.from_numpy(emb), mask, a.centroids,
                                   a.members) == 0.0


def _grid(rng, shape):
    """Multiples of 1/16 in [-1, 1]: products and sums exact in f32 in any
    order, so equal scores are exact ties on both packages."""
    return (np.round(rng.uniform(-1, 1, shape) * 16) / 16).astype(np.float32)


def _jax_candidate_lists(emb, alive, tenant, sup, members, extras, cids,
                         qd, q_ten, kf, g):
    """The exact form of ``_ivf_two_tier``'s candidate stage in JAX:
    ``gather_rows`` from given cluster ids, the tenant mask, the einsum,
    and the two ``lax.top_k`` calls with their positions and rows."""
    import jax

    nq = cids.shape[0]
    cand = jnp.concatenate([jnp.asarray(members)[jnp.asarray(cids)].reshape(
        nq, -1), jnp.broadcast_to(jnp.asarray(extras)[None, :],
                                  (nq, extras.shape[0]))], axis=1)
    safe = jnp.maximum(cand, 0)
    valid = ((cand >= 0) & jnp.asarray(alive)[safe]
             & (jnp.asarray(tenant)[safe] == jnp.asarray(q_ten)[:, None]))
    s = jnp.asarray(sup)[safe]
    sc = jnp.einsum("cd,cld->cl", jnp.asarray(qd), jnp.asarray(emb)[safe],
                    preferred_element_type=jnp.float32)
    out = []
    for m, kk in ((valid & ~s, kf), (valid & s, g)):
        ts, pos = jax.lax.top_k(jnp.where(m, sc, -1e30), kk)
        out += [np.asarray(ts), np.asarray(pos),
                np.asarray(jnp.take_along_axis(cand, pos, axis=1))]
    return out


def test_candidate_ties_and_fill_follow_position_not_row():
    """K5's plain version against JAX's candidate stage on grid rows with
    exact ties: the same row at several positions (a member slot and the
    extras), equal scores of distinct rows placed so that row order and
    position order disagree, a query whose tenant holds fewer valid
    candidates than the list (the fill is the lowest other positions at
    NEG_INF, carrying -1 padding and other tenants' rows). Scores,
    positions and rows are equal."""
    rng = np.random.default_rng(3)
    n, d = 96, 16
    emb = _grid(rng, (n, d))
    emb[40] = emb[7]                       # equal scores, distinct rows
    emb[90] = emb[7]
    alive = np.ones(n, bool)
    alive[[3, 50]] = False
    tenant = (np.arange(n) % 3 == 0).astype(np.int32)   # tenant 1: every third
    sup = np.zeros(n, bool)
    sup[[9, 30, 60]] = True
    members = np.full((6, 8), -1, np.int32)
    for c in range(6):
        rows = np.arange(c, n, 6)[:5 + c % 3]
        members[c, :len(rows)] = rows[::-1]              # rows descending
    extras = np.full((8,), -1, np.int32)
    extras[:4] = [90, 9, 40, 61]                         # repeats + a super
    cids = np.array([[0, 1, 2], [1, 4, 0], [5, 3, 2], [2, 0, 4]], np.int32)
    q = _grid(rng, (4, d))
    q[1] = emb[7]
    q_ten = np.array([0, 0, 1, 1], np.int32)
    kf, g = 30, 3
    want = _jax_candidate_lists(emb, alive, tenant, sup, members, extras,
                                cids, q, q_ten, kf, g)
    got = K5.ivf_topk(torch.from_numpy(emb), torch.from_numpy(members),
                      torch.from_numpy(extras), torch.from_numpy(cids),
                      torch.from_numpy(q), kf, g=g,
                      cols=(torch.from_numpy(alive), torch.from_numpy(tenant),
                            torch.from_numpy(sup)),
                      q_tenant=torch.from_numpy(q_ten))
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), w)
    fill = want[0] <= -1e29
    assert fill[2:].any() and (want[2][fill] == -1).any()


def _kernel_order_dot(x, q):
    """K5's sum of one pair (``csrc/topk_scan.cuh:gv_dots``), scalar by
    scalar in f32: lane ``c % 32`` adds chunk ``c``'s 8 products, each
    rounded before it is added, in column order; then the butterfly."""
    acc = np.zeros(32, np.float32)
    for c in range(len(x) // 8):
        for i in range(8):
            prod = np.float32(x[8 * c + i]) * np.float32(q[8 * c + i])
            acc[c % 32] = np.float32(acc[c % 32] + prod)
    w = 32
    while w > 1:
        w //= 2
        acc = (acc[:w] + acc[w:2 * w]).astype(np.float32)
    return acc[0]


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("d", [8, 24, 264, 768])
def test_k5_plain_version_sums_in_the_kernel_order(dtype, d):
    """The plain version scores each pair in the kernel's order on
    Gaussian data (not grid values, whose sums are exact in any order), so
    the card's bit-equality of the two holds on real embeddings: equal to a
    scalar replay of the kernel's sum, bit for bit, at widths that fill
    the warp's lanes, fall short of them and wrap past them."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((12, d)).astype(dtype)
    q = rng.standard_normal((3, d)).astype(np.float32)
    got = K5.lane_dot(torch.from_numpy(x.astype(np.float32))[None, :, :],
                      torch.from_numpy(q)[:, None, :]).numpy()
    want = np.array([[_kernel_order_dot(x[j].astype(np.float32), q[i])
                      for j in range(12)] for i in range(3)], np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_classic_search_fill_matches_jax(dtype):
    """The classic form on a mask with fewer live candidates than k: the
    rows past the live ones are the lowest masked positions' slot values,
    as ``ivf_search`` returns them."""
    emb, _ = _clustered(8, 20, 32, seed=40)
    emb = emb.astype(dtype)
    mask = np.zeros(len(emb), bool)
    mask[::11] = True
    jb = JI.build_ivf(jnp.asarray(emb.astype(np.float32)),
                      np.ones(len(emb), bool), n_clusters=8, seed=2)
    tb = TI.IvfIndex(torch.from_numpy(np.array(jb.centroids)),
                     torch.from_numpy(np.array(jb.members)),
                     torch.from_numpy(np.array(jb.residual)), jb.built_rows)
    temb = torch.from_numpy(emb.view(np.int16).copy()).view(torch.bfloat16) \
        if dtype != np.float32 else torch.from_numpy(emb)
    q = emb[:6].astype(np.float32)
    js, jr = JI.ivf_search(jb.centroids, jb.members, jb.residual,
                           jnp.asarray(emb), jnp.asarray(mask),
                           jnp.asarray(q), k=20, nprobe=2)
    ts, tr = TI.ivf_search(tb.centroids, tb.members, tb.residual, temb,
                           torch.from_numpy(mask), torch.from_numpy(q), k=20,
                           nprobe=2)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_TOL)
    assert (np.asarray(js) <= -1e29).any()


def test_coarse_stage_matches_jax_top_nprobe():
    """The coarse stage (the masked top-k over the centroid table) gives
    JAX's cluster ids in rank order."""
    emb, _ = _clustered(16, 40, 32, seed=50)
    mask = np.ones(len(emb), bool)
    jb, tb = _builds(emb, mask, n_clusters=16, seed=4)
    q = emb[::13][:20]
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cs = jnp.dot(jnp.asarray(qn), jb.centroids.T)
    import jax
    _, want = jax.lax.top_k(cs, 5)
    got = TI.coarse_clusters(tb.centroids, torch.from_numpy(qn), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_rows_and_candidates_match_jax():
    """The plain candidate assembly (``gather_rows``, ``gather_candidates``):
    the same candidate rows, gather-safe rows and validity as JAX's."""
    emb, _ = _clustered(16, 30, 32, seed=60)
    mask = np.ones(len(emb), bool)
    mask[::7] = False
    jb, tb = _builds(emb, mask, n_clusters=16, seed=5)
    q = emb[::11][:9]
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    extras = TI.pack_extras(np.asarray(jb.residual), [3, 40], [7])
    jc, js = JI.gather_rows(jb.centroids, jb.members, jnp.asarray(extras),
                            jnp.asarray(qn), 3)
    tc, ts = TI.gather_rows(tb.centroids, tb.members, torch.from_numpy(extras),
                            torch.from_numpy(qn), 3)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = JI.gather_candidates(jb.centroids, jb.members, jb.residual,
                                jnp.asarray(mask), jnp.asarray(qn), 3)
    got = TI.gather_candidates(tb.centroids, tb.members, tb.residual,
                               torch.from_numpy(mask), torch.from_numpy(qn), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ivf_topk_takes_only_cpu_and_cuda_tensors():
    """A CPU tensor runs the plain version (no launch counted); the keyed
    and the classic forms are told apart by their arguments."""
    before = K5.launches
    emb = torch.from_numpy(_unit_rows(16, 8, 0))
    members = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    extras = torch.full((8,), -1, dtype=torch.int32)
    cids = torch.zeros((1, 1), dtype=torch.int32)
    s, p, r, *_ = K5.ivf_topk(emb, members, extras, cids, emb[:1], 3,
                              mask=torch.ones(16, dtype=torch.bool))
    assert int(r[0, 0]) == 0 and int(p[0, 0]) == 0      # the query's own row
    assert abs(float(s[0, 0]) - 1.0) < 1e-6
    assert set(r[0].tolist()) <= set(range(8))          # cluster 0's rows
    assert K5.launches == before
    with pytest.raises(ValueError):
        K5.ivf_topk(emb, members, extras, cids, emb[:1], 3)
    assert K5.route_for("int8") == "dp4a" and K5.route_for("exact") == "fma"


def test_restore_preserves_ivf_serving_config(tmp_path):
    """``config.ivf_serving`` survives ``load_snapshot`` as ``int8_serving``
    does (``tests/test_snapshot.py``'s case): the restored index keeps its
    probe width, so the consolidation's maintenance hook still builds."""
    def system(db):
        return MemorySystem(enable_async=False, db_dir=str(tmp_path / db),
                            verbose=False, load_from_disk=False, device="cpu",
                            config=MemoryConfig(journal=False,
                                                int8_serving=True,
                                                ivf_serving=6))

    ms = system("db")
    ms.start_conversation()
    ms.chat("I work as a data engineer on a big ETL project.")
    ms.end_conversation()
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    ms.close()
    ms2 = system("db2")
    assert "loaded" in ms2.load_snapshot(snap)
    assert ms2.index.ivf_nprobe == 6
    assert ms2.index.int8_serving
    ms2.close()
