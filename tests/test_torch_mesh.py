"""The port's row-sharded arena against the JAX package's: the mesh, the
cross-shard merge (``ops.topk.sharded_topk_merge``, the plain version of the
merge kernel), ``make_sharded_topk`` and the fused sharded serving program
(``core.state.search_fused_sharded[_read]``) on a CPU ``Mesh`` of 2 and 8
shards, against the JAX ``make_sharded_topk`` / ``sharded_topk_merge`` /
``make_fused_sharded(mode="exact", ragged=True)`` on the 8-device CPU mesh
and against the JAX single-device functions.

Inputs are made with numpy from a seed. Tolerances: rows, gate verdicts, the
integer counters of the packed readback and ``access_count`` are exact.
Scores on a 1/256 grid are exact (their products and sums are exact in f32,
whatever the order); other scores agree within 1e-6: the JAX sharded
programs themselves differ from the single-device ones by about one f32 ulp
at n = 4 and 8 (XLA's CPU matmul rounds another way at the per-shard shape).
Salience and ``last_accessed`` after the boosts agree within 1e-6 (the same
f32 operations in the JAX order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from lazzaro_tpu.core import state as JS
from lazzaro_tpu.core.index import build_host_csr, split_csr
from lazzaro_tpu.ops.topk import make_sharded_topk as jax_make_sharded_topk
from lazzaro_tpu.ops.topk import masked_topk as jax_masked_topk
from lazzaro_tpu.ops.topk import sharded_topk_merge as jax_sharded_merge
from lazzaro_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lazzaro_tpu.parallel.mesh import shard_stacked
from lazzaro_tpu.utils.batching import unpack_retrieval as jax_unpack
from lazzaro_tpu.utils.compat import shard_map
from lazzaro_tpu_torch.core import state as TS
from lazzaro_tpu_torch.core.index import split_csr as torch_split_csr
from lazzaro_tpu_torch.ops import sharded_merge as sm
from lazzaro_tpu_torch.ops.topk import NEG_INF, make_sharded_topk
from lazzaro_tpu_torch.parallel import make_mesh
from lazzaro_tpu_torch.utils.batching import unpack_retrieval


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def jax_mesh(n):
    return jax_make_mesh(("data",), (n,), devices=jax.devices()[:n])


def grid(rng, shape):
    """Normal draws on a 1/256 grid: f32 products and sums are exact."""
    return (np.round(rng.standard_normal(shape) * 16) / 256).astype(np.float32)


# ------------------------------------------------------------------- mesh
def test_make_mesh_shapes_and_devices():
    mesh = cpu_mesh(8)
    assert mesh.shape == {"data": 8} and mesh.size == 8
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert make_mesh(("data",), (2,), devices=["cpu", "cpu"]).shape["data"] == 2
    with pytest.raises(ValueError):
        make_mesh(("data",), (4,), devices=["cpu"] * 8)


def test_make_mesh_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(devices=["cuda:0"] * 8)


def test_unported_mesh_forms_raise():
    from lazzaro_tpu_torch.parallel import (make_hybrid_mesh,
                                            replica_group_meshes)

    with pytest.raises(NotImplementedError, match="Queue 1 item 21"):
        make_mesh(("data", "model"), (4, 2), devices=["cpu"] * 8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 21"):
        make_hybrid_mesh(("data",), (8,))
    with pytest.raises(NotImplementedError, match="Queue 1 item 21"):
        replica_group_meshes(2)


# ------------------------------------------------------------------ merge
def _jax_merge(n, s, i, k, k_q=None, sentinel=-1):
    """The JAX ``sharded_topk_merge`` inside a ``shard_map`` over the
    8-device CPU mesh; ``s``/``i`` are ``[n, Q, kl]`` with global rows."""
    mesh = jax_mesh(n)
    q, kl = s.shape[1:]

    def body(s_l, i_l, *kq):
        return jax_sharded_merge("data", s_l, i_l, k,
                                 k_q=kq[0] if kq else None, sentinel=sentinel)

    extra = () if k_q is None else (jnp.asarray(k_q),)
    fn = shard_map(body, mesh=mesh,
                   in_specs=(P("data", None), P("data", None))
                   + ((P(None),) if extra else ()),
                   out_specs=(P(None, None), P(None, None)), check_vma=False)
    out = jax.jit(fn)(jnp.asarray(s.reshape(n * q, kl)),
                      jnp.asarray(i.reshape(n * q, kl)), *extra)
    return [np.asarray(x) for x in out]


def _lists(rng, n, q, kl, local_n, masked=0.0):
    """Per-shard candidate lists in ``stable_topk`` order: grid scores with
    ties inside and across shards, sorted, local rows ascending on ties;
    a ``masked`` share of the tail at NEG_INF."""
    s = grid(rng, (n, q, kl)) / 4
    s = np.where(rng.random((n, q, kl)) < masked, NEG_INF, s).astype(np.float32)
    rows = np.stack([np.stack([rng.choice(local_n, kl, replace=False)
                               for _ in range(q)]) for _ in range(n)])
    order = np.lexsort((rows, -s), axis=-1)
    return (np.take_along_axis(s, order, -1),
            np.take_along_axis(rows, order, -1).astype(np.int32))


@pytest.mark.parametrize("n,q,kl,k,masked", [
    (8, 6, 3, 10, 0.0),       # ties across shards on the grid
    (8, 4, 3, 24, 0.3),       # every candidate kept, masked entries
    (2, 5, 4, 4, 0.5),
    (8, 7, 1, 1, 0.2),        # the gate at k = 1
])
def test_merge_matches_jax_merge(n, q, kl, k, masked):
    rng = np.random.default_rng(n * 100 + kl)
    local_n = 16
    s, r = _lists(rng, n, q, kl, local_n, masked)
    glob = r + (np.arange(n) * local_n)[:, None, None]
    js, ji = _jax_merge(n, s, glob, k)
    ts, ti = sm.sharded_merge([torch.from_numpy(x) for x in s],
                              [torch.from_numpy(x) for x in r], local_n, k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ts.numpy(), js)
    # the sentinel: masked entries route to it, as _globalize_rows does
    sent = n * local_n - 1
    js, ji = _jax_merge(n, s, np.where(s > NEG_INF / 2, glob, sent), k)
    ts, ti = sm.sharded_merge([torch.from_numpy(x) for x in s],
                              [torch.from_numpy(x) for x in r], local_n, k,
                              sentinel=sent)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_ragged_merge_matches_jax_merge():
    """``k_q`` cuts each query at its own k; past it (NEG_INF, sentinel)."""
    rng = np.random.default_rng(5)
    n, q, kl, k, local_n = 8, 6, 4, 16, 8
    s, r = _lists(rng, n, q, kl, local_n, 0.25)
    sent = n * local_n - 1
    glob = np.where(s > NEG_INF / 2, r + (np.arange(n) * local_n)[:, None, None],
                    sent)
    k_q = np.array([1, 5, 16, 0, 10, 3], np.int32)
    js, ji = _jax_merge(n, s, glob, k, k_q=k_q, sentinel=sent)
    ts, ti = sm.sharded_merge([torch.from_numpy(x) for x in s],
                              [torch.from_numpy(x) for x in r], local_n, k,
                              k_q=torch.from_numpy(k_q), sentinel=sent)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert (ti.numpy()[3] == sent).all() and (ts.numpy()[0, 1:] == NEG_INF).all()


def test_merge_of_one_shard_lists_equals_their_top_k():
    """n = 1 and i64 rows (the classic scan's): the merge is the list."""
    rng = np.random.default_rng(9)
    s, r = _lists(rng, 1, 3, 8, 64)
    ts, ti = sm.sharded_merge([torch.from_numpy(s[0])],
                              [torch.from_numpy(r[0]).long()], 64, 8)
    np.testing.assert_array_equal(ts.numpy(), s[0])
    np.testing.assert_array_equal(ti.numpy(), r[0])


# ------------------------------------------------------- make_sharded_topk
@pytest.mark.parametrize("n,local_n,k,q", [
    (8, 4, 10, 3),            # L < k
    (8, 16, 10, 5),
    (2, 40, 7, 4),
])
def test_make_sharded_topk_matches_jax(n, local_n, k, q):
    """Grid rows: exact ties across shards, dead rows, a dead shard."""
    rng = np.random.default_rng(local_n)
    rows = n * local_n
    emb = grid(rng, (rows, 16))
    emb[rows // 3] = emb[1]                     # exact ties across shards
    emb[rows - 2] = emb[1]
    mask = rng.random(rows) > 0.2
    mask[local_n:2 * local_n] = False           # an all-masked shard
    query = grid(rng, (q, 16))
    query[0] = emb[1]
    jmesh = jax_mesh(n)
    js, ji = jax_make_sharded_topk(jmesh, "data", k=k)(
        jax.device_put(jnp.asarray(emb), NamedSharding(jmesh, P("data", None))),
        jax.device_put(jnp.asarray(mask), NamedSharding(jmesh, P("data"))),
        jnp.asarray(query))
    search = make_sharded_topk(cpu_mesh(n), "data", k=k)
    shards = [torch.from_numpy(emb[p * local_n:(p + 1) * local_n])
              for p in range(n)]
    masks = [torch.from_numpy(mask[p * local_n:(p + 1) * local_n])
             for p in range(n)]
    ts, ti = search(shards, masks, torch.from_numpy(query))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # and the single-device masked top-k over the whole arena
    os_, oi = jax_masked_topk(jnp.asarray(emb), jnp.asarray(mask),
                              jnp.asarray(query), k)
    live = np.asarray(os_) > NEG_INF / 2
    np.testing.assert_array_equal(ti.numpy()[live], np.asarray(oi)[live])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(os_))


def test_make_sharded_topk_matches_the_pallas_shards():
    """The JAX function with its per-shard Pallas scan (interpret mode on
    the CPU mesh) on block-alignable shards, real-valued unit rows: rows
    exact, scores within 1e-6."""
    rng = np.random.default_rng(3)
    n, local_n, d, k = 8, 4096, 64, 8
    emb = rng.standard_normal((n * local_n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    mask = rng.random(n * local_n) > 0.1
    q = emb[[7, 9000, 30000]] + 0.05 * rng.standard_normal((3, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jmesh = jax_mesh(n)
    js, ji = jax_make_sharded_topk(jmesh, "data", k=k, impl="pallas")(
        jax.device_put(jnp.asarray(emb), NamedSharding(jmesh, P("data", None))),
        jax.device_put(jnp.asarray(mask), NamedSharding(jmesh, P("data"))),
        jnp.asarray(q))
    ts, ti = make_sharded_topk(cpu_mesh(n), k=k)(
        [torch.from_numpy(emb[p * local_n:(p + 1) * local_n]) for p in range(n)],
        [torch.from_numpy(mask[p * local_n:(p + 1) * local_n]) for p in range(n)],
        torch.from_numpy(q))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


# ------------------------------------------- the fused sharded program
D = 16
CAP = 127            # cap + 1 = 128 divides by 2 and 8
CT, MN = 5, 8
SCALARS = (1000.0, 0.4, 0.05, 0.02)   # now, super_gate, acc_boost, nbr_boost


def fused_fixture(seed=0, n_rows=90, tenants=2, super_every=9, q=8):
    """``tests/test_fused_sharded_serving.py``'s arena, CSR and batch, made
    with numpy and written through the JAX ``arena_add_copy``; a per-query
    k and cap for the ragged program."""
    rng = np.random.default_rng(seed)
    st = JS.init_arena(CAP, D, jnp.float32)
    emb = rng.standard_normal((n_rows, D)).astype(np.float32)
    rows = np.arange(n_rows, dtype=np.int32)
    tcol = (np.arange(n_rows) % tenants).astype(np.int32)
    sup = np.arange(n_rows) % super_every == 0
    st = JS.arena_add_copy(st, jnp.asarray(rows), jnp.asarray(emb),
                           jnp.full((n_rows,), 0.5, jnp.float32),
                           jnp.zeros((n_rows,), jnp.float32),
                           jnp.zeros((n_rows,), jnp.int32),
                           jnp.zeros((n_rows,), jnp.int32),
                           jnp.asarray(tcol), jnp.asarray(sup))
    id_to_row = {f"n{i}": i for i in range(n_rows)}
    keys = ([(f"n{i}", f"n{i + 1}") for i in range(n_rows - 1)]
            + [(f"n{i}", f"n{(i * 7) % n_rows}") for i in range(0, n_rows, 5)])
    indptr, nbr = build_host_csr(keys, id_to_row, CAP + 1)
    rq = np.random.default_rng(seed + 1)
    qv = rq.standard_normal((q, D)).astype(np.float32)
    qv[0] = emb[9] + 0.01 * qv[0]                  # a gate hit (super row 9)
    q_valid = np.ones((q,), bool)
    q_valid[-1] = False
    tq = (np.arange(q) % tenants).astype(np.int32)
    gate_on = np.ones((q,), bool)
    boost_on = np.arange(q) % 3 != 2
    return st, indptr, nbr, (qv, q_valid, tq, gate_on, boost_on)


def torch_shards(st, n):
    cols = {f: np.asarray(getattr(st, f)) for f in TS.ARENA_FIELDS}
    return TS.shards_from_numpy(cols, [torch.device("cpu")] * n)


def torch_csr(indptr, nbr, n):
    ish, nsh = torch_split_csr(indptr, nbr, n)
    return [(torch.from_numpy(ish[p]), torch.from_numpy(nsh[p]))
            for p in range(n)]


def assert_same_packed(jp, tp, k, exact_scores=False):
    j, t = jax_unpack(np.asarray(jp), k), unpack_retrieval(tp.numpy(), k)
    for i in (1, 3, 4, 5):                # gate rows, ANN rows, verdicts, counters
        np.testing.assert_array_equal(t[i], j[i])
    for i in (0, 2):
        np.testing.assert_allclose(t[i], j[i], rtol=0,
                                   atol=0 if exact_scores else 1e-6)
    return t


def assert_same_boosts(jcols, tshards):
    for name, atol in (("access_count", 0), ("salience", 1e-6),
                       ("last_accessed", 1e-6)):
        got = torch.cat([getattr(s, name) for s in tshards]).numpy()
        np.testing.assert_allclose(got, np.asarray(jcols[name]), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("n,k", [(2, 8), (8, 8), (8, 32)])
def test_fused_sharded_matches_jax_sharded_and_single(n, k):
    """The serve program: packed readback and the boosted columns against
    the JAX ``make_fused_sharded(exact, ragged)`` on the same n and the JAX
    single-device ``search_fused_ragged``. n = 8, k = 32 has L = 16 < k."""
    st, indptr, nbr, (qv, q_valid, tq, gate_on, boost_on) = fused_fixture()
    k_q = np.array([k, 5, 3, k, 1, 7, 2, 0], np.int32)
    cap_q = np.array([5, 5, 2, 5, 1, 3, 5, 0], np.int32)
    now, gate, accb, nbrb = SCALARS
    jargs = (jnp.asarray(qv), jnp.asarray(q_valid), jnp.asarray(tq),
             jnp.asarray(gate_on), jnp.asarray(boost_on), jnp.asarray(k_q),
             jnp.asarray(cap_q))
    tail = tuple(jnp.float32(x) for x in SCALARS)
    jmesh = jax_mesh(n)
    kern = JS.make_fused_sharded(jmesh, "data", k=k, cap_take=CT, max_nbr=MN,
                                 mode="exact", ragged=True)
    stk = shard_stacked(jmesh, "data")
    ish, nsh = (jax.device_put(a, stk) for a in split_csr(indptr, nbr, n))
    st_sh = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(
            jmesh, P("data", None) if a.ndim == 2 else P("data"))), st)
    jst2, jp = kern.serve_copy(st_sh, (), ish, nsh, *jargs[:5], jargs[5],
                               jargs[6], jnp.zeros((8,), jnp.int32), *tail)
    jst1, jp1 = JS.search_fused_ragged_copy(
        st, jnp.asarray(indptr), jnp.asarray(nbr), *jargs, *tail, k=k,
        cap_take=CT, max_nbr=MN)

    shards = torch_shards(st, n)
    tp = TS.search_fused_sharded(
        shards, torch_csr(indptr, nbr, n), *(torch.from_numpy(x) for x in
                                             (qv, q_valid, tq, gate_on,
                                              boost_on, k_q, cap_q)),
        now, gate, accb, nbrb, k=k, cap_take=CT, max_nbr=MN,
        k_live=int(k_q.max()))
    t = assert_same_packed(jp, tp, k)
    assert_same_boosts({f: getattr(jst2, f) for f in TS.ARENA_FIELDS}, shards)
    # the single-device program: the same rows, verdicts and boosts
    assert_same_packed(jp1, tp, k)
    assert_same_boosts({f: getattr(jst1, f) for f in TS.ARENA_FIELDS}, shards)
    gate_s, _, ann_s, ann_r, fast, counters = t
    assert fast[0] and not fast[:7].all()              # a hit and misses
    assert counters[:, 2].sum() > 0 and counters[:, 3].sum() > 0
    assert (ann_r[7] == CAP).all()          # the pad query: the sentinel
    assert (counters[~boost_on, 2:4] == 0).all()


@pytest.mark.parametrize("n", [2, 8])
def test_fused_sharded_read_matches_jax_and_mutates_nothing(n):
    st, indptr, nbr, (qv, q_valid, tq, gate_on, _) = fused_fixture(seed=4)
    k = 8
    k_q = np.array([8, 5, 3, 8, 1, 7, 2, 0], np.int32)
    jmesh = jax_mesh(n)
    kern = JS.make_fused_sharded(jmesh, "data", k=k, cap_take=CT, max_nbr=MN,
                                 mode="exact", ragged=True)
    stk = shard_stacked(jmesh, "data")
    ish, nsh = (jax.device_put(a, stk) for a in split_csr(indptr, nbr, n))
    st_sh = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(
            jmesh, P("data", None) if a.ndim == 2 else P("data"))), st)
    jp = kern.read(st_sh, (), ish, nsh, jnp.asarray(qv), jnp.asarray(q_valid),
                   jnp.asarray(tq), jnp.asarray(gate_on), jnp.asarray(k_q),
                   jnp.zeros((8,), jnp.int32), jnp.float32(SCALARS[1]))
    shards = torch_shards(st, n)
    before = [{f: getattr(s, f).clone() for f in TS.ARENA_FIELDS}
              for s in shards]
    tp = TS.search_fused_sharded_read(
        shards, torch_csr(indptr, nbr, n),
        *(torch.from_numpy(x) for x in (qv, q_valid, tq, gate_on, k_q)),
        SCALARS[1], k=k, cap_take=CT, max_nbr=MN, k_live=8)
    t = assert_same_packed(jp, tp, k)
    assert (t[5][:, 2:4] == 0).all()
    for s, b in zip(shards, before):
        for f in TS.ARENA_FIELDS:
            assert torch.equal(getattr(s, f), b[f]), f


def test_split_csr_matches_jax():
    st, indptr, nbr, _ = fused_fixture()
    for n in (2, 8):
        for a, b in zip(split_csr(indptr, nbr, n),
                        torch_split_csr(indptr, nbr, n)):
            np.testing.assert_array_equal(b, a)


def test_boost_scatter_of_a_shard_drops_rows_it_does_not_own():
    """``zero_last=False``: index L (a row of another shard) counts nowhere,
    and the shard's last row is a real row that does count."""
    cols = {f: np.asarray(getattr(fused_fixture()[0], f)) for f in TS.ARENA_FIELDS}
    shard = TS.shards_from_numpy(cols, [torch.device("cpu")] * 8)[7]
    L = shard.salience.shape[0]
    before = shard.access_count.clone()
    acc = torch.tensor([[L - 1, L, L]], dtype=torch.int32)
    nbr = torch.tensor([[L, 3, L]], dtype=torch.int32)
    TS._boost_scatter(shard, acc, nbr, torch.tensor(5.0), torch.tensor(0.05),
                      torch.tensor(0.02), zero_last=False)
    diff = (shard.access_count - before).tolist()
    assert diff[L - 1] == 1 and sum(diff) == 1
    assert shard.last_accessed[3] == 5.0 and shard.last_accessed[L - 1] == 5.0


# -------------------------------------- grouped scans: one launch per card
def test_shard_groups_are_runs_of_one_device():
    """Shards are grouped into runs of consecutive shards on one device, in
    shard order: a one-card mesh is one run, an interleaved one runs of
    one."""
    from lazzaro_tpu_torch.ops.topk import shard_groups

    dev = torch.device
    assert shard_groups(["cpu"] * 8) == [(dev("cpu"), list(range(8)))]
    assert shard_groups(["cuda:0"] * 2 + ["cuda:1"] * 2) == [
        (dev("cuda:0"), [0, 1]), (dev("cuda:1"), [2, 3])]
    assert shard_groups(["cuda:0", "cuda:1", "cuda:0"]) == [
        (dev("cuda:0"), [0]), (dev("cuda:1"), [1]), (dev("cuda:0"), [2])]


def test_grouped_scan_rows_are_global():
    """The grouped scan of shards 4-7 alone (its plain version on the CPU)
    lists global rows 4L .., equal to the single-device top-k over those
    rows shifted by 4L; the keyed form puts masked pairs on the sentinel."""
    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import masked_topk as mt

    rng = np.random.default_rng(11)
    n, local_n, d, k = 8, 16, 16, 10
    emb = grid(rng, (n * local_n, d))
    mask = rng.random(n * local_n) > 0.3
    q = grid(rng, (3, d))
    shards = [torch.from_numpy(emb[p * local_n:(p + 1) * local_n]) for p in range(n)]
    masks = [torch.from_numpy(mask[p * local_n:(p + 1) * local_n]) for p in range(n)]
    ids = [4, 5, 6, 7]
    s, r = mt.masked_topk_grouped([shards[p] for p in ids], [masks[p] for p in ids],
                                  torch.from_numpy(q), k, ids)
    ws, wr = jax_masked_topk(jnp.asarray(emb[4 * local_n:]),
                             jnp.asarray(mask[4 * local_n:]), jnp.asarray(q), k)
    np.testing.assert_array_equal(r.numpy(), np.asarray(wr) + 4 * local_n)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    tenant = np.where(mask, rng.integers(0, 2, n * local_n), -1).astype(np.int32)
    sup = rng.random(n * local_n) < 0.1
    states = [tuple(torch.from_numpy(np.ascontiguousarray(c[p * local_n:(p + 1) * local_n]))
                    for c in (emb, mask, tenant, sup)) for p in ids]
    sent = n * local_n - 1
    q_ten = torch.tensor([0, 1, 2], dtype=torch.int32)
    gs, gr, a_s, a_r = ft.fused_topk_grouped(states, torch.from_numpy(q), q_ten,
                                             torch.tensor([10, 4, 10], dtype=torch.int32),
                                             k, sent, shard_ids=ids)
    assert ((a_r >= 4 * local_n) | (a_r == sent)).all()
    assert (a_r[a_s <= NEG_INF / 2] == sent).all()
    assert (a_r[1, 4:] == sent).all() and (a_s[1, 4:] == NEG_INF).all()
    assert gr[2].item() == sent and gs[2] == NEG_INF          # tenant 2: no row


@pytest.mark.parametrize("split", [1, 4, 7])
def test_sharded_search_over_two_device_runs_matches_jax(monkeypatch, split):
    """``make_sharded_topk`` and the keyed sharded scan with the mesh's
    shards in two device runs (the grouping forced on the CPU mesh): the
    runs' grouped results joined by the merge equal the JAX
    ``make_sharded_topk`` and the one-run results."""
    from lazzaro_tpu_torch.ops import topk as tk

    rng = np.random.default_rng(split)
    n, local_n, d, k = 8, 16, 16, 10
    emb = grid(rng, (n * local_n, d))
    emb[n * local_n - 3] = emb[2]                   # a tie across the runs
    mask = rng.random(n * local_n) > 0.2
    mask[local_n:2 * local_n] = False
    q = grid(rng, (4, d))
    q[0] = emb[2]
    shards = [torch.from_numpy(emb[p * local_n:(p + 1) * local_n]) for p in range(n)]
    masks = [torch.from_numpy(mask[p * local_n:(p + 1) * local_n]) for p in range(n)]
    one = make_sharded_topk(cpu_mesh(n), k=k)(shards, masks, torch.from_numpy(q))
    st, indptr, nbr, (qv, _, tq, _, _) = fused_fixture(seed=split)
    tshards = torch_shards(st, n)
    k_q = torch.tensor([8, 5, 3, 8, 1, 7, 2, 0], dtype=torch.int32)
    one_fused = TS._fused_scan_sharded(tshards, torch.from_numpy(qv),
                                       torch.from_numpy(tq), 8, k_q, k_live=8)
    cpu = torch.device("cpu")
    monkeypatch.setattr(tk, "shard_groups", lambda devices: [
        (cpu, list(range(split))), (cpu, list(range(split, len(devices))))])
    monkeypatch.setattr(TS, "shard_groups", tk.shard_groups)
    two = make_sharded_topk(cpu_mesh(n), k=k)(shards, masks, torch.from_numpy(q))
    jmesh = jax_mesh(n)
    js, ji = jax_make_sharded_topk(jmesh, "data", k=k)(
        jax.device_put(jnp.asarray(emb), NamedSharding(jmesh, P("data", None))),
        jax.device_put(jnp.asarray(mask), NamedSharding(jmesh, P("data"))),
        jnp.asarray(q))
    for got in (one, two):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(js))
    two_fused = TS._fused_scan_sharded(tshards, torch.from_numpy(qv),
                                       torch.from_numpy(tq), 8, k_q, k_live=8)
    for a, b in zip(two_fused, one_fused):
        assert torch.equal(a, b)
