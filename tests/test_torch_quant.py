"""Quantized serving in the port against the JAX package: the shadow's
quantizer (``ops.quant.quantize_rows``), K4's plain version
(``ops.int8_topk``) against ``quantized_topk`` and the coarse stage of
``_quant_two_tier``, the quantized fused programs against
``search_fused_quant*``, and the port's versions of
``tests/test_quant.py`` and ``tests/test_fused_quant_serving.py``.

Tolerances: codes, scales, coarse scores and coarse lists are bit-equal
(the same f32 operations in the same order; the int32 dots are exact).
Rescored scores sum d f32 products in another order than XLA's einsum:
within 1e-6 for f32 arenas, 1e-5 for bf16 ones (the bf16 rows' products are
exact in f32, the sums differ in the last bits of a larger magnitude).
Rows, gate verdicts, counters and boosts are equal, except where two of
JAX's rescored scores sit within that tolerance of each other:
``test_quant_programs_match_jax`` counts the queries whose rows come back
in another order there (``NEAR_TIE_SWAPS``). On this file's fixture the
bf16 arena's k = 16 lists hold one such pair and no query's rows swap.
"""

import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lazzaro_tpu.core import state as JS
from lazzaro_tpu.core.index import build_host_csr as jax_build_host_csr
from lazzaro_tpu.ops.quant import quantize_rows as jax_quantize_rows
from lazzaro_tpu.ops.quant import quantized_topk as jax_quantized_topk
from lazzaro_tpu.utils.batching import unpack_retrieval as jax_unpack
from lazzaro_tpu_torch import MemorySystem
from lazzaro_tpu_torch.config import MemoryConfig
from lazzaro_tpu_torch.core import state as TS
from lazzaro_tpu_torch.core.index import MemoryIndex
from lazzaro_tpu_torch.ops import int8_topk as K4
from lazzaro_tpu_torch.ops.quant import quantize_rows
from lazzaro_tpu_torch.serve import RetrievalRequest
from lazzaro_tpu_torch.utils.batching import unpack_retrieval
from tests.test_torch_fused_ingest import ClusteredEmb, QueueLLM
from tests.test_torch_fused_serving import (BOOSTS, CAP_TAKE, K, MAX_NBR,
                                            N, _args, arena, batch, graph)

SCORE_TOL = {np.float32: 1e-6, ml_dtypes.bfloat16: 1e-5}


def _rows(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _torch_bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)


# ------------------------------------------------------------ quantize_rows
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 768])
def test_quantize_rows_bit_equal_to_jax(d, dtype):
    """200,000 seeded rows (zero rows among them) give JAX's codes and
    scales bit for bit: XLA's CPU program multiplies by f32(1/127) where the
    source divides by 127, and the port does the same."""
    rng = np.random.default_rng(d)
    for _ in range(10):                          # 10 x 20,000 rows
        x = rng.standard_normal((20_000, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        x[::97] = 0.0
        x[1::89] *= 3.0                          # unnormalized rows too
        if dtype == "bfloat16":
            xb = x.astype(ml_dtypes.bfloat16)
            jq, js = jax_quantize_rows(jnp.asarray(xb))
            tq, ts = quantize_rows(_torch_bf16(xb))
        else:
            jq, js = jax_quantize_rows(jnp.asarray(x))
            tq, ts = quantize_rows(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))


def test_quantize_roundtrip_error():
    x = _rows(256, 64)
    q, s = quantize_rows(torch.from_numpy(x))
    back = q.numpy().astype(np.float32) * s.numpy()[:, None]
    assert np.abs(back - x).max() <= 1.0 / 127 + 1e-6
    q0, s0 = quantize_rows(torch.zeros((4, 64)))
    assert q0.abs().max().item() == 0 and s0.max().item() == 0.0


# ---------------------------------------------------------- K4 plain forms
def test_quantized_topk_matches_exact_ranking():
    """The port of ``test_quant.py``'s ranking test, and the additive form
    bit-equal to JAX's ``quantized_topk`` (600 queries: more than one
    query chunk)."""
    n, d, nq = 3000, 64, 600
    emb, queries = _rows(n, d), _rows(nq, d, seed=1)
    mask = np.ones(n, bool)
    mask[7] = False
    q8, s = quantize_rows(torch.from_numpy(emb))
    scores, rows = K4.int8_topk(q8, s, torch.from_numpy(mask),
                                torch.from_numpy(queries), 5)
    jq8, js = jax_quantize_rows(jnp.asarray(emb))
    jscores, jrows = jax_quantized_topk(jq8, js, jnp.asarray(mask),
                                        jnp.asarray(queries), 5)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(scores.numpy().view(np.int32),
                                  np.asarray(jscores).view(np.int32))
    rows = rows.numpy()
    exact = queries @ emb.T
    exact[:, 7] = -np.inf
    exact_top1 = exact.argmax(axis=1)
    assert (rows[:, 0] == exact_top1).mean() >= 0.97
    mism = np.nonzero(rows[:, 0] != exact_top1)[0]
    gap = exact[mism, exact_top1[mism]] - exact[mism, rows[mism, 0]]
    assert gap.max(initial=0.0) < 2.5e-2
    np.testing.assert_allclose(scores.numpy()[:, 0],
                               exact[np.arange(nq), rows[:, 0]], atol=2e-2)
    assert not (rows == 7).any()


def test_quantized_topk_wide_long_lists_bit_equal_to_jax():
    """The additive plain form at d = 1,536 (past 1,040, where the plain dot
    sums in f64) with lists of 300 (past the first form's 256) is JAX's
    ``quantized_topk`` bit for bit, masked rows at NEG_INF in row order."""
    n, d, nq, k = 1500, 1536, 6, 300
    emb, queries = _rows(n, d, seed=3), _rows(nq, d, seed=4)
    queries[:2] = emb[[10, 900]]                  # self-hits
    mask = np.random.default_rng(5).random(n) > 0.85   # fewer live rows than k
    q8, s = quantize_rows(torch.from_numpy(emb))
    scores, rows = K4.int8_topk(q8, s, torch.from_numpy(mask),
                                torch.from_numpy(queries), k)
    jq8, js = jax_quantize_rows(jnp.asarray(emb))
    jscores, jrows = jax_quantized_topk(jq8, js, jnp.asarray(mask),
                                        jnp.asarray(queries), k)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(scores.numpy().view(np.int32),
                                  np.asarray(jscores).view(np.int32))
    assert mask.sum() < k and (scores.numpy()[:, -1] == -1e30).all()


def test_plain_int8_dot_is_exact_past_2_24():
    """Rows of +-127 and +-64 at d = 2,048 whose dots pass 2^24: the plain
    scores are the exact int32 dot rounded to f32 once, then the two scale
    products, as XLA's convert of the int32 ``dot_general`` (JAX's
    ``quantized_topk``, bit-equal here); an f32 sum of the products rounds
    some of these dots otherwise."""
    from lazzaro_tpu_torch.ops.chunking import nt_dot

    rng = np.random.default_rng(11)
    d, n = 2048, 64
    base = rng.choice([-1.0, 1.0], size=d).astype(np.float32)
    x = np.repeat(base[None], n, axis=0)
    flips = rng.random((n, d)) < 0.02
    x[flips] *= -1.0
    x[:, ::7] *= 0.5
    q8, sc = quantize_rows(torch.from_numpy(x))
    exact = q8.numpy().astype(np.int64) @ q8.numpy().astype(np.int64).T
    assert (np.abs(exact) > 2 ** 24).all()
    f32 = nt_dot(q8[:8].float(), q8.float()).numpy()
    assert (f32 != exact[:8].astype(np.float32)).any()
    mask = torch.ones(n, dtype=torch.bool)
    scores, rows = K4.int8_topk(q8, sc, mask, torch.from_numpy(x[:8]), n)
    want = (exact[:8].astype(np.float32) * sc.numpy()[:8, None]) \
        * sc.numpy()[None, :]
    got_at = np.take_along_axis(want, rows.numpy().astype(np.int64), axis=1)
    np.testing.assert_array_equal(scores.numpy().view(np.int32),
                                  got_at.view(np.int32))
    jscores, jrows = jax_quantized_topk(jnp.asarray(q8.numpy()),
                                        jnp.asarray(sc.numpy()),
                                        jnp.asarray(mask.numpy()),
                                        jnp.asarray(x[:8]), n)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(scores.numpy().view(np.int32),
                                  np.asarray(jscores).view(np.int32))


@jax.jit
def _jax_coarse(q8a, scale_a, alive, tenant_id, is_super, qn, tenant):
    """The coarse stage of ``_quant_two_tier`` (``state.py:2719-2738``),
    its XLA operations as JAX writes them, for g = 1 + 8 and k = K + 8, from
    the normalized queries ``qn``."""
    qq, qs = jax_quantize_rows(qn)
    dots = jax.lax.dot_general(qq, q8a, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
    coarse = dots.astype(jnp.float32) * qs[:, None] * scale_a[None, :]
    alive_t = alive[None, :] & (tenant_id[None, :] == tenant[:, None])
    sup = is_super[None, :]
    cg = jax.lax.top_k(jnp.where(alive_t & sup, coarse, JS.NEG_INF), 9)
    ca = jax.lax.top_k(jnp.where(alive_t & ~sup, coarse, JS.NEG_INF), K + 8)
    return cg + ca


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_keyed_coarse_scan_bit_equal_to_jax(dtype):
    """K4's keyed plain form gives the coarse lists of ``_quant_two_tier``
    bit for bit: both tiers, a tenant with no super row (its gate list
    all NEG_INF in row order), a tenant with fewer live rows than the
    list, dead rows and pad queries. Both take the same normalized queries
    (JAX's ``normalize``, whose reduction XLA orders otherwise than torch:
    the two normalized vectors differ in the last bit of some elements)."""
    cols = arena(5)
    emb = cols["emb"].astype(dtype)
    q8, sc = quantize_rows(_torch_bf16(emb) if dtype != np.float32
                           else torch.from_numpy(emb))
    q, _, tenant, *_ = batch(cols, 5)
    qn = np.array(JS.normalize(jnp.asarray(q)))
    j = _jax_coarse(jnp.asarray(q8.numpy()), jnp.asarray(sc.numpy()),
                    jnp.asarray(cols["alive"]), jnp.asarray(cols["tenant_id"]),
                    jnp.asarray(cols["is_super"]), jnp.asarray(qn),
                    jnp.asarray(tenant))
    t = K4.int8_topk_keyed(q8, sc, torch.from_numpy(cols["alive"]),
                           torch.from_numpy(cols["tenant_id"]),
                           torch.from_numpy(cols["is_super"]),
                           torch.from_numpy(qn), torch.from_numpy(tenant),
                           K + 8, 9)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))
    assert (t[0][2] == -1e30).all() and t[1][2].tolist() == list(range(9))


def test_int8_topk_takes_only_cpu_and_cuda_tensors():
    """No silent fallback: a shadow on another device raises; a CPU shadow
    runs the plain version and counts no launch."""
    codes = torch.zeros((16, 8), dtype=torch.int8, device="meta")
    scale = torch.zeros((16,), device="meta")
    mask = torch.ones(16, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K4.int8_topk(codes, scale, mask, torch.zeros((1, 8), device="meta"), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        K4.int8_topk_keyed(codes, scale, mask, torch.zeros(16, dtype=torch.int32,
                                                           device="meta"),
                           mask, torch.zeros((1, 8), device="meta"),
                           torch.zeros(1, dtype=torch.int32, device="meta"), 2, 1)
    before = K4.launches
    q8, sc = quantize_rows(torch.from_numpy(_rows(16, 8)))
    K4.int8_topk(q8, sc, torch.ones(16, dtype=torch.bool),
                 torch.from_numpy(_rows(2, 8, seed=1)), 3)
    assert K4.launches == before


# ------------------------------------------------ the quantized programs
def _both(seed, dtype):
    cols = arena(seed)
    cols["emb"] = cols["emb"].astype(dtype)
    keys, id_to_row = graph(cols, seed)
    indptr, nbr = jax_build_host_csr(keys, id_to_row, N)
    jstate = JS.ArenaState(**{k: jnp.asarray(v) for k, v in cols.items()})
    tstate = TS.arena_from_numpy(cols, "cpu")
    jsh = jax_quantize_rows(jstate.emb)
    tsh = quantize_rows(tstate.emb)
    return cols, jstate, tstate, (indptr, nbr), jsh, tsh


def _near_ties(jp, k, tol):
    """Pairs of adjacent live scores in JAX's lists that sit within ``tol``
    of each other: the places where the two packages' rescores, summed in
    another order, could rank two rows the other way round."""
    _, _, ann_s, _, _, _ = jax_unpack(np.asarray(jp), k)
    live = ann_s > -1e29
    gaps = np.abs(np.diff(ann_s, axis=1)) <= tol
    return int((gaps & live[:, 1:]).sum())


def _swapped_near_ties(t_s, t_r, j_s, j_r, tol) -> int:
    """Rows equal to JAX's except inside runs of JAX scores within ``tol``
    of each other, where the two rescores may order two rows the other way;
    returns the number of queries with such a swap."""
    swapped = 0
    for q in range(j_r.shape[0]):
        if np.array_equal(t_r[q], j_r[q]):
            continue
        assert sorted(t_r[q]) == sorted(j_r[q]), q
        for p in np.nonzero(t_r[q] != j_r[q])[0]:
            near = [abs(j_s[q, p] - j_s[q, o]) <= tol for o in (p - 1, p + 1)
                    if 0 <= o < j_s.shape[1]]
            assert any(near), (q, p)
        swapped += 1
    return swapped


# Queries whose rows come back in another order inside a near tie, per
# program and arena dtype, on this file's fixture.
NEAR_TIE_SWAPS = {(t, d): 0 for t in ("ragged", "ragged_read", "static",
                                      "static_read")
                  for d in ("float32", "bfloat16")}


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("twin", ["ragged", "ragged_read", "static",
                                  "static_read"])
def test_quant_programs_match_jax(twin, dtype):
    """``search_fused_quant[_ragged][_read]`` against the JAX programs on
    one arena, CSR and batch: rows, gate verdicts and counters equal,
    scores within the stated tolerance, the boosted columns as the exact
    programs' test holds them (1e-6, access counts equal)."""
    tol = SCORE_TOL[dtype]
    cols, jstate, tstate, (indptr, nbr), jsh, tsh = _both(6, dtype)
    q, valid, tenant, gate_on, boost_on, k_q, cap_q = batch(cols, 6)
    ja = jsh + (jnp.asarray(indptr), jnp.asarray(nbr)) + _args(
        q, valid, tenant, gate_on, True)
    ta = tsh + (torch.from_numpy(indptr), torch.from_numpy(nbr)) + _args(
        q, valid, tenant, gate_on, False)
    scal = tuple(BOOSTS[n] for n in ("now", "super_gate", "acc_boost",
                                     "nbr_boost"))
    st = dict(cap_take=CAP_TAKE, max_nbr=MAX_NBR, slack=8)
    read = twin.endswith("read")
    k = K if twin.startswith("ragged") else 16
    if twin == "ragged":
        jstate2, jp = JS.search_fused_quant_ragged_copy(
            jstate, *ja, jnp.asarray(boost_on), jnp.asarray(k_q),
            jnp.asarray(cap_q), *(jnp.float32(v) for v in scal), k=k, **st)
        _, tp = TS.search_fused_quant_ragged(
            tstate, *ta, torch.from_numpy(boost_on), torch.from_numpy(k_q),
            torch.from_numpy(cap_q), *scal, k=k, **st)
    elif twin == "static":
        jstate2, jp = JS.search_fused_quant_copy(
            jstate, *ja, jnp.asarray(boost_on),
            *(jnp.float32(v) for v in scal), k=k, **st)
        _, tp = TS.search_fused_quant(tstate, *ta, torch.from_numpy(boost_on),
                                      *scal, k=k, **st)
    elif twin == "ragged_read":
        jp = JS.search_fused_quant_ragged_read(
            jstate, *ja, jnp.asarray(k_q), jnp.float32(BOOSTS["super_gate"]),
            k=k, **st)
        tp = TS.search_fused_quant_ragged_read(
            tstate, *ta, torch.from_numpy(k_q), BOOSTS["super_gate"], k=k,
            **st)
    else:
        jp = JS.search_fused_quant_read(
            jstate, *ja, jnp.float32(BOOSTS["super_gate"]), k=k, **st)
        tp = TS.search_fused_quant_read(tstate, *ta, BOOSTS["super_gate"],
                                        k=k, **st)
    j = jax_unpack(np.asarray(jp), k)
    t = unpack_retrieval(tp.numpy(), k)
    swapped = _swapped_near_ties(t[2], t[3], j[2], j[3], tol)
    assert swapped <= _near_ties(jp, k, tol)
    assert swapped == NEAR_TIE_SWAPS[(twin, np.dtype(dtype).name)]
    for i in (1, 4, 5):                          # gate rows, verdicts, counters
        np.testing.assert_array_equal(t[i], j[i])
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=tol)
    np.testing.assert_allclose(t[2], j[2], rtol=0, atol=tol)
    assert t[4][[0, 1, 4]].all() and not t[4][2:4].any()   # hits and misses
    if not read:
        for name in ("salience", "last_accessed"):
            np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                       np.asarray(getattr(jstate2, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(tstate.access_count.numpy(),
                                      np.asarray(jstate2.access_count))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quant_fused_read_matches_jax_at_d1536(dtype):
    """``search_fused_quant_read`` of both packages at d = 1,536 (past the
    width where the coarse scan's plain dot sums in f32), on one seeded
    fixture: rows, gate rows, verdicts and counters equal, scores within the
    tolerance ``test_quant_programs_match_jax`` states."""
    d, k = 1536, 16
    tol = SCORE_TOL[dtype]
    cols = arena(8)
    _, valid, tenant, gate_on, _, _, _ = batch(cols, 8)
    rng = np.random.default_rng(18)
    emb = rng.standard_normal((N, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    cols["emb"] = emb.astype(dtype)
    q = rng.standard_normal((len(tenant), d)).astype(np.float32)
    sup = {t: np.nonzero(cols["is_super"] & (cols["tenant_id"] == t))[0]
           for t in (0, 1)}
    q[0] = emb[sup[0][0]] + 0.01 * q[0]               # gate hits
    q[1] = emb[sup[1][1]] + 0.01 * q[1]
    q[4] = emb[sup[0][2]] + 0.01 * q[4]
    keys, id_to_row = graph(cols, 8)
    indptr, nbr = jax_build_host_csr(keys, id_to_row, N)
    jstate = JS.ArenaState(**{c: jnp.asarray(v) for c, v in cols.items()})
    tstate = TS.arena_from_numpy(cols, "cpu")
    jsh, tsh = jax_quantize_rows(jstate.emb), quantize_rows(tstate.emb)
    st = dict(cap_take=CAP_TAKE, max_nbr=MAX_NBR, slack=8)
    jp = JS.search_fused_quant_read(
        jstate, *jsh, jnp.asarray(indptr), jnp.asarray(nbr),
        *_args(q, valid, tenant, gate_on, True),
        jnp.float32(BOOSTS["super_gate"]), k=k, **st)
    tp = TS.search_fused_quant_read(
        tstate, *tsh, torch.from_numpy(indptr), torch.from_numpy(nbr),
        *_args(q, valid, tenant, gate_on, False), BOOSTS["super_gate"], k=k,
        **st)
    j = jax_unpack(np.asarray(jp), k)
    t = unpack_retrieval(tp.numpy(), k)
    for i in (1, 3, 4, 5):                    # gate rows, rows, verdicts, counters
        np.testing.assert_array_equal(t[i], j[i])
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=tol)
    np.testing.assert_allclose(t[2], j[2], rtol=0, atol=tol)
    assert t[4][[0, 1, 4]].all() and not t[4][2:4].any()   # hits and misses


def test_rescored_scores_are_the_exact_scans():
    """Every score the quantized program returns is an exact rescore: the
    exact two-tier program's score for the same row, within 1e-6."""
    cols, _, tstate, (indptr, nbr), _, tsh = _both(7, np.float32)
    q, valid, tenant, gate_on, _, k_q, _ = batch(cols, 7)
    ta = (torch.from_numpy(indptr), torch.from_numpy(nbr)) + _args(
        q, valid, tenant, gate_on, False)
    st = dict(cap_take=CAP_TAKE, max_nbr=MAX_NBR)
    tq = TS.search_fused_quant_ragged_read(tstate, *tsh, *ta,
                                           torch.from_numpy(k_q), 0.9, k=K,
                                           slack=8, **st)
    te = TS.search_fused_ragged_read(tstate, *ta, torch.from_numpy(k_q), 0.9,
                                     k=K, **st)
    gq, grq, sq, rq, _, _ = unpack_retrieval(tq.numpy(), K)
    ge, gre, se, re_, _, _ = unpack_retrieval(te.numpy(), K)
    exact = {(i, int(r)): s for i in range(len(q))
             for s, r in zip(se[i], re_[i]) if s > -1e29}
    hits = [(exact[(i, int(r))], s) for i in range(len(q))
            for s, r in zip(sq[i], rq[i]) if (i, int(r)) in exact]
    assert len(hits) > 100
    for e, s in hits:
        assert abs(e - s) <= 1e-6
    np.testing.assert_allclose(gq, ge, atol=1e-6)


# ------------------------------------------ port of tests/test_quant.py
def test_index_shadow_refreshes_on_mutation():
    d = 16
    idx = MemoryIndex(dim=d, capacity=64, int8_serving=True, device="cpu")
    e = np.eye(d, dtype=np.float32)
    idx.add(["a", "b"], e[:2], [0.5] * 2, [0.0] * 2, ["semantic"] * 2,
            ["default"] * 2, "u1")
    (ids, _), = idx.search_batch(e[0][None, :], "u1", k=1)
    assert ids == ["a"]
    idx.add(["c"], e[1][None, :], [0.9], [0.0], ["semantic"], ["default"], "u1")
    (ids2, _), = idx.search_batch(e[1][None, :], "u1", k=2)
    assert set(ids2) >= {"b"}, ids2
    assert not idx._int8_dirty
    idx.update_access(["a"])                    # metadata: shadow stays
    assert not idx._int8_dirty


def _drive(tmp, flag, sub):
    cfg = MemoryConfig(journal=False, int8_serving=flag)
    ms = MemorySystem(enable_async=False, db_dir=f"{tmp}/{sub}", verbose=False,
                      load_from_disk=False, config=cfg, device="cpu")
    for _ in range(2):
        ms.start_conversation()
        ms.chat("I work as a data engineer on a big ETL project.")
        ms.end_conversation()
    nodes = ms.buffer.size()
    hits = [n.content for n in ms.search_memories("data engineer job")]
    ms.close()
    return nodes, hits


def test_system_behavior_parity_with_int8_serving(tmp_path):
    exact_nodes, exact_hits = _drive(tmp_path, False, "db_exact")
    int8_nodes, int8_hits = _drive(tmp_path, True, "db_int8")
    assert int8_nodes == exact_nodes
    assert int8_hits == exact_hits
    assert any("data engineer" in h for h in int8_hits)


def test_fused_ingest_maintains_shadow_incrementally():
    d, n0, n1 = 16, 40, 24
    rng = np.random.default_rng(3)
    idx = MemoryIndex(dim=d, capacity=255, int8_serving=True, device="cpu")
    idx.ingest_batch([f"a{i}" for i in range(n0)],
                     rng.standard_normal((n0, d)).astype(np.float32),
                     [0.5] * n0, [0.0] * n0, ["semantic"] * n0,
                     ["default"] * n0, "u")
    assert idx._int8_dirty                     # no shadow to maintain yet
    idx.search_batch(rng.standard_normal((1, d)).astype(np.float32), "u", k=3)
    assert not idx._int8_dirty                 # the lazy build
    shadow_obj = idx._int8_shadow[0]
    idx.ingest_batch([f"b{i}" for i in range(n1)],
                     rng.standard_normal((n1, d)).astype(np.float32),
                     [0.5] * n1, [0.0] * n1, ["semantic"] * n1,
                     ["default"] * n1, "u")
    assert not idx._int8_dirty                 # maintained in the program
    assert idx._int8_shadow[0] is shadow_obj   # in place, no requantize
    q8, sc = idx._int8_shadow
    q8_full, sc_full = quantize_rows(idx.state.emb)
    assert torch.equal(q8, q8_full) and torch.equal(sc, sc_full)
    pending = idx.ingest_batch_dedup(
        rng.standard_normal((8, d)).astype(np.float32), [0.5] * 8,
        [0.0] * 8, ["semantic"] * 8, ["default"] * 8, "u", dedup_gate=0.95)
    idx.commit_ingest_dedup(pending, [f"c{i}" for i in range(8)])
    assert not idx._int8_dirty
    q8, sc = idx._int8_shadow
    q8_full, sc_full = quantize_rows(idx.state.emb)
    assert torch.equal(q8, q8_full) and torch.equal(sc, sc_full)


def test_int8_serving_survives_snapshot_restore(tmp_path):
    cfg = MemoryConfig(journal=False, int8_serving=True)
    ms = MemorySystem(enable_async=False, db_dir=str(tmp_path / "db"),
                      verbose=False, load_from_disk=False, config=cfg,
                      device="cpu")
    ms.start_conversation()
    ms.chat("I work as a data engineer on a big ETL project.")
    ms.end_conversation()
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    ms.load_snapshot(snap)                 # the index object is replaced
    assert ms.index.int8_serving
    hits = [n.content for n in ms.search_memories("data engineer")]
    assert any("data engineer" in h for h in hits)
    assert ms.index._int8_shadow is not None
    ms.close()


# ------------------------- port of tests/test_fused_quant_serving.py
def _system(tmp, serve_fused=True, int8=True, per=20, super_threshold=100):
    ms = MemorySystem(
        enable_async=False, db_dir=tmp, verbose=False, load_from_disk=False,
        llm_provider=QueueLLM(per), embedding_provider=ClusteredEmb(),
        auto_prune=False, max_buffer_size=10_000,
        super_node_threshold=super_threshold, device="cpu",
        config=MemoryConfig(journal=False, auto_consolidate=False,
                            decay_rate=0.0, int8_serving=int8))
    ms.config.serve_fused = serve_fused
    return ms


def _ingest(ms, convs=2):
    for c in range(convs):
        ms.start_conversation()
        ms.add_to_short_term(f"conv {c}", "episodic", 0.7)
        ms.end_conversation()
    return ms


_COUNTED = ("search_fused_quant", "search_fused_quant_read",
            "search_fused", "search_fused_read", "search_fused_quant_ragged",
            "search_fused_quant_ragged_read", "search_fused_ragged",
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
    calls["int8_topk"] = 0
    orig_qt = K4.int8_topk

    def wrapped_qt(*a, **kw):
        calls["int8_topk"] += 1
        return orig_qt(*a, **kw)

    monkeypatch.setattr("lazzaro_tpu_torch.core.index.int8_topk", wrapped_qt)
    return calls


def test_one_quant_dispatch_per_chat_turn(monkeypatch):
    with tempfile.TemporaryDirectory() as tmp:
        ms = _ingest(_system(tmp))
        ms.start_conversation()
        ms.chat("fact 3 body")                 # builds the int8 shadow
        calls = _count_dispatches(monkeypatch)
        copies = []
        orig = ms.index._readback
        monkeypatch.setattr(ms.index, "_readback",
                            lambda p: copies.append(1) or orig(p))
        ms.chat("fact 7 body")
        assert calls["search_fused_quant_ragged"] == 1
        for name in calls:
            if name != "search_fused_quant_ragged":
                assert calls[name] == 0, (name, calls)
        assert len(copies) == 1                 # one packed copy a turn
        ms.close()


def test_quant_search_memories_takes_readonly_twin(monkeypatch):
    with tempfile.TemporaryDirectory() as tmp:
        ms = _ingest(_system(tmp))
        ms.search_memories("fact 1 body")
        calls = _count_dispatches(monkeypatch)
        assert ms.search_memories("fact 3 body")
        assert calls["search_fused_quant_ragged_read"] == 1
        assert calls["search_fused_quant_ragged"] == 0
        assert calls["int8_topk"] == 0
        ms.search_memories_batch([f"fact {i} body" for i in range(8)])
        assert calls["search_fused_quant_ragged_read"] == 2
        ms.close()


def test_quant_cached_hit_turn_pays_zero_dispatches(monkeypatch):
    with tempfile.TemporaryDirectory() as tmp:
        ms = _ingest(_system(tmp))
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


def _recall(result_rows, truth_rows, k):
    hits = sum(len(set(r) & set(t[:k])) for r, t in zip(result_rows,
                                                         truth_rows))
    return hits / (k * len(result_rows))


def test_quant_fused_recall_not_worse_than_shadow_path_10k():
    """recall@10 against the exact ranking on a 10k-row fixture: the fused
    coarse scan + exact rescore at least as good as the classic int8 scan,
    and both at JAX's numbers (same rows from both packages)."""
    from lazzaro_tpu.core.index import MemoryIndex as JaxIndex
    from lazzaro_tpu.serve import RetrievalRequest as JaxRequest

    n, d, k, nq = 10_000, 48, 10, 64
    rng = np.random.default_rng(42)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    base = rng.integers(0, n, size=nq)
    queries = emb[base] + 0.35 * rng.standard_normal((nq, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    truth = np.argsort(-(queries @ emb.T), axis=1)[:, :k]
    out = {}
    for name, cls, req in (("port", MemoryIndex, RetrievalRequest),
                           ("jax", JaxIndex, JaxRequest)):
        kw = {"device": "cpu"} if name == "port" else {}
        idx = cls(dim=d, capacity=n + 64, int8_serving=True, epoch=0.0, **kw)
        idx.add([f"m{i}" for i in range(n)], emb, [0.5] * n, [0.0] * n,
                ["semantic"] * n, ["default"] * n, "u0")
        shadow = idx.search_batch(queries, "u0", k=k)
        fused = idx.search_fused_requests(
            [req(query=queries[i], tenant="u0", k=k) for i in range(nq)],
            cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
            nbr_boost=0.02, now=1.0)
        out[name] = ([[idx.id_to_row[i] for i in ids] for ids, _ in shadow],
                     [[idx.id_to_row[i] for i in r.ids] for r in fused])
    assert out["port"][0] == out["jax"][0]       # the classic int8 scan
    assert out["port"][1] == out["jax"][1]       # the fused program
    r_shadow = _recall(out["port"][0], truth, k)
    r_fused = _recall(out["port"][1], truth, k)
    assert r_fused >= r_shadow, (r_fused, r_shadow)
    assert r_fused >= 0.95, r_fused


def _cols(ms):
    c = ms.index.pull_numeric()
    nn = len(ms.index.id_to_row)
    return {k: c[k][: nn + 2] for k in ("salience", "access_count")}


def test_quant_matches_classic_int8_chat_turns():
    a = _ingest(_system(tempfile.mkdtemp(), serve_fused=True))
    b = _ingest(_system(tempfile.mkdtemp(), serve_fused=False))
    try:
        a.start_conversation()
        b.start_conversation()
        for q in ("fact 3 body", "fact 17 body", "fact 31 body",
                  "fact 3 body"):
            assert a.chat(q) == b.chat(q)
        a.end_conversation()
        b.end_conversation()
        ca, cb = _cols(a), _cols(b)
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


def test_quant_matches_classic_int8_super_gate_hit():
    def build(serve_fused):
        ms = _ingest(_system(tempfile.mkdtemp(), serve_fused=serve_fused,
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
        ca, cb = _cols(a), _cols(b)
        np.testing.assert_allclose(ca["salience"], cb["salience"], atol=1e-6)
        np.testing.assert_array_equal(ca["access_count"], cb["access_count"])
    finally:
        a.close()
        b.close()


def test_quant_multi_tenant_batch_isolation():
    with tempfile.TemporaryDirectory() as tmp:
        ms = _ingest(_system(tmp))
        emb = ClusteredEmb()
        ms.index.add(["t2:alien_1"],
                     np.asarray([emb.embed("fact 3 body")], np.float32),
                     [0.9], [0.0], ["semantic"], ["default"], "t2")
        v = np.asarray(emb.embed("fact 3 body"), np.float32)
        res = ms.index.search_fused_requests(
            [RetrievalRequest(query=v, tenant=ms.user_id, k=5),
             RetrievalRequest(query=v, tenant="t2", k=5)],
            cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
            nbr_boost=0.02)
        assert res[0].ids and all(i.startswith(f"{ms.user_id}:")
                                  for i in res[0].ids)
        assert res[1].ids == ["t2:alien_1"]
        ms.close()


def test_quant_k_shortfall_guard():
    n, d, k = 64, 16, 10
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    idx = MemoryIndex(dim=d, capacity=255, int8_serving=True, coarse_slack=4,
                      device="cpu")
    assert idx.coarse_slack == 4
    idx.add([f"m{i}" for i in range(n)], emb, [0.5] * n, [0.0] * n,
            ["semantic"] * n, ["default"] * n, "u0")
    res = idx.search_fused_requests(
        [RetrievalRequest(query=rng.standard_normal(d).astype(np.float32),
                          tenant="u0", k=k)],
        cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
        nbr_boost=0.02)
    assert len(res[0].ids) == k


def test_fused_quant_rows_fixture(monkeypatch):
    """The 1M-row fixture of the JAX suite cut to 65,536 bf16 rows of d =
    64 (the port's CPU lane): one dispatch a batch and exact self-hits
    agreeing with the classic int8 scan."""
    n, d, k = 65_536, 64, 10
    rng = np.random.default_rng(5)
    idx = MemoryIndex(dim=d, capacity=n + 64, dtype="bfloat16",
                      int8_serving=True, device="cpu")
    chunk = 16_384
    for c in range(0, n, chunk):
        emb = rng.standard_normal((chunk, d)).astype(np.float32)
        idx.add([f"f{c + i}" for i in range(chunk)], emb, [0.5] * chunk,
                [0.0] * chunk, ["semantic"] * chunk, ["default"] * chunk,
                "u0")
    probe_rows = rng.integers(0, n, size=16)
    queries = idx.state.emb[torch.from_numpy(probe_rows)].float().numpy()
    reqs = [RetrievalRequest(query=queries[i], tenant="u0", k=k)
            for i in range(len(probe_rows))]
    kw = dict(cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
              nbr_boost=0.02)
    idx.search_fused_requests(reqs, **kw)
    calls = _count_dispatches(monkeypatch)
    res = idx.search_fused_requests(reqs, **kw)
    assert calls["search_fused_quant_ragged_read"] == 1
    assert sum(calls.values()) == 1
    shadow = idx.search_batch(queries, "u0", k=1)
    for i, r in enumerate(probe_rows):
        assert res[i].ids[0] == f"f{r}"
        assert shadow[i][0][0] == res[i].ids[0]


def test_int8_serving_under_a_mesh_raises_naming_item_21():
    """The sharded int8 scan and the fused program's sharded quant mode are
    ROADMAP Queue 1 item 21: a meshed index or system with int8 serving
    raises, naming it."""
    from lazzaro_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="item 21"):
        MemoryIndex(dim=16, capacity=256, mesh=mesh, int8_serving=True)
    with tempfile.TemporaryDirectory() as tmp:
        with pytest.raises(NotImplementedError, match="item 21"):
            MemorySystem(enable_async=False, db_dir=tmp, verbose=False,
                         load_from_disk=False, mesh=mesh,
                         config=MemoryConfig(
                             int8_serving=True, ingest_fused=False,
                             ingest_dedup_fused=False,
                             auto_consolidate=False))
