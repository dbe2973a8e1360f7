"""Parity of the port's masked top-k (``lazzaro_tpu_torch.ops.masked_topk``)
with its two JAX oracles: the Pallas kernel in interpret mode
(``pallas_masked_topk``, its ragged form ``pallas_masked_topk_ragged`` and
the ``masked_topk_auto`` dispatch) and ``state.arena_search(impl="xla")``.

The same numpy inputs, made from a fixed seed, go through both packages.
Tolerances: f32 arenas must give equal rows and scores within 1e-5 (f32 sums
of the same products in another order). bf16 arenas give scores within 1e-2
and equal rows wherever the score gap to a neighbouring entry exceeds 1e-2:
the inputs round to bf16 and the f32 sums run in another order, so entries
closer than that may swap. Exact ties (duplicate rows, masked rows) must
come back in ascending row order in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lazzaro_tpu.core import state as JS
from lazzaro_tpu.ops.pallas_topk import (masked_topk_auto,
                                         pallas_masked_topk,
                                         pallas_masked_topk_ragged)
from lazzaro_tpu_torch.core import state as TS
from lazzaro_tpu_torch.ops import masked_topk as mt
from lazzaro_tpu_torch.ops import topk as tk

DIM = 64
N = 2 * JS.TOPK_BLOCK          # block-aligned, as the Pallas kernel needs
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def unit_rows(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def as_jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def as_torch(x, dtype):
    return torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype))


def assert_topk_match(ref_s, ref_r, s, r, dtype):
    """Scores within the dtype's tolerance; rows equal except inside a
    cluster of reference scores closer than that tolerance (f32: never)."""
    tol = TOL[dtype]
    ref_s, ref_r = np.asarray(ref_s, np.float32), np.asarray(ref_r, np.int64)
    s, r = np.asarray(s, np.float32), np.asarray(r, np.int64)
    np.testing.assert_allclose(s, ref_s, rtol=0, atol=tol)
    if dtype == "float32":
        np.testing.assert_array_equal(r, ref_r)
        return
    for qi, i in zip(*np.nonzero(r != ref_r)):
        gaps = np.abs(ref_s[qi] - ref_s[qi, i])
        gaps[i] = np.inf
        near_edge = i == ref_s.shape[1] - 1
        assert near_edge or gaps.min() <= tol, (
            f"query {qi} position {i}: row {r[qi, i]} vs {ref_r[qi, i]} "
            f"with a score gap above {tol}")


def make_arena(rng, emb, dtype, alive=None, tenant=None, is_super=None):
    n = emb.shape[0]
    cols = {
        "emb": emb, "salience": np.full((n,), 0.5, np.float32),
        "timestamp": np.zeros((n,), np.float32),
        "last_accessed": np.zeros((n,), np.float32),
        "access_count": np.zeros((n,), np.int32),
        "type_id": np.zeros((n,), np.int32), "shard_id": np.zeros((n,), np.int32),
        "tenant_id": (np.zeros((n,), np.int32) if tenant is None else tenant),
        "alive": (np.ones((n,), bool) if alive is None else alive),
        "is_super": (np.zeros((n,), bool) if is_super is None else is_super),
    }
    jax_arena = JS.ArenaState(**{k: (as_jax(v, dtype) if k == "emb"
                                     else jnp.asarray(v))
                                 for k, v in cols.items()})
    torch_arena = TS.ArenaState(**{k: (as_torch(v, dtype) if k == "emb"
                                       else torch.from_numpy(v))
                                   for k, v in cols.items()})
    return jax_arena, torch_arena


@pytest.mark.parametrize("dtype,nq,k", [("float32", 3, 8), ("bfloat16", 64, 16),
                                        ("float32", 1, 1)])
def test_plain_version_matches_pallas_interpret(dtype, nq, k):
    rng = np.random.default_rng(7)
    emb = unit_rows(rng, N)
    q = unit_rows(rng, nq)
    alive = rng.random(N) > 0.2
    madd = np.where(alive, 0.0, -1e30).astype(np.float32)
    ref_s, ref_r = pallas_masked_topk(as_jax(emb, dtype), jnp.asarray(madd),
                                      jnp.asarray(q), k=k, block_rows=4096,
                                      interpret=True)
    s, r = mt.masked_topk(as_torch(emb, dtype), torch.from_numpy(alive),
                          torch.from_numpy(q), k)
    assert r.dtype == torch.int64 and s.dtype == torch.float32
    assert_topk_match(ref_s, ref_r, s, r, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq", [1, 3, 64])
@pytest.mark.parametrize("k", [1, 8, 16])
def test_arena_search_matches_xla(dtype, nq, k):
    rng = np.random.default_rng(100 * nq + k)
    emb = unit_rows(rng, 1024)
    alive = rng.random(1024) > 0.3
    ja, ta = make_arena(rng, emb, dtype, alive=alive)
    q = rng.standard_normal((nq, DIM)).astype(np.float32)
    ref_s, ref_r = JS.arena_search(ja, jnp.asarray(q), jnp.int32(0), k, impl="xla")
    s, r = TS.arena_search(ta, torch.from_numpy(q), 0, k)
    assert_topk_match(ref_s, ref_r, s, r, dtype)


def grid_rows(rng, n):
    """Small multiples of 1/64: products and sums are exact in f32, so equal
    rows score exactly equal whatever the summation order."""
    return (rng.integers(-8, 9, size=(n, DIM)) / 64).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_ties_go_to_the_lowest_row(dtype):
    rng = np.random.default_rng(3)
    base = grid_rows(rng, 40)
    emb = np.concatenate([base] * 5)                  # every row 5 times
    ja, ta = make_arena(rng, emb, dtype)
    q = np.eye(DIM, dtype=np.float32)[:4]             # score = one column
    ref_s, ref_r = JS.arena_search(ja, jnp.asarray(q), jnp.int32(0), 16, impl="xla")
    s, r = TS.arena_search(ta, torch.from_numpy(q), 0, 16)
    np.testing.assert_array_equal(np.asarray(r), np.asarray(ref_r))
    np.testing.assert_array_equal(np.asarray(s), np.asarray(ref_s))
    # and against the Pallas oracle on a block-aligned copy
    big = np.concatenate([emb, np.zeros((512 - emb.shape[0], DIM), np.float32)])
    madd = np.where(np.arange(512) < emb.shape[0], 0.0, -1e30).astype(np.float32)
    ps, pr = pallas_masked_topk(as_jax(big, dtype), jnp.asarray(madd),
                                jnp.asarray(q), k=16, block_rows=256,
                                interpret=True)
    s2, r2 = mt.masked_topk(as_torch(big, dtype), torch.from_numpy(madd),
                            torch.from_numpy(q), 16)
    np.testing.assert_array_equal(np.asarray(r2), np.asarray(pr))
    np.testing.assert_array_equal(np.asarray(s2), np.asarray(ps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fewer_live_rows_than_k(dtype):
    """Dead rows score exactly -1e30 and fill the tail in row order."""
    rng = np.random.default_rng(11)
    emb = unit_rows(rng, 300)
    alive = np.zeros((300,), bool)
    alive[[4, 150, 299]] = True
    ja, ta = make_arena(rng, emb, dtype, alive=alive)
    q = unit_rows(rng, 3)
    ref_s, ref_r = JS.arena_search(ja, jnp.asarray(q), jnp.int32(0), 8, impl="xla")
    s, r = TS.arena_search(ta, torch.from_numpy(q), 0, 8)
    assert_topk_match(ref_s, ref_r, s, r, dtype)
    np.testing.assert_array_equal(np.asarray(r)[:, 3:], np.asarray(ref_r)[:, 3:])
    assert (np.asarray(s)[:, 3:] == np.float32(-1e30)).all()


@pytest.mark.parametrize("super_filter", [1, 0, -1])
def test_tenant_and_super_masks(super_filter):
    rng = np.random.default_rng(5)
    n = 512
    emb = unit_rows(rng, n)
    tenant = rng.integers(0, 3, size=n).astype(np.int32)
    is_super = rng.random(n) < 0.2
    alive = rng.random(n) > 0.1
    ja, ta = make_arena(rng, emb, "float32", alive=alive, tenant=tenant,
                        is_super=is_super)
    q = unit_rows(rng, 5)
    for tid in (0, 2):
        ref_s, ref_r = JS.arena_search(ja, jnp.asarray(q), jnp.int32(tid), 10,
                                       super_filter=super_filter, impl="xla")
        s, r = TS.arena_search(ta, torch.from_numpy(q), tid, 10, super_filter)
        assert_topk_match(ref_s, ref_r, s, r, "float32")
        live = np.asarray(s) > -1e29
        rows = np.asarray(r)[live]
        assert (tenant[rows] == tid).all()
        if super_filter:
            assert (is_super[rows] == (super_filter == 1)).all()


def test_single_query_shape():
    rng = np.random.default_rng(2)
    ja, ta = make_arena(rng, unit_rows(rng, 64), "float32")
    q = unit_rows(rng, 1)[0]
    ref_s, ref_r = JS.arena_search(ja, jnp.asarray(q), jnp.int32(0), 4, impl="xla")
    s, r = TS.arena_search(ta, torch.from_numpy(q), 0, 4)
    assert tuple(s.shape) == (4,) and tuple(r.shape) == (4,)
    assert_topk_match(np.asarray(ref_s)[None], np.asarray(ref_r)[None],
                      s[None], r[None], "float32")


def test_stable_topk_matches_lax_top_k_order():
    """The shared helper keeps lax.top_k's order on exact ties, infinities
    and the masked value."""
    import jax

    rng = np.random.default_rng(9)
    x = rng.integers(-3, 4, size=(6, 50)).astype(np.float32)
    x[:, 5] = -1e30
    x[:, 7] = np.inf
    x[:, 9] = -np.inf
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), 20)
    v, i = tk.stable_topk(torch.from_numpy(x), 20)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref_i))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))


def test_cpu_wrapper_never_counts_a_launch():
    rng = np.random.default_rng(1)
    before = mt.launches
    mt.masked_topk(torch.from_numpy(unit_rows(rng, 32)),
                   torch.ones(32, dtype=torch.bool),
                   torch.from_numpy(unit_rows(rng, 2)), 3)
    assert mt.launches == before


def test_plain_version_chunks_large_query_batches():
    """Batches past QUERY_CHUNK are scored chunk by chunk with the same
    result as one pass."""
    from lazzaro_tpu_torch.ops.chunking import QUERY_CHUNK

    rng = np.random.default_rng(4)
    emb = torch.from_numpy(unit_rows(rng, 256))
    q = torch.from_numpy(unit_rows(rng, QUERY_CHUNK + 37))
    mask = torch.from_numpy(rng.random(256) > 0.5)
    s, r = mt.masked_topk_reference(emb, mask, q, 5)
    scores = q @ emb.T + tk.additive_mask(mask)
    ref_s, ref_r = tk.stable_topk(scores, 5)
    assert s.shape == (QUERY_CHUNK + 37, 5)
    torch.testing.assert_close(s, ref_s, rtol=0, atol=1e-6)
    assert torch.equal(r, ref_r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("query_ndim", [1, 2])
def test_plain_xla_formulation_matches_jax(dtype, query_ndim):
    """``ops.topk.masked_topk`` (one product, masked rows at NEG_INF, a
    full-width top-k) against ``lazzaro_tpu.ops.topk.masked_topk``."""
    from lazzaro_tpu.ops.topk import masked_topk as jax_masked_topk
    from lazzaro_tpu_torch.ops.topk import masked_topk as plain_masked_topk

    rng = np.random.default_rng(21)
    emb = unit_rows(rng, 700)
    mask = rng.random(700) > 0.25
    q = unit_rows(rng, 4)
    if query_ndim == 1:
        q = q[0]
    ref_s, ref_r = jax_masked_topk(as_jax(emb, dtype), jnp.asarray(mask),
                                   jnp.asarray(q), 9)
    s, r = plain_masked_topk(as_torch(emb, dtype), torch.from_numpy(mask),
                             torch.from_numpy(q), 9)
    assert tuple(s.shape) == tuple(ref_s.shape)
    assert_topk_match(np.atleast_2d(ref_s), np.atleast_2d(ref_r),
                      np.atleast_2d(s.numpy()), np.atleast_2d(r.numpy()), dtype)


@pytest.mark.parametrize("dtype,k,kq", [("float32", 8, [2, 8, 1, 5]),
                                        ("bfloat16", 16, [16, 0, 3, 9]),
                                        ("float32", 1, [1, 1, 0, 1])])
def test_ragged_form_matches_pallas_interpret(dtype, k, kq):
    """``masked_topk_ragged`` against ``pallas_masked_topk_ragged`` run in
    interpret mode as ``tests/test_ragged_serving.py`` runs it: the
    ceiling top-k with ``(-1e30, -1)`` at positions at or past each query's
    ``k_q``."""
    rng = np.random.default_rng(11)
    emb = unit_rows(rng, N)
    q = unit_rows(rng, len(kq))
    alive = np.arange(N) % 7 != 0
    madd = np.where(alive, 0.0, -1e30).astype(np.float32)
    k_q = np.asarray(kq, np.int32)
    ref_s, ref_r = pallas_masked_topk_ragged(
        as_jax(emb, dtype), jnp.asarray(madd), as_jax(q, dtype),
        jnp.asarray(k_q), k=k, block_rows=4096, interpret=True)
    s, r = mt.masked_topk_ragged(as_torch(emb, dtype), torch.from_numpy(alive),
                                 torch.from_numpy(q), torch.from_numpy(k_q), k)
    assert r.dtype == torch.int64 and s.dtype == torch.float32
    for qi, kk in enumerate(kq):
        assert (r[qi, kk:] == -1).all() and (s[qi, kk:] == -1e30).all()
        assert (np.asarray(ref_r)[qi, kk:] == -1).all()
    assert_topk_match(ref_s, ref_r, s, r, dtype)


def test_auto_dispatch_matches_pallas_interpret():
    """``masked_topk_auto`` takes an additive mask, as the JAX dispatch
    does, and gives its result."""
    rng = np.random.default_rng(12)
    emb = unit_rows(rng, N)
    q = unit_rows(rng, 5)
    madd = np.where(rng.random(N) > 0.3, 0.0, -1e30).astype(np.float32)
    ref_s, ref_r = masked_topk_auto(jnp.asarray(emb), jnp.asarray(madd),
                                    jnp.asarray(q), k=10)
    s, r = mt.masked_topk_auto(torch.from_numpy(emb), torch.from_numpy(madd),
                               torch.from_numpy(q), k=10)
    assert_topk_match(ref_s, ref_r, s, r, "float32")


def test_route_rule():
    """The wrapper's stage-1 route, as measured on the card: tensor cores
    for every bf16 arena, the streaming scan for an f32 arena up to 16
    queries where a lane's registers hold its share of them and at most
    four query groups re-read each row (d up to 768 at every Q <= 16, up
    to 1,536 through 8 queries, up to 3,072 through 4), the FMA scan for
    every other f32 scan. It reads nothing but the dtype, Q and d, so a
    row-sharded arena's scans take the route one device takes; a CPU
    arena counts no launch on any route."""
    assert (mt.STREAM_MAX_Q, mt.STREAM_QREGS, mt.STREAM_MAX_GROUPS) == (16, 96, 4)
    for nq in (1, 2, 16, 17, 8192):
        for d in (8, 768, 3072, 4096):
            assert mt.route_for(torch.bfloat16, nq, d) == "wgmma"
    stream = {(768, 1), (768, 8), (768, 16), (1536, 1), (1536, 8), (2048, 1),
              (2048, 4), (3072, 1), (3072, 4), (8, 4), (16, 8), (32, 16)}
    fma = {(768, 17), (768, 64), (1536, 16), (1544, 8), (2048, 8), (3072, 8),
           (3072, 16), (3080, 1), (4096, 1), (8, 8), (16, 16)}
    for d, nq in stream | fma:
        assert mt.route_for(torch.float32, nq, d) == \
            ("stream" if (d, nq) in stream else "fma"), (d, nq)
    assert mt.stream_groups(768, 16) == (4, 96)
    assert mt.stream_groups(3072, 1) == (1, 96)
    assert mt.stream_groups(2048, 8) == (8, 64)
    assert set(mt.ROUTES) == {"fma", "wgmma", "stream"}
    rng = np.random.default_rng(3)
    before = (mt.launches, mt.launches_wgmma, mt.launches_stream,
              mt.stage_launches)
    mt.masked_topk(as_torch(unit_rows(rng, 64), "bfloat16"),
                   torch.ones(64, dtype=torch.bool),
                   torch.from_numpy(unit_rows(rng, 32)), 3)
    mt.masked_topk(as_torch(unit_rows(rng, 64), "bfloat16"),
                   torch.ones(64, dtype=torch.bool),
                   torch.from_numpy(unit_rows(rng, 1)), 3)
    assert (mt.launches, mt.launches_wgmma, mt.launches_stream,
            mt.stage_launches) == before


def test_passes_count_two_launches_each():
    """A scan runs one stage 1 and one stage 2 a pass of 128 list entries;
    ``stage_launches`` counts both, whatever the number of shards."""
    assert [mt.passes(k) for k in (1, 10, 128, 129, 256, 300)] == [1, 1, 1, 2, 2, 3]


def test_tensor_core_shape_k1_matches_pallas_interpret():
    """The plain version the tensor-core route is held to, at that route's
    dedup-probe shape (bf16, Q = 96 > 16, k = 1), against the Pallas kernel
    in interpret mode: grid rows (exact sums), every row four times in four
    blocks and half the queries equal to a row, so the best score is an
    exact tie that must go to the lowest live row."""
    rng = np.random.default_rng(31)
    base = grid_rows(rng, N // 4)
    emb = np.concatenate([base] * 4)
    alive = rng.random(N) > 0.2
    madd = np.where(alive, 0.0, -1e30).astype(np.float32)
    q = np.concatenate([base[:48], grid_rows(rng, 48)])
    ref_s, ref_r = pallas_masked_topk(as_jax(emb, "bfloat16"), jnp.asarray(madd),
                                      jnp.asarray(q), k=1, block_rows=4096,
                                      interpret=True)
    s, r = mt.masked_topk(as_torch(emb, "bfloat16"), torch.from_numpy(alive),
                          torch.from_numpy(q), 1)
    np.testing.assert_array_equal(r.numpy(), np.asarray(ref_r))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    live_copies = [[i + j * (N // 4) for j in range(4) if alive[i + j * (N // 4)]]
                   for i in range(48)]
    assert [int(r[i, 0]) for i in range(48) if live_copies[i]] == \
        [c[0] for c in live_copies if c]


def test_tensor_core_shape_k128_matches_xla_formulation():
    """``ops.topk.masked_topk`` at the route's list shape (bf16, Q = 64,
    k = 128) against ``lazzaro_tpu.ops.topk.masked_topk``: grid rows, each
    five times, so the lists are runs of exact ties in row order."""
    from lazzaro_tpu.ops.topk import masked_topk as jax_masked_topk
    from lazzaro_tpu_torch.ops.topk import masked_topk as plain_masked_topk

    rng = np.random.default_rng(32)
    base = grid_rows(rng, 200)
    emb = np.concatenate([base] * 5)
    mask = rng.random(1000) > 0.25
    q = np.concatenate([base[:32], grid_rows(rng, 32)])
    ref_s, ref_r = jax_masked_topk(as_jax(emb, "bfloat16"), jnp.asarray(mask),
                                   jnp.asarray(q), 128)
    s, r = plain_masked_topk(as_torch(emb, "bfloat16"), torch.from_numpy(mask),
                             torch.from_numpy(q), 128)
    np.testing.assert_array_equal(r.numpy(), np.asarray(ref_r))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    assert (s.numpy()[:, 1:] == s.numpy()[:, :-1]).any()
