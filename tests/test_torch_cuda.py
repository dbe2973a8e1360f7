"""The top-k, cross-shard merge and flash-attention kernels (forward and
backward) on the card, against their plain versions, the row-sharded arena
on one card, and the decoder LM's device paths, its train step included.

Marked ``cuda``: these tests need an NVIDIA GPU with ``nvcc`` and skip
elsewhere. Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

Top-k inputs are small multiples of 1/256, so every product and sum is
exact in f32 and the kernel must agree with the plain version bit for bit,
exact ties included. Flash-attention tolerances are stated beside its tests.
"""

import numpy as np
import pytest
import torch

from lazzaro_tpu_torch.ops import fused_topk as ft
from lazzaro_tpu_torch.ops import masked_topk as mt
from lazzaro_tpu_torch.ops import topk as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def grid(gen, shape, dtype, device):
    x = torch.randn(shape, generator=gen, device=device)
    return (torch.round(x * 16) / 256).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,nq,k,d", [
    (4096, 1, 10, 64), (5003, 3, 1, 64), (777, 70, 16, 64), (20000, 5, 128, 64),
    (300, 1100, 3, 64), (20000, 5, 300, 64), (1000, 2, 1000, 64),
    # Q > 16: bf16 takes the tensor-core route (ragged N, d past one panel
    # and not a multiple of 64, lists at and past 128, ties across tiles)
    (777, 17, 1, 32), (5003, 64, 10, 72), (5003, 65, 128, 64),
    (777, 200, 300, 32), (5003, 1100, 1, 768), (20000, 64, 300, 64)])
def test_kernel_matches_plain_version(cuda, dtype, n, nq, k, d):
    gen = torch.Generator(device=cuda).manual_seed(n + nq + k)
    emb = grid(gen, (n, d), dtype, cuda)
    emb[n // 2:n // 2 + 40] = emb[:40]                       # exact ties
    mask = torch.rand(n, generator=gen, device=cuda) < 0.7
    q = grid(gen, (nq, d), dtype, cuda)
    before = mt.launches
    s, r = mt.masked_topk(emb, mask, q, k)
    ps, pr = mt.masked_topk_reference(emb, mask, q, k)
    torch.cuda.synchronize()
    assert mt.launches == before + 1
    assert torch.equal(r, pr)
    assert torch.equal(s, ps)


@pytest.mark.parametrize("k", [128, 300])
def test_tensor_core_lists_keep_tie_order_across_passes(cuda, k):
    """600 distinct rows repeated 13 times and queries drawn from them: every
    list is runs of exact ties, which straddle the tiles, the splits and the
    seams of the 128-entry passes; the kernel must list each run in row
    order, as the plain version does."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    base = grid(gen, (600, 64), torch.bfloat16, cuda)
    emb = base.repeat(13, 1)
    mask = torch.rand(emb.shape[0], generator=gen, device=cuda) < 0.9
    q = base[:64].clone()
    before = mt.launches_wgmma
    s, r = mt.masked_topk(emb, mask, q, k)
    ps, pr = mt.masked_topk_reference(emb, mask, q, k)
    torch.cuda.synchronize()
    assert mt.launches_wgmma == before + 1
    assert torch.equal(r, pr) and torch.equal(s, ps)
    if k > 128:                                 # a run crosses the first seam
        assert (s[:, 127] == s[:, 128]).any()


@pytest.mark.parametrize("nq,k", [(1, 10), (8, 1), (16, 128), (3, 300)])
def test_tensor_core_route_forced_at_small_q(cuda, nq, k):
    """At small Q every route a dtype has gives the plain version's result:
    the tensor-core and the FMA stage 1 on a bf16 arena, the streaming and
    the FMA one on an f32 arena (the FMA route forced, a record of the
    route small-Q scans took before)."""
    gen = torch.Generator(device=cuda).manual_seed(nq + k)
    for dtype, routes in ((torch.bfloat16, ("wgmma", "fma")),
                          (torch.float32, ("stream", "fma"))):
        emb = grid(gen, (5003, 64), dtype, cuda)
        emb[2500:2540] = emb[:40]
        mask = torch.rand(5003, generator=gen, device=cuda) < 0.7
        q = grid(gen, (nq, 64), dtype, cuda)
        want = mt.masked_topk_reference(emb, mask, q, k)
        for route in routes:
            got = mt._launch(emb, tk.additive_mask(mask), q, k, route=route)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (dtype, route)


@pytest.mark.parametrize("dtype,nq,routed", [
    (torch.bfloat16, 1, True), (torch.bfloat16, 16, True),
    (torch.float32, 64, False), (torch.bfloat16, 17, True),
    (torch.bfloat16, 8192, True), (torch.float32, 16, False)])
def test_route_counts_follow_dtype_and_query_count(cuda, dtype, nq, routed):
    """Every bf16 scan counts a tensor-core launch, and an f32 scan of up
    to 16 queries a streaming one, in both modes; every call counts one
    launch."""
    gen = torch.Generator(device=cuda).manual_seed(nq)
    n = 3000
    emb = grid(gen, (n, 32), dtype, cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    q = grid(gen, (nq, 32), dtype, cuda)
    streamed = int(mt.route_for(dtype, nq, 32) == "stream")
    assert streamed == int(not routed and nq <= mt.STREAM_MAX_Q)
    before = (mt.launches, mt.launches_wgmma, mt.launches_stream)
    mt.masked_topk(emb, mask, q, 5)
    assert (mt.launches - before[0], mt.launches_wgmma - before[1],
            mt.launches_stream - before[2]) == (1, int(routed), streamed)
    ten = torch.zeros(n, dtype=torch.int32, device=cuda)
    q_ten = torch.zeros(nq, dtype=torch.int32, device=cuda)
    sup = torch.zeros(n, dtype=torch.bool, device=cuda)
    before = (ft.launches, ft.launches_wgmma, ft.launches_stream)
    ft.fused_topk(emb, mask, ten, sup, q, q_ten, None, 5)
    assert (ft.launches - before[0], ft.launches_wgmma - before[1],
            ft.launches_stream - before[2]) == (1, int(routed), streamed)
    torch.cuda.synchronize()


def test_scores_do_not_depend_on_the_row_offset(cuda):
    """On real (non-grid) bf16 data a row's score on the tensor-core route is
    bitwise the same when the row is scanned in the whole arena and in a
    slice starting at an unaligned row: what the mesh's per-shard scans
    rest on."""
    rng = np.random.default_rng(5)
    n, d, nq, k = 9000, 768, 64, 128
    x = rng.standard_normal((n, d)).astype(np.float32)
    emb = torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(
        cuda, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    rows = torch.from_numpy(rng.choice(np.arange(3001, n), k, replace=False)).to(cuda)
    mask = torch.zeros(n, dtype=torch.bool, device=cuda)
    mask[rows] = True
    for kk in (1, k):                    # the arg-max and the list epilogues
        whole_s, whole_r = mt.masked_topk(emb, mask, q, kk)
        for off in (1, 777, 3001):
            part_s, part_r = mt.masked_topk(emb[off:], mask[off:], q, kk)
            order = torch.argsort(whole_r, dim=1)
            part_order = torch.argsort(part_r, dim=1)
            assert torch.equal(torch.gather(whole_r, 1, order),
                               torch.gather(part_r, 1, part_order) + off)
            assert torch.equal(torch.gather(whole_s, 1, order),
                               torch.gather(part_s, 1, part_order)), (kk, off)


def test_tensor_core_route_is_bitwise_deterministic(cuda):
    rng = np.random.default_rng(6)
    emb = torch.from_numpy(rng.standard_normal((20000, 256)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    mask = torch.from_numpy(rng.random(20000) < 0.8).to(cuda)
    q = torch.from_numpy(rng.standard_normal((300, 256)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    for k in (1, 10, 300):
        first = mt.masked_topk(emb, mask, q, k)
        second = mt.masked_topk(emb, mask, q, k)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_fewer_live_rows_than_k(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    emb = grid(gen, (1000, 32), torch.bfloat16, cuda)
    mask = torch.zeros(1000, dtype=torch.bool, device=cuda)
    mask[[3, 500, 999]] = True
    q = grid(gen, (2, 32), torch.bfloat16, cuda)
    s, r = mt.masked_topk(emb, mask, q, 8)
    ps, pr = mt.masked_topk_reference(emb, mask, q, 8)
    assert torch.equal(r, pr) and torch.equal(s, ps)
    assert r[:, 3:].tolist() == [[0, 1, 2, 4, 5]] * 2


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    emb = torch.zeros((64, 12), device=cuda)
    mask = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        mt.masked_topk(emb, mask, torch.zeros((1, 12), device=cuda), 3)
    emb = torch.zeros((64, 16), device=cuda)
    with pytest.raises(ValueError):
        mt.masked_topk(emb, mask, torch.zeros((1, 16), device=cuda), 65)


def test_a_refused_launch_raises(cuda):
    """The C entry point reports a launch it refuses (here more splits than
    the scratch may have) and counts no launch; the wrapper's check of that
    code is what turns it into an exception."""
    import ctypes

    lib = mt._library()
    emb = torch.zeros((64, 16), device=cuda)
    out = torch.empty(16, device=cuda)
    one = ctypes.c_void_p * 1
    launched = ctypes.c_int(0)
    rc = lib.masked_topk_grouped(
        one(emb.data_ptr()), one(out.data_ptr()), (ctypes.c_longlong * 1)(0), 1, 0,
        emb.data_ptr(), 64, 16, 1, 3, None, -1, mt.ROUTES["fma"], 5000,
        out.data_ptr(), out.data_ptr(), out.data_ptr(), out.data_ptr(),
        ctypes.byref(launched), torch.cuda.current_stream().cuda_stream)
    assert rc != 0 and launched.value == 0


def test_a_refused_tensor_core_launch_raises(cuda):
    """The tensor-core route takes bf16 arenas only: forced on an f32 arena,
    or on queries no tensor map can address, the card refuses it and the
    wrapper raises instead of running the FMA route."""
    emb = torch.zeros((300, 32), device=cuda)
    madd = torch.zeros(300, device=cuda)
    q = torch.zeros((32, 32), device=cuda)
    before = mt.launches
    with pytest.raises(RuntimeError, match="wgmma"):
        mt._launch(emb, madd, q, 3, route="wgmma")
    with pytest.raises(RuntimeError, match="wgmma"):
        ft._launch(emb, madd == 0, torch.zeros(300, dtype=torch.int32, device=cuda),
                   madd != 0, q, torch.zeros(32, dtype=torch.int32, device=cuda),
                   None, 3, 299, None, route="wgmma")
    assert mt.launches == before
    flat = torch.zeros(32 * 32 + 4, device=cuda, dtype=torch.bfloat16)
    misaligned = flat[4:].view(32, 32)        # 8 bytes past a 16-byte boundary
    with pytest.raises(RuntimeError, match="wgmma"):
        mt._launch(emb.bfloat16(), madd, misaligned, 3)


def test_ragged_kernel_masks_each_query_at_its_k(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    emb = grid(gen, (5003, 64), torch.bfloat16, cuda)
    mask = torch.rand(5003, generator=gen, device=cuda) < 0.8
    q = grid(gen, (4, 64), torch.bfloat16, cuda)
    for k, kq in ((10, [1, 5, 10, 0]), (300, [300, 129, 128, 7])):
        k_q = torch.tensor(kq, dtype=torch.int32, device=cuda)
        before = mt.launches
        s, r = mt.masked_topk_ragged(emb, mask, q, k_q, k)
        ps, pr = mt.masked_topk_ragged_reference(emb, mask, q, k_q, k)
        torch.cuda.synchronize()
        assert mt.launches == before + 1
        assert torch.equal(r, pr) and torch.equal(s, ps)
        assert (r[3, kq[3]:] == -1).all()
    s, r = mt.masked_topk_auto(emb, torch.where(mask, 0.0, -1e30), q, 5)
    ps, pr = mt.masked_topk_reference(emb, mask, q, 5)
    assert torch.equal(r, pr) and torch.equal(s, ps)


def two_tier_arena(gen, n, d, dtype, device):
    """Two tenants (0 and 1) over live rows, a few super rows, some dead
    rows, and exact duplicates so that ties are real."""
    emb = grid(gen, (n, d), dtype, device)
    emb[n // 2:n // 2 + 40] = emb[:40]
    alive = torch.rand(n, generator=gen, device=device) < 0.9
    alive[-1] = False                                   # the sentinel row
    tenant = (torch.rand(n, generator=gen, device=device) < 0.5).int()
    tenant = torch.where(alive, tenant, -1)
    sup = torch.rand(n, generator=gen, device=device) < 0.02
    return emb, alive, tenant, sup


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,nq,k,k_live,d", [
    (4096, 8, 128, 10, 64), (5003, 3, 16, 16, 64), (20000, 64, 128, 128, 64),
    (20000, 5, 300, 300, 64), (777, 70, 32, None, 64),
    # Q > 16 (bf16: the tensor-core route): the fleet's and a batch's shapes,
    # a gate with a list of one, lists past 128, d not a multiple of 64
    (5003, 64, 128, 10, 768), (777, 17, 1, None, 32), (5003, 65, 300, 300, 72),
    (20000, 200, 128, 128, 32)])
def test_two_tier_kernel_matches_plain_version(cuda, dtype, n, nq, k, k_live, d):
    gen = torch.Generator(device=cuda).manual_seed(n + nq + k)
    emb, alive, tenant, sup = two_tier_arena(gen, n, d, dtype, cuda)
    q = grid(gen, (nq, d), dtype, cuda)
    q_ten = torch.randint(0, 2, (nq,), generator=gen, device=cuda).int()
    kq = torch.randint(1, (k_live or k) + 1, (nq,), generator=gen,
                       device=cuda).int()
    q_ten[-1], kq[-1] = -1, 0                            # a pad query
    before = ft.launches
    got = ft.fused_topk(emb, alive, tenant, sup, q, q_ten, kq, k,
                        k_live=k_live)
    want = ft.fused_topk_reference(emb, alive, tenant, sup, q, q_ten, kq, k)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[3][-1] == n - 1).all() and (got[2][-1] == -1e30).all()


def test_two_tier_kernel_corners(cuda):
    """A tenant with no super rows gets the gate (-1e30, row 0); a tenant
    with fewer non-super rows than k fills its tail with the lowest other
    rows at -1e30; without k_q every position is live."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    n = 3000
    emb = grid(gen, (n, 32), torch.bfloat16, cuda)
    alive = torch.ones(n, dtype=torch.bool, device=cuda)
    tenant = torch.zeros(n, dtype=torch.int32, device=cuda)
    tenant[[7, 900, 2999]] = 1
    sup = torch.zeros(n, dtype=torch.bool, device=cuda)
    sup[[10, 20]] = True
    q = grid(gen, (2, 32), torch.bfloat16, cuda)
    q_ten = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    got = ft.fused_topk(emb, alive, tenant, sup, q, q_ten, None, 8)
    want = ft.fused_topk_reference(emb, alive, tenant, sup, q, q_ten, None, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0][0] == -1e30 and got[1][0].item() == 0
    assert got[3][0, 3:].tolist() == [0, 1, 2, 3, 4]


def test_two_tier_corners_on_the_tensor_core_route(cuda):
    """The corners at Q = 64 (tensor-core route), K = 128, k_q in {5, 10,
    128}: tenant 2 has no super row (gate (-1e30, row 0)), tenant 3 three
    live rows (its list ends with rows 0, 1, ... at -1e30), a pad query
    (tenant -1, k 0) only sentinels."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    n = 5003
    emb, alive, tenant, sup = two_tier_arena(gen, n, 64, torch.bfloat16, cuda)
    tenant[2000:2100] = 2
    sup[2000:2100] = False
    alive[2000:2100] = True
    short = [100, 2600, 4000]
    tenant[short] = 3
    alive[short] = True
    sup[short] = False
    q = grid(gen, (64, 64), torch.bfloat16, cuda)
    q_ten = torch.tensor([(0, 1, 2, 3)[i % 4] for i in range(64)],
                         dtype=torch.int32, device=cuda)
    kq = torch.tensor([(5, 10, 128)[i % 3] for i in range(64)],
                      dtype=torch.int32, device=cuda)
    q_ten[-1], kq[-1] = -1, 0
    before = ft.launches_wgmma
    got = ft.fused_topk(emb, alive, tenant, sup, q, q_ten, kq, 128, k_live=128)
    want = ft.fused_topk_reference(emb, alive, tenant, sup, q, q_ten, kq, 128)
    torch.cuda.synchronize()
    assert ft.launches_wgmma == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1][2].item() == 0 and got[0][2] == -1e30
    # query 11: tenant 3, k_q 128
    assert sorted(got[3][11, :3].tolist()) == short
    assert got[3][11, 3:8].tolist() == [0, 1, 2, 3, 4]
    assert (got[2][11, 3:128] == -1e30).all()
    assert (got[3][-1] == n - 1).all()


def test_fused_chat_turn_syncs_only_at_the_readback(cuda, tmp_path):
    """One fused chat turn on the card: one two-tier launch, no classic
    launch, and inside the dispatch no host wait but the one packed
    readback (``torch.cuda.set_sync_debug_mode("error")`` raises on any
    other)."""
    from lazzaro_tpu_torch import MemorySystem

    ms = MemorySystem(enable_async=False, load_from_disk=False,
                      db_dir=str(tmp_path), verbose=False, device="cuda")
    try:
        for c in range(2):
            ms.start_conversation()
            for i in range(6):
                ms.add_to_short_term(f"I like topic {c} number {i} a lot.",
                                     "semantic", 0.6)
            ms.end_conversation()
        ms.start_conversation()
        ms.chat("Which topic number do I like?")          # builds the CSR
        index = ms.index
        serve, readback = index.search_fused_requests, index._readback
        readbacks = []

        def read_once(packed):
            torch.cuda.set_sync_debug_mode(0)
            try:
                readbacks.append(packed.shape)
                return readback(packed)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        def strict(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return serve(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        index.search_fused_requests, index._readback = strict, read_once
        before = (ft.launches, mt.launches)
        ms.chat("Tell me about topic 1 number 3 please.")
        ms.search_memories("topic 0 number 2")
        torch.cuda.synchronize()
        assert (ft.launches - before[0], mt.launches - before[1]) == (2, 0)
        assert len(readbacks) == 2
        assert index._stage.allocations == 1     # one pinned buffer, reused
    finally:
        torch.cuda.set_sync_debug_mode(0)
        ms.close()


def test_host_stage_never_overwrites_a_pending_upload(cuda):
    """The pinned buffer is reused only after the copy that read it has run:
    an upload queued behind a busy stream leaves the buffer to that copy and
    the next upload takes a fresh one; both arrive intact."""
    import numpy as np
    from lazzaro_tpu_torch.core.index import HostStage

    stage = HostStage(cuda)
    a = [np.arange(12, dtype=np.float32).reshape(3, 4),
         np.array([True, False, True]), np.array([7, -1, 3], np.int32)]
    b = [x + 1 if x.dtype != bool else ~x for x in a]
    torch.cuda._sleep(100_000_000)                      # keep the stream busy
    got_a = stage.upload(a)
    got_b = stage.upload(b)
    assert stage.allocations == 2
    torch.cuda.synchronize()
    for g, w in zip(got_a + got_b, a + b):
        assert np.array_equal(g.cpu().numpy(), w)
    stage.upload(b)
    assert stage.allocations == 2                       # copy done: reused


# ---------------------------------------------------------------------------
# The cross-shard merge (csrc/sharded_merge.cu) and the row-sharded arena
# ---------------------------------------------------------------------------


def merge_lists(gen, n, q, kl, local_n, device, masked=0.0, dead_shard=None):
    """Per-shard lists in scan order (score descending, lower row first on
    ties): grid scores with ties inside and across shards, a ``masked``
    share at -1e30, optionally one shard all masked; i32 local rows."""
    s = grid(gen, (n, q, kl), torch.float32, device) / 4
    s = torch.where(torch.rand((n, q, kl), generator=gen, device=device)
                    < masked, -1e30, s)
    if dead_shard is not None:
        s[dead_shard] = -1e30
    step = local_n // kl
    rows = (torch.arange(kl, device=device) * step
            + torch.randint(0, step, (n, q, 1), generator=gen, device=device))
    s, order = s.sort(dim=-1, descending=True, stable=True)
    return s, torch.gather(rows, -1, order).int()


@pytest.mark.parametrize("n,q,kl,k,local_n,ragged,sentinel,masked,dead", [
    (8, 1, 10, 10, 131_072, False, False, 0.0, None),    # classic search
    (8, 8192, 1, 1, 131_072, False, False, 0.1, None),   # dedup probe
    (8, 8192, 3, 3, 131_072, False, False, 0.1, None),   # link scan
    (8, 64, 128, 128, 131_072, True, True, 0.2, None),   # fused fleet, ragged
    (8, 64, 1, 1, 131_072, False, True, 0.3, None),      # the gate
    (8, 16, 4, 24, 64, True, True, 0.1, 2),              # an all-masked shard
    (8, 5, 3, 10, 3, False, True, 0.0, None),            # L < k: kl = L = 3
    (1, 7, 9, 9, 100, False, False, 0.0, None),
])
def test_merge_kernel_matches_plain_version(cuda, n, q, kl, k, local_n, ragged,
                                            sentinel, masked, dead):
    from lazzaro_tpu_torch.ops import sharded_merge as sm

    gen = torch.Generator(device=cuda).manual_seed(n * q + kl)
    s, r = merge_lists(gen, n, q, kl, local_n, cuda, masked, dead)
    k_q = None
    if ragged:
        k_q = torch.tensor([(5, 10, 128)[i % 3] for i in range(q)],
                           dtype=torch.int32, device=cuda).clamp(max=k)
        k_q[-1] = 0
    sent = n * local_n - 1 if sentinel else None
    before = sm.launches
    got = sm.sharded_merge(list(s), list(r), local_n, k, k_q=k_q, sentinel=sent)
    want = sm.sharded_merge_reference(list(s), list(r), local_n, k, k_q, sent)
    torch.cuda.synchronize()
    assert sm.launches == before + 1
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    # i64 rows (the classic scan's) give the same merge
    got64 = sm.sharded_merge(list(s), [x.long() for x in r], local_n, k,
                             k_q=k_q, sentinel=sent)
    assert torch.equal(got64[1], want[1]) and torch.equal(got64[0], want[0])


def test_merge_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from lazzaro_tpu_torch.ops import sharded_merge as sm

    s = torch.zeros((2, 3), device=cuda)
    r = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sm.sharded_merge([s, s], [r, r], 8, 7)              # k > n * kl
    with pytest.raises(ValueError):
        sm.sharded_merge([s, s[:, :2]], [r, r[:, :2]], 8, 2)
    with pytest.raises(TypeError):
        sm.sharded_merge([s, s], [r.float(), r.float()], 8, 2)


def test_sharded_topk_on_one_card_equals_the_single_device_kernel(cuda):
    """``make_sharded_topk`` over 8 shards of ``cuda:0`` against one launch
    of the masked top-k kernel over the whole arena: exact rows and scores
    (grid inputs), one grouped scan (a stage 1 and a stage 2) and no merge
    launch."""
    from lazzaro_tpu_torch.ops import sharded_merge as sm
    from lazzaro_tpu_torch.ops.topk import make_sharded_topk
    from lazzaro_tpu_torch.parallel import make_mesh

    gen = torch.Generator(device=cuda).manual_seed(3)
    n, local_n = 8, 16_384
    emb = grid(gen, (n * local_n, 64), torch.bfloat16, cuda)
    emb[local_n * 5 + 7] = emb[11]                          # ties across shards
    mask = torch.rand(n * local_n, generator=gen, device=cuda) < 0.8
    mask[local_n:2 * local_n] = False                       # a dead shard
    q = grid(gen, (64, 64), torch.bfloat16, cuda)
    q[0] = emb[11]
    mesh = make_mesh(devices=["cuda:0"] * n)
    search = make_sharded_topk(mesh, k=10)
    before = (mt.launches, mt.stage_launches, sm.launches)
    s, r = search(list(emb.split(local_n)), list(mask.split(local_n)), q)
    torch.cuda.synchronize()
    assert (mt.launches - before[0], mt.stage_launches - before[1],
            sm.launches - before[2]) == (1, 2, 0)
    ws, wr = mt.masked_topk(emb, mask, q, 10)
    assert torch.equal(r.long(), wr) and torch.equal(s, ws)


def test_fused_sharded_dispatch_syncs_only_at_the_readback(cuda, tmp_path):
    """A ``MemorySystem`` on an 8-shard ``cuda:0`` mesh: a chat turn and a
    search are each one grouped two-tier launch (a stage 1 and a stage 2),
    no merge and one device-to-host copy, under
    ``set_sync_debug_mode("error")``; a classic search is one grouped scan
    and no merge; ids equal the single-device system's."""
    from lazzaro_tpu_torch import MemoryConfig, MemorySystem
    from lazzaro_tpu_torch.ops import sharded_merge as sm
    from lazzaro_tpu_torch.parallel import make_mesh

    kw = dict(enable_async=False, load_from_disk=False, verbose=False)
    mesh = make_mesh(devices=["cuda:0"] * 8)
    # a mesh takes the classic ingest; the single device the fused default
    ms = MemorySystem(db_dir=str(tmp_path / "m"), mesh=mesh,
                      config=MemoryConfig(ingest_fused=False,
                                          ingest_dedup_fused=False,
                                          auto_consolidate=False), **kw)
    one = MemorySystem(db_dir=str(tmp_path / "o"), device="cuda", **kw)
    try:
        for sys_ in (ms, one):
            for c in range(2):
                sys_.start_conversation()
                for i in range(6):
                    sys_.add_to_short_term(f"I like topic {c} number {i} a lot.",
                                           "semantic", 0.6)
                sys_.end_conversation()
            sys_.start_conversation()
            sys_.chat("Which topic number do I like?")     # builds the CSR
        index = ms.index
        serve, readback = index.search_fused_requests, index._readback
        readbacks = []

        def read_once(packed):
            torch.cuda.set_sync_debug_mode(0)
            try:
                readbacks.append(packed.shape)
                return readback(packed)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        def strict(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return serve(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        index.search_fused_requests, index._readback = strict, read_once
        before = (ft.launches, sm.launches, mt.launches, ft.stage_launches)
        ms.chat("Tell me about topic 1 number 3 please.")
        got = [n.id for n in ms.search_memories("topic 0 number 2")]
        torch.cuda.synchronize()
        assert (ft.launches - before[0], sm.launches - before[1],
                mt.launches - before[2], ft.stage_launches - before[3]) == (2, 0, 0, 4)
        assert len(readbacks) == 2
        assert got == [n.id for n in one.search_memories("topic 0 number 2")]
        ms.config.serve_fused = one.config.serve_fused = False
        before = (sm.launches, mt.launches)
        got = [n.id for n in ms.search_memories("topic 1 number 4")]
        assert (sm.launches - before[0], mt.launches - before[1]) == (0, 1)
        assert got == [n.id for n in one.search_memories("topic 1 number 4")]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        ms.close()
        one.close()


# ---------------------------------------------------------------------------
# The streaming stage 1 (Q <= 16) and the grouped scan of a card's shards
# ---------------------------------------------------------------------------


def seam_arena(gen, n, d, dtype, device):
    """A ragged arena of 257 distinct grid rows repeated: every top-k list
    is runs of exact duplicates, which straddle the chunks, the splits and
    the 128-entry passes."""
    base = grid(gen, (257, d), dtype, device)
    return base.repeat((n + 256) // 257, 1)[:n].contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 256, 768])
@pytest.mark.parametrize("nq", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("k", [1, 5, 10, 128, 300])
def test_streaming_stage1_matches_plain_version(cuda, dtype, d, nq, k):
    """Both modes at Q <= 16 through the public entry points, on the route
    the rule picks (streaming for f32, tensor cores for bf16), bit for bit:
    a ragged N, exact duplicates across every seam, a masked share, queries
    equal to arena rows (exact ties at the top), the keyed mode's two
    tenants, super rows and the k_q tail."""
    gen = torch.Generator(device=cuda).manual_seed(nq * 1000 + k * 7 + d)
    n = 6007
    emb = seam_arena(gen, n, d, dtype, cuda)
    mask = torch.rand(n, generator=gen, device=cuda) < 0.8
    q = grid(gen, (nq, d), dtype, cuda)
    q[0] = emb[3]
    counter = "launches_stream" if dtype == torch.float32 else "launches_wgmma"
    before = (getattr(mt, counter), mt.stage_launches)
    s, r = mt.masked_topk(emb, mask, q, k)
    ps, pr = mt.masked_topk_reference(emb, mask, q, k)
    torch.cuda.synchronize()
    assert (getattr(mt, counter) - before[0],
            mt.stage_launches - before[1]) == (1, 2 * mt.passes(k))
    assert torch.equal(r, pr) and torch.equal(s, ps)
    alive = mask.clone()
    alive[-1] = False
    tenant = torch.where(alive, (torch.rand(n, generator=gen, device=cuda) < 0.5).int(),
                         -1).int()
    sup = torch.rand(n, generator=gen, device=cuda) < 0.03
    q_ten = torch.randint(0, 2, (nq,), generator=gen, device=cuda).int()
    kq = torch.randint(1, k + 1, (nq,), generator=gen, device=cuda).int()
    before = getattr(ft, counter)
    got = ft.fused_topk(emb, alive, tenant, sup, q, q_ten, kq, k)
    want = ft.fused_topk_reference(emb, alive, tenant, sup, q, q_ten, kq, k)
    torch.cuda.synchronize()
    assert getattr(ft, counter) == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_corners(cuda, dtype):
    """Fewer live rows than k (the tail lists the lowest dead rows at
    -1e30), an all-masked arena, and the keyed empty gate (-1e30, row 0),
    at Q = 5 on the route the rule picks (streaming for f32)."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    n, d = 3001, 256
    emb = grid(gen, (n, d), dtype, cuda)
    q = grid(gen, (5, d), dtype, cuda)
    few = torch.zeros(n, dtype=torch.bool, device=cuda)
    few[[3, 1500, 3000]] = True
    for mask, k in ((few, 8), (torch.zeros_like(few), 10), (few, 300)):
        s, r = mt.masked_topk(emb, mask, q, k)
        ps, pr = mt.masked_topk_reference(emb, mask, q, k)
        assert torch.equal(r, pr) and torch.equal(s, ps)
    s, r = mt.masked_topk(emb, few, q, 8)
    assert r[:, 3:].tolist() == [[0, 1, 2, 4, 5]] * 5
    alive = torch.ones(n, dtype=torch.bool, device=cuda)
    tenant = torch.zeros(n, dtype=torch.int32, device=cuda)
    tenant[[7, 900, 2999]] = 1
    sup = torch.zeros(n, dtype=torch.bool, device=cuda)
    sup[[10, 20]] = True
    q_ten = torch.tensor([1, 0, 2, 1, 0], dtype=torch.int32, device=cuda)
    got = ft.fused_topk(emb, alive, tenant, sup, q, q_ten, None, 8)
    want = ft.fused_topk_reference(emb, alive, tenant, sup, q, q_ten, None, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0][0] == -1e30 and got[1][0].item() == 0
    assert got[3][0, 3:].tolist() == [0, 1, 2, 3, 4]
    assert (got[2][2] == -1e30).all()                 # tenant 2 has no row


@pytest.mark.parametrize("nq", [1, 8, 16])
def test_streaming_scores_do_not_depend_on_the_row_offset(cuda, nq):
    """On real (non-grid) data a row's score at Q <= 16 is bitwise the same
    in the whole arena and in a slice starting at an unaligned row, on the
    streaming route (f32) and the tensor cores (bf16): the summation order
    is fixed per row, whatever its chunk, split or shard."""
    rng = np.random.default_rng(nq)
    n, d, k = 9000, 768, 128
    x = rng.standard_normal((n, d)).astype(np.float32)
    rows = torch.from_numpy(rng.choice(np.arange(3001, n), k, replace=False)).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        emb = torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(
            cuda, dtype)
        q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).to(
            cuda, dtype)
        mask = torch.zeros(n, dtype=torch.bool, device=cuda)
        mask[rows] = True
        for kk in (1, k):
            whole_s, whole_r = mt.masked_topk(emb, mask, q, kk)
            for off in (1, 777, 3001):
                part_s, part_r = mt.masked_topk(emb[off:], mask[off:], q, kk)
                order = torch.argsort(whole_r, dim=1)
                part_order = torch.argsort(part_r, dim=1)
                assert torch.equal(torch.gather(whole_r, 1, order),
                                   torch.gather(part_r, 1, part_order) + off)
                assert torch.equal(torch.gather(whole_s, 1, order),
                                   torch.gather(part_s, 1, part_order)), (dtype, kk, off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,nq,f32_route", [
    (1536, 1, "stream"), (1536, 8, "stream"), (1536, 16, "fma"),
    (2048, 1, "stream"), (2048, 4, "stream"), (2048, 16, "fma"),
    (3072, 1, "stream"), (3072, 8, "fma"), (3072, 16, "fma"), (4096, 1, "fma"),
    (4096, 16, "fma"),
    (8, 4, "stream"), (8, 16, "fma"), (16, 8, "stream"), (16, 16, "fma")])
def test_wide_rows_take_a_route_that_takes_them(cuda, dtype, d, nq, f32_route):
    """Every width the scans took before the small-Q routes came is taken
    still, through the public entry points, bit for bit: an f32 scan the
    streaming route does not take (its registers cannot hold the queries,
    or more than four query groups would re-read each row) goes to the FMA
    route, and wide rows come in chunks of fewer than 16; bf16 goes to the
    tensor cores."""
    gen = torch.Generator(device=cuda).manual_seed(d + nq)
    n = 3001
    emb = seam_arena(gen, n, d, dtype, cuda)
    mask = torch.rand(n, generator=gen, device=cuda) < 0.8
    q = grid(gen, (nq, d), dtype, cuda)
    q[0] = emb[3]
    route = mt.route_for(dtype, nq, d)
    assert route == ("wgmma" if dtype == torch.bfloat16 else f32_route)
    for k in (1, 10, 128):
        before = (mt.launches, mt.launches_wgmma, mt.launches_stream)
        got = mt.masked_topk(emb, mask, q, k)
        want = mt.masked_topk_reference(emb, mask, q, k)
        assert (mt.launches - before[0], mt.launches_wgmma - before[1],
                mt.launches_stream - before[2]) == \
            (1, int(route == "wgmma"), int(route == "stream"))
        for g, w in zip(got, want):
            assert torch.equal(g, w), (route, k)
    alive = mask.clone()
    alive[-1] = False
    tenant = torch.where(alive, (torch.rand(n, generator=gen, device=cuda) < 0.5).int(),
                         -1).int()
    sup = torch.rand(n, generator=gen, device=cuda) < 0.03
    q_ten = torch.randint(0, 2, (nq,), generator=gen, device=cuda).int()
    kq = torch.randint(1, 11, (nq,), generator=gen, device=cuda).int()
    got = ft.fused_topk(emb, alive, tenant, sup, q, q_ten, kq, 128, k_live=10)
    want = ft.fused_topk_reference(emb, alive, tenant, sup, q, q_ten, kq, 128)
    for g, w in zip(got, want):
        assert torch.equal(g, w), route


def sharded_case(gen, n, local_n, d, nq, device):
    """Grid shards with an exact tie across shards, an all-masked shard, a
    shard with fewer live rows than k, two tenants and super rows."""
    emb = grid(gen, (n * local_n, d), torch.bfloat16, device)
    emb[local_n * (n - 1) + 7] = emb[11]
    alive = torch.rand(n * local_n, generator=gen, device=device) < 0.8
    alive[local_n:2 * local_n] = False                    # an all-masked shard
    alive[-1] = False                                     # the global sentinel
    if n > 2:
        alive[2 * local_n:3 * local_n] = False
        alive[2 * local_n + 5] = True                     # one live row
    tenant = torch.where(alive, (torch.rand(n * local_n, generator=gen,
                                            device=device) < 0.5).int(), -1).int()
    sup = torch.rand(n * local_n, generator=gen, device=device) < 0.02
    q = grid(gen, (nq, d), torch.bfloat16, device)
    q[0] = emb[11]
    return emb, alive, tenant, sup, q


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("nq", [1, 64])
def test_grouped_scan_equals_per_shard_plain_and_merge(cuda, n, nq):
    """The grouped launch over n shards of one card, both modes, against each
    shard's plain scan and the plain merge: ties across shards, an
    all-masked shard, a shard with one live row, the k_q tail and the
    keyed empty gate on the global sentinel."""
    gen = torch.Generator(device=cuda).manual_seed(n * 100 + nq)
    local_n, d = 4099, 64
    emb, alive, tenant, sup, q = sharded_case(gen, n, local_n, d, nq, cuda)
    embs, masks = list(emb.split(local_n)), list(alive.split(local_n))
    for k in (10, 128, 300):
        before = (mt.launches, mt.stage_launches)
        got = mt.masked_topk_grouped(embs, masks, q, k)
        torch.cuda.synchronize()
        assert (mt.launches - before[0], mt.stage_launches - before[1]) == \
            (1, 2 * mt.passes(k))
        want = mt.masked_topk_grouped_reference(embs, masks, q, k, range(n))
        for g, w in zip(got, want):
            assert torch.equal(g, w), k
    states = list(zip(emb.split(local_n), alive.split(local_n),
                      tenant.split(local_n), sup.split(local_n)))
    q_ten = torch.tensor([(0, 1, 2)[i % 3] for i in range(nq)], dtype=torch.int32,
                         device=cuda)
    sent = n * local_n - 1
    for k, kqs in ((128, (5, 10, 128)), (10, (10, 1))):
        kq = torch.tensor([kqs[i % len(kqs)] for i in range(nq)], dtype=torch.int32,
                          device=cuda)
        before = (ft.launches, ft.stage_launches)
        got = ft.fused_topk_grouped(states, q, q_ten, kq, k, sent, k_live=max(kqs))
        torch.cuda.synchronize()
        assert (ft.launches - before[0], ft.stage_launches - before[1]) == (1, 2)
        cpu = [tuple(x.cpu() for x in st) for st in states]
        want = ft.fused_topk_grouped_reference(cpu, q.cpu(), q_ten.cpu(), kq.cpu(), k,
                                               sent, range(n))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), k
        if nq > 2:                                      # tenant 2 has no row
            assert got[1][2].item() == sent and got[0][2] == -1e30


def test_two_device_groups_compose_through_the_merge(cuda):
    """Shards 0-3 and 4-7 scanned as two groups and joined by the merge
    kernel (rows already global) equal one group of all 8, both modes."""
    from lazzaro_tpu_torch.ops import sharded_merge as sm

    gen = torch.Generator(device=cuda).manual_seed(21)
    n, local_n, d, nq, k = 8, 3001, 256, 16, 10
    emb, alive, tenant, sup, q = sharded_case(gen, n, local_n, d, nq, cuda)
    embs, masks = list(emb.split(local_n)), list(alive.split(local_n))
    whole = mt.masked_topk_grouped(embs, masks, q, k)
    halves = [mt.masked_topk_grouped(embs[i:i + 4], masks[i:i + 4], q, k,
                                     range(i, i + 4)) for i in (0, 4)]
    joined = sm.sharded_merge([h[0] for h in halves], [h[1] for h in halves], 0, k)
    for g, w in zip(joined, whole):
        assert torch.equal(g, w)
    states = list(zip(emb.split(local_n), alive.split(local_n),
                      tenant.split(local_n), sup.split(local_n)))
    q_ten = torch.tensor([i % 3 for i in range(nq)], dtype=torch.int32, device=cuda)
    kq = torch.tensor([(5, 10)[i % 2] for i in range(nq)], dtype=torch.int32, device=cuda)
    sent = n * local_n - 1
    whole = ft.fused_topk_grouped(states, q, q_ten, kq, k, sent)
    halves = [ft.fused_topk_grouped(states[i:i + 4], q, q_ten, None, k, sent,
                                    shard_ids=range(i, i + 4)) for i in (0, 4)]
    ann = sm.sharded_merge([h[2] for h in halves], [h[3] for h in halves], 0, k,
                           k_q=kq, sentinel=sent)
    gate = sm.sharded_merge([h[0][:, None] for h in halves],
                            [h[1][:, None] for h in halves], 0, 1, sentinel=sent)
    for g, w in zip((gate[0][:, 0], gate[1][:, 0], *ann), whole):
        assert torch.equal(g, w)


def test_one_card_mesh_search_and_chat_scan_are_two_launches_a_pass(cuda):
    """On a one-card mesh, ``make_sharded_topk`` and the fused chat scan
    (``core.state._fused_scan_sharded``) each launch one stage 1 and one
    stage 2 a pass of 128 list entries, and no merge."""
    from lazzaro_tpu_torch.core import state as S
    from lazzaro_tpu_torch.ops import sharded_merge as sm
    from lazzaro_tpu_torch.parallel import make_mesh

    gen = torch.Generator(device=cuda).manual_seed(5)
    n, local_n, d = 8, 2048, 64
    mesh = make_mesh(devices=["cuda:0"] * n)
    shards = S.init_shards(n * local_n - 1, d, torch.bfloat16, mesh.devices)
    for st in shards:
        st.emb.copy_(grid(gen, (local_n, d), torch.bfloat16, cuda))
        st.alive.fill_(True)
    q = grid(gen, (1, d), torch.bfloat16, cuda)
    masks = [st.alive for st in shards]
    for k, want in ((10, 2), (300, 6)):
        search = tk.make_sharded_topk(mesh, k=k)
        before = (mt.stage_launches, sm.launches)
        search([st.emb for st in shards], masks, q)
        assert (mt.stage_launches - before[0], sm.launches - before[1]) == (want, 0)
    tenant = torch.zeros(1, dtype=torch.int32, device=cuda)
    k_q = torch.tensor([10], dtype=torch.int32, device=cuda)
    before = (ft.stage_launches, sm.launches)
    S._fused_scan_sharded(shards, q.float(), tenant, 128, k_q, k_live=10)
    torch.cuda.synchronize()
    assert (ft.stage_launches - before[0], sm.launches - before[1]) == (2, 0)


# ---------------------------------------------------------------------------
# Flash attention (csrc/flash_attention.cu) against its plain version
# ---------------------------------------------------------------------------

# Tolerances: in f32 the kernel and the plain version differ only in the
# order of their f32 sums (1e-4). In bf16 both round P to bf16 before P.V,
# but the output is rounded to bf16 after sums taken in another order, so a
# value may land one bf16 step away (<= 1.6e-2 below 4 in magnitude); the
# f32 log-sum-exp stays within 1e-3.
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}


def flash_inputs(gen, B, T, S, H, Hkv, D, dtype, device):
    return (torch.randn((B, T, H, D), generator=gen, device=device).to(dtype),
            torch.randn((B, S, Hkv, D), generator=gen, device=device).to(dtype),
            torch.randn((B, S, Hkv, D), generator=gen, device=device).to(dtype))


def assert_flash_close(got, want, dtype):
    out_tol, lse_tol = FLASH_TOL[dtype]
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert float((got[0].float() - want[0].float()).abs().max()) <= out_tol
    assert float((got[1] - want[1]).abs().max()) <= lse_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,Hkv,D", [
    (2, 64, 64, 4, 2, 32),      # GQA, tile-aligned
    (1, 37, 37, 4, 4, 16),      # MHA, ragged T
    (1, 8, 8, 2, 1, 8),         # tiny, extreme GQA
    (1, 13, 29, 2, 2, 24),      # S > T, head_dim not a multiple of 16
    (2, 130, 130, 8, 2, 256),   # the full-width head_dim
    (1, 13, 200, 8, 1, 64),     # chunked prefill, MQA
    (2, 256, 256, 4, 2, 192),   # head_dim 192, full tiles
    (2, 256, 256, 4, 2, 128),   # head_dim 128, full tiles
    (1, 200, 333, 8, 2, 256),   # S - T = 133, a multiple of no tile
    (4, 1024, 1024, 8, 2, 128),  # more blocks than one wave of the card
    (1, 300, 300, 8, 1, 256),   # MQA rep = 8 at the full-width head_dim
])
def test_flash_kernel_matches_plain_version(cuda, dtype, B, T, S, H, Hkv, D):
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(B + T + S + D)
    q, k, v = flash_inputs(gen, B, T, S, H, Hkv, D, dtype, cuda)
    before = fa.launches
    got = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert_flash_close(got, want, dtype)


def test_flash_kernel_reads_strided_inputs_in_place(cuda):
    """q, k and v as transposed views of [B, H, T, D] tensors: the kernel
    reads them through their strides."""
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(9)
    qt = torch.randn((2, 8, 100, 64), generator=gen, device=cuda).bfloat16()
    kt = torch.randn((2, 2, 100, 64), generator=gen, device=cuda).bfloat16()
    vt = torch.randn((2, 2, 100, 64), generator=gen, device=cuda).bfloat16()
    q, k, v = (x.transpose(1, 2) for x in (qt, kt, vt))
    assert not q.is_contiguous()
    got = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_reference(q.contiguous(), k.contiguous(),
                                        v.contiguous())
    assert_flash_close(got, want, torch.bfloat16)


def test_flash_kernel_is_bitwise_deterministic(cuda):
    """Two launches on the same inputs give the same O and LSE bit for bit:
    each output element is computed by one block in one order."""
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = flash_inputs(gen, 2, 777, 777, 8, 2, 256, torch.bfloat16, cuda)
    first = fa.flash_attention_fwd(q, k, v)
    second = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_flash_kernel_reads_transposed_views_at_full_head_dim(cuda):
    """q, k and v as transposed views of [B, H, T, D] tensors at D = 256:
    the tensor maps see strides in another order than a dense layout's."""
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(14)
    qt = torch.randn((2, 8, 190, 256), generator=gen, device=cuda).bfloat16()
    kt = torch.randn((2, 2, 190, 256), generator=gen, device=cuda).bfloat16()
    vt = torch.randn((2, 2, 190, 256), generator=gen, device=cuda).bfloat16()
    q, k, v = (x.transpose(1, 2) for x in (qt, kt, vt))
    assert not q.is_contiguous()
    got = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_reference(q.contiguous(), k.contiguous(),
                                        v.contiguous())
    assert_flash_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_stride_zero_inputs_in_place(cuda, dtype):
    """k broadcast over its heads and v over the batch (stride 0), read in
    place: no tensor map takes a zero stride, so these tiles are loaded
    with cp.async into the same ring."""
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(15)
    B, T, S, H, Hkv, D = 2, 150, 170, 8, 2, 256
    q = torch.randn((B, T, H, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, S, 1, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((1, S, Hkv, D), generator=gen, device=cuda).to(dtype)
    k, v = k.expand(B, S, Hkv, D), v.expand(B, S, Hkv, D)
    assert k.stride(2) == 0 and v.stride(0) == 0
    before = fa.launches
    got = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_reference(q, k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert_flash_close(got, want, dtype)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from lazzaro_tpu_torch.ops import flash_attention as fa

    def qkv(T, S, D, dtype=torch.bfloat16):
        return (torch.zeros((1, T, 2, D), device=cuda, dtype=dtype),
                torch.zeros((1, S, 2, D), device=cuda, dtype=dtype),
                torch.zeros((1, S, 2, D), device=cuda, dtype=dtype))

    for bad in (qkv(8, 8, 12), qkv(8, 8, 264), qkv(16, 8, 64)):
        with pytest.raises(ValueError):
            fa.flash_attention_fwd(*bad)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(*qkv(8, 8, 64, torch.float16))
    q, k, v = qkv(8, 8, 64)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q[..., 1:57], k[..., 1:57], v[..., 1:57])


def test_flash_refused_launch_raises(cuda):
    """The C entry point reports what it refuses (head_dim 12) as an error
    code instead of launching."""
    from lazzaro_tpu_torch.ops import flash_attention as fa

    x = torch.zeros((1, 8, 2, 16), device=cuda)
    lse = torch.empty((1, 2, 8), device=cuda)
    rc = fa._library().flash_attention_fwd(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), lse.data_ptr(),
        0, 1, 8, 8, 2, 2, 12, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0.25,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0


# Backward tolerances (dq, dk and dv against the plain backward). f32: the
# two differ only in the order of f32 sums (2e-4 of the plain result's
# largest magnitude). bf16: both round P and dS to bf16 at the same points
# and sum in f32, but in other orders, so an element of dS or P may round to
# the neighbouring bf16 value, and the outputs are rounded to bf16 after
# that: errors are taken relative to the plain result's largest magnitude
# (2e-2, about three bf16 steps of the largest element).
FLASH_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def flash_bwd_case(gen, B, T, S, H, Hkv, D, dtype, device):
    from lazzaro_tpu_torch.ops import flash_attention as fa

    q, k, v = flash_inputs(gen, B, T, S, H, Hkv, D, dtype, device)
    do = torch.randn((B, T, H, D), generator=gen, device=device).to(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v)
    return q, k, v, out, lse, do


def assert_bwd_close(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= FLASH_BWD_TOL[dtype] * max(scale, 1e-6), (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,Hkv,D", [
    (2, 64, 64, 4, 2, 32),      # GQA, tile-aligned
    (1, 37, 37, 4, 4, 16),      # MHA, ragged T
    (1, 8, 8, 8, 1, 8),         # MQA rep = 8
    (1, 13, 29, 2, 2, 24),      # S > T, head_dim not a multiple of 16
    (2, 130, 130, 8, 2, 256),   # the full-width head_dim, ragged
    (1, 13, 200, 8, 1, 64),     # chunked S > T, MQA
    (2, 256, 256, 4, 2, 128),   # head_dim 128, full tiles
    (2, 256, 256, 4, 2, 192),   # head_dim 192, full tiles
    (1, 512, 512, 8, 2, 256),   # D = 256, one wave of both kernels
    (4, 1024, 1024, 8, 2, 256),  # D = 256, several waves of both kernels
    (1, 300, 300, 8, 1, 256),   # MQA rep = 8 at the full-width head_dim
    (1, 200, 333, 8, 2, 256),   # S - T = 133, a multiple of no tile
])
def test_flash_bwd_kernels_match_plain_version(cuda, dtype, B, T, S, H, Hkv, D):
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(B + T + S + D + 1)
    args = flash_bwd_case(gen, B, T, S, H, Hkv, D, dtype, cuda)
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    got = fa.flash_attention_bwd(*args)
    want = fa.flash_attention_bwd_reference(*args)
    torch.cuda.synchronize()
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert_bwd_close(got, want, dtype)


def test_flash_bwd_reads_strided_inputs_in_place(cuda):
    """q, k, v and the gradient as transposed views of [B, H, T, D]
    tensors, and the stride-0 gradient of a sum through autograd."""
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(11)
    qt = torch.randn((2, 8, 100, 64), generator=gen, device=cuda).bfloat16()
    kt = torch.randn((2, 2, 100, 64), generator=gen, device=cuda).bfloat16()
    vt = torch.randn((2, 2, 100, 64), generator=gen, device=cuda).bfloat16()
    dot = torch.randn((2, 8, 100, 64), generator=gen, device=cuda).bfloat16()
    q, k, v, do = (x.transpose(1, 2) for x in (qt, kt, vt, dot))
    out, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do)
    want = fa.flash_attention_bwd_reference(q.contiguous(), k.contiguous(),
                                            v.contiguous(), out, lse,
                                            do.contiguous())
    assert_bwd_close(got, want, torch.bfloat16)
    leaves = [x.contiguous().requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*leaves).sum().backward()
    want = fa.flash_attention_bwd_reference(*(x.detach() for x in leaves), out,
                                            lse, torch.ones_like(out))
    assert_bwd_close([x.grad for x in leaves], want, torch.bfloat16)


def test_flash_bwd_kernels_are_bitwise_deterministic(cuda):
    """Two backward launches on the same inputs give the same dq, dk and dv
    bit for bit: each output element is summed by one block in one order,
    with no atomics."""
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(16)
    args = flash_bwd_case(gen, 2, 777, 777, 8, 2, 256, torch.bfloat16, cuda)
    first = fa.flash_attention_bwd(*args)
    second = fa.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_bwd_reads_transposed_views_and_stride_zero_at_full_head_dim(cuda):
    """bf16 at D = 256: q, k, v and the gradient as transposed views of
    [B, H, T, D] tensors (the tensor maps see strides in another order than
    a dense layout's), then a gradient broadcast over batch and heads
    (stride 0 with a unit last stride, read in place by cp.async)."""
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(17)
    qt = torch.randn((2, 8, 190, 256), generator=gen, device=cuda).bfloat16()
    kt = torch.randn((2, 2, 190, 256), generator=gen, device=cuda).bfloat16()
    vt = torch.randn((2, 2, 190, 256), generator=gen, device=cuda).bfloat16()
    dot = torch.randn((2, 8, 190, 256), generator=gen, device=cuda).bfloat16()
    q, k, v, do = (x.transpose(1, 2) for x in (qt, kt, vt, dot))
    assert not q.is_contiguous()
    out, lse = fa.flash_attention_fwd(q, k, v)
    dense = [x.contiguous() for x in (q, k, v)]
    got = fa.flash_attention_bwd(q, k, v, out, lse, do)
    want = fa.flash_attention_bwd_reference(*dense, out, lse, do.contiguous())
    assert_bwd_close(got, want, torch.bfloat16)
    row = torch.randn((1, 190, 1, 256), generator=gen, device=cuda).bfloat16()
    do0 = row.expand(2, 190, 8, 256)
    assert do0.stride(0) == 0 and do0.stride(2) == 0 and do0.stride(3) == 1
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do0)
    torch.cuda.synchronize()
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (before[0] + 1,
                                                         before[1] + 1)
    want = fa.flash_attention_bwd_reference(*dense, out, lse, do0.contiguous())
    assert_bwd_close(got, want, torch.bfloat16)


def test_flash_bwd_allocates_only_its_outputs_and_delta(cuda):
    """The backward's peak device memory beyond its inputs is dq, dk, dv
    and the [B, H, T] f32 delta: the kernels allocate nothing."""
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(18)
    B, T, S, H, Hkv, D = 2, 1024, 1024, 8, 2, 256
    args = flash_bwd_case(gen, B, T, S, H, Hkv, D, torch.bfloat16, cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = fa.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    outputs = sum(g.numel() * g.element_size() for g in got)
    assert outputs == 2 * (B * T * H * D + 2 * B * S * Hkv * D)
    # the allocator rounds each block up to 512 bytes
    assert peak <= outputs + B * H * T * 4 + 4 * 512, (peak, outputs)


def test_flash_bwd_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    from lazzaro_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, out, lse, do = flash_bwd_case(gen, 1, 16, 16, 2, 2, 64,
                                           torch.bfloat16, cuda)
    with pytest.raises(ValueError):                     # lse of another shape
        fa.flash_attention_bwd(q, k, v, out, lse[:, :, :8], do)
    with pytest.raises(ValueError):                     # gradient of another shape
        fa.flash_attention_bwd(q, k, v, out, lse, do[:, :8])
    with pytest.raises(TypeError):                      # mixed types
        fa.flash_attention_bwd(q, k, v, out, lse, do.float())
    with pytest.raises(TypeError):                      # f16
        h = [x.half() for x in (q, k, v, out)]
        fa.flash_attention_bwd(*h, lse, do.half())
    with pytest.raises(ValueError):                     # misaligned rows
        fa.flash_attention_bwd(q[..., 1:57], k[..., 1:57], v[..., 1:57],
                               out[..., 1:57], lse, do[..., 1:57].contiguous())
    bad = [torch.zeros((1, 16, 2, 12), device=cuda, dtype=torch.bfloat16)] * 2
    with pytest.raises(ValueError):                     # head_dim 12
        fa.flash_attention_bwd(bad[0], bad[0], bad[0], bad[0], lse, bad[1])
    x = torch.zeros((1, 8, 2, 16), device=cuda)
    lse8 = torch.zeros((1, 2, 8), device=cuda)
    for fn, outs in ((fa._bwd_library().flash_attention_bwd_dq, 1),
                     (fa._bwd_library().flash_attention_bwd_dkv, 2)):
        rc = fn(*([x.data_ptr()] * 5), lse8.data_ptr(), lse8.data_ptr(),
                *([x.data_ptr()] * outs), 0, 1, 8, 8, 2, 2, 12, *([0] * 15),
                0.25, torch.cuda.current_stream().cuda_stream)
        assert rc != 0


def test_decoder_train_step_flash_gradients_equal_plain(cuda):
    """A bf16 decoder at the small widths: one train step's loss and
    gradients through the flash kernels (one forward and two backward
    launches per layer) against attn_impl="xla" from the same weights. The
    paths round the scores at other points (the plain path to bf16 before
    the softmax), so gradients are compared by cosine (> 0.99 per tensor)."""
    import dataclasses
    from lazzaro_tpu_torch.models.llm import Decoder, LMConfig, make_train_step
    from lazzaro_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(LMConfig.small(), layers=2, max_seq=256)
    tokens = torch.randint(0, 256, (2, 200), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(3))
    mask = torch.ones_like(tokens)
    grads, losses = {}, {}
    for impl in ("flash", "xla"):
        dec = Decoder(cfg, device=cuda).init_weights(1)
        opt = torch.optim.SGD(dec.parameters(), lr=0.0)
        seen = {}
        for name, p in dec.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda p, name=name: seen.__setitem__(name, p.grad.clone()))
        before = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        losses[impl] = float(make_train_step(
            dataclasses.replace(cfg, attn_impl=impl), opt)(dec, tokens, mask))
        after = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        launched = tuple(a - b for a, b in zip(after, before))
        assert launched == ((cfg.layers,) * 3 if impl == "flash" else (0, 0, 0))
        assert set(seen) == {n for n, _ in dec.named_parameters()}
        grads[impl] = seen
    assert abs(losses["flash"] - losses["xla"]) < 1e-2
    for name, g in grads["flash"].items():
        w = grads["xla"][name]
        cos = float(torch.nn.functional.cosine_similarity(
            g.flatten().double(), w.flatten().double(), dim=0))
        assert cos > 0.99, (name, cos)


def test_decoder_flash_equals_plain_on_the_card(cuda):
    """A bf16 decoder at the small widths: the cache-less forward through
    the kernel (one launch per layer) against attn_impl="xla"."""
    import dataclasses
    from lazzaro_tpu_torch.models.llm import LanguageModel, LMConfig
    from lazzaro_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(LMConfig.small(), layers=2, max_seq=256)
    lm = LanguageModel(cfg, seed=1, device="cuda")
    assert lm.cfg.attn_impl == "flash"
    text = "The memory system keeps facts about the user. " * 4
    before = fa.launches
    flash = lm.logits_for(text)
    assert fa.launches == before + cfg.layers
    plain = lm.logits_for(text, attn_impl="xla")
    assert fa.launches == before + cfg.layers
    assert np.abs(flash - plain).max() < 0.1


def test_json_device_loop_reads_back_only_its_flags(cuda):
    """The on-device JSON loop makes no host wait but its counted readbacks
    (one done flag per step and the ids once): every other sync raises
    under ``set_sync_debug_mode("error")``."""
    import json
    from lazzaro_tpu_torch.models.llm import LanguageModel, LMConfig

    lm = LanguageModel(LMConfig.tiny(), seed=0, device="cuda")
    loop, read = lm._json_device_loop, lm._readback

    def read_allowed(t):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return read(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    lm._json_device_loop, lm._readback = strict, read_allowed
    try:
        doc = lm.generate_json("Extract facts.", max_new_tokens=24)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    json.loads(doc)
    assert 2 <= lm.readbacks <= 25
    host = LanguageModel(LMConfig.tiny(), seed=0, device="cuda")
    assert host.generate_json("Extract facts.", max_new_tokens=24,
                              device_loop=False) == doc


# ---------------------------------------------------------------------------
# The fused ingest: the ingest mode of the scan (K1) and the dedup resolve
# ---------------------------------------------------------------------------

from lazzaro_tpu_torch.ops import dedup_resolve as dr  # noqa: E402
from lazzaro_tpu_torch.ops import ingest_topk as it  # noqa: E402


def ingest_arena(gen, n, d, dtype, device, tenants=2, shards=3):
    """Grid rows with exact duplicates, two tenants, three shards, ~5%
    super rows, ~20% dead rows; the last row is the sentinel."""
    emb = grid(gen, (n, d), dtype, device)
    emb[n // 2:n // 2 + 40] = emb[:40]                       # exact ties
    alive = torch.rand(n, generator=gen, device=device) < 0.8
    ten = torch.randint(0, tenants, (n,), generator=gen, device=device).int()
    sup = (torch.rand(n, generator=gen, device=device) < 0.05) & alive
    shard = torch.randint(0, shards, (n,), generator=gen, device=device).int()
    return emb, alive, torch.where(alive, ten, -1).int(), sup, shard


def ingest_both(cols, qd, qs, probe_excl, link_excl, tenant, k, modes,
                with_probe=True, route=None):
    emb, alive, ten, sup, shard = cols
    args = (emb, alive, ten, sup, shard, probe_excl, link_excl, qd, qs, tenant,
            k, modes, with_probe)
    got = it._launch(*args, route=route) if route else it.ingest_topk(*args)
    want = it.ingest_topk_reference(*args)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [1, 3, 16, 17, 512])
@pytest.mark.parametrize("k", [1, 3, 128])
def test_ingest_scan_matches_plain_version(cuda, dtype, nq, k):
    """K1 on the route the wrapper takes (tensor cores for bf16, FMA for
    f32): the probe and both modes' lists bit for bit, ties included; the
    batch's own rows excluded from the lists, the sentinel from both."""
    gen = torch.Generator(device=cuda).manual_seed(nq * 7 + k)
    n, d = 5003, 72
    cols = ingest_arena(gen, n, d, dtype, cuda)
    qd = torch.cat([cols[0][:nq // 2], grid(gen, (nq - nq // 2, d), dtype, cuda)])
    qs = torch.randint(0, 3, (nq,), generator=gen, device=cuda).int()
    probe_excl = torch.arange(n, device=cuda) == n - 1
    link_excl = probe_excl.clone()
    link_excl[torch.randint(0, n, (nq,), generator=gen, device=cuda)] = True
    before = (it.launches, it.launches_wgmma)
    ingest_both(cols, qd, qs, probe_excl, link_excl, 0, k, (1, 0))
    wg = int(dtype == torch.bfloat16)
    assert (it.launches - before[0], it.launches_wgmma - before[1]) == (1, wg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("modes,with_probe", [((-1,), True), ((0,), False),
                                               ((), True), ((-1, 1), False)])
def test_ingest_scan_modes(cuda, dtype, modes, with_probe):
    gen = torch.Generator(device=cuda).manual_seed(len(modes) + 10 * with_probe)
    n, d = 3001, 64
    cols = ingest_arena(gen, n, d, dtype, cuda)
    qd = grid(gen, (40, d), dtype, cuda)
    qs = torch.randint(0, 3, (40,), generator=gen, device=cuda).int()
    none = torch.zeros(n, dtype=torch.bool, device=cuda)
    out = ingest_both(cols, qd, qs, none, none, 1, 5, modes, with_probe)
    assert len(out) == 2 * len(modes) + 2 * with_probe


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ingest_scan_corners(cuda, dtype):
    """A tenant with fewer eligible rows than k (its tail: the lowest other
    rows at -1e30), an empty tenant (probe (-1e30, row 0)), mode -1, a live
    sentinel row of the tenant (excluded from the probe and the lists)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    n, d, k = 2000, 32, 8
    emb, alive, ten, sup, shard = ingest_arena(gen, n, d, dtype, cuda)
    ten[ten == 1] = 0
    few = torch.tensor([5, 77, 1000, n - 1], device=cuda)
    alive[few] = True
    sup[few] = False
    ten[few] = 1                                  # tenant 1: 3 rows + sentinel
    cols = (emb, alive, ten, sup, shard)
    qd = emb[few].clone()
    qs = shard[few].clone()
    probe_excl = torch.arange(n, device=cuda) == n - 1
    for tenant in (1, 3):                          # tenant 3 owns no row
        out = ingest_both(cols, qd, qs, probe_excl, probe_excl, tenant, k,
                          (-1, 0))
        if tenant == 3:
            assert (out[0] == -1e30).all() and (out[1] == 0).all()
    ps, pr = out[0], out[1]
    got = ingest_both(cols, qd, qs, probe_excl, probe_excl, 1, k, (-1, 0))
    rows0 = got[5]                                 # mode 0's rows
    assert n - 1 not in got[1].view(-1).tolist() + rows0.view(-1).tolist()
    assert rows0[0, 3:].tolist() == [0, 1, 2, 3, 4]
    assert ps.shape == pr.shape == (4, 1)


def test_ingest_probe_equals_masked_topk_probe(cuda):
    """The probe's scores are bit for bit those of masked_topk's dedup probe
    on the same route, on real-valued bf16 data (no grid: the sums round),
    at a tensor-core batch and at Q = 8; f32 at Q = 64 on the FMA route."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for dtype, nq in ((torch.bfloat16, 300), (torch.bfloat16, 8),
                      (torch.float32, 64)):
        n, d = 20_000, 256
        emb = torch.nn.functional.normalize(
            torch.randn((n, d), generator=gen, device=cuda), dim=1).to(dtype)
        alive = torch.rand(n, generator=gen, device=cuda) < 0.9
        ten = torch.zeros(n, dtype=torch.int32, device=cuda)
        sup = torch.zeros(n, dtype=torch.bool, device=cuda)
        shard = torch.zeros(n, dtype=torch.int32, device=cuda)
        q = torch.nn.functional.normalize(
            torch.randn((nq, d), generator=gen, device=cuda), dim=1).to(dtype)
        none = torch.zeros(n, dtype=torch.bool, device=cuda)
        out = it.ingest_topk(emb, alive, ten, sup, shard, none, none, q,
                             torch.zeros(nq, dtype=torch.int32, device=cuda), 0,
                             3, (1, 0))
        route = "wgmma" if dtype == torch.bfloat16 else "fma"
        s, r = mt._launch(emb, torch.where(alive, 0.0, -1e30), q, 1, route=route)
        torch.cuda.synchronize()
        assert torch.equal(out[0], s) and torch.equal(out[1].long(), r)


def hashed_rows(n, dim, seed):
    """L2-normalized HashingEmbedder vectors of made-up texts: real-valued
    f32 data whose sums round, as the default configuration's arena holds."""
    from lazzaro_tpu_torch.core.providers import HashingEmbedder

    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, size=rng.integers(4, 24)))
             for _ in range(n)]
    return np.asarray(HashingEmbedder(dim).batch_embed(texts), np.float32)


@pytest.mark.parametrize("nq", [1, 8, 16])
def test_ingest_f32_probe_equals_streaming_masked_topk_probe(cuda, nq):
    """ROADMAP Queue 3's open check: at Q <= 16 an f32 arena's dedup probe
    in K1 (the fused ingest) and in ``masked_topk`` (the classic ingest's
    ``search_batch``, on the streaming route) must score every pair bit for
    bit, else a verdict at the 0.95 gate could differ between the two
    ingests. Hashed 768-d rows, queries that repeat and perturb arena
    rows."""
    n, d = 30_000, 768
    emb = torch.from_numpy(hashed_rows(n, d, nq)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(nq)
    alive = torch.rand(n, generator=gen, device=cuda) < 0.9
    ten = torch.zeros(n, dtype=torch.int32, device=cuda)
    sup = torch.zeros(n, dtype=torch.bool, device=cuda)
    shard = torch.zeros(n, dtype=torch.int32, device=cuda)
    pick = torch.randint(0, n, (nq,), generator=gen, device=cuda)
    q = torch.nn.functional.normalize(
        emb[pick] + 0.02 * torch.randn((nq, d), generator=gen, device=cuda), dim=1)
    q[: nq // 2] = emb[pick[: nq // 2]]
    none = torch.zeros(n, dtype=torch.bool, device=cuda)
    args = (emb, alive, ten, sup, shard, none, none, q,
            torch.zeros(nq, dtype=torch.int32, device=cuda), 0, 3, (1, 0))
    before = (it.launches, mt.launches, mt.launches_stream)
    out = it.ingest_topk(*args)
    # One streaming masked_topk launch for the probe, one K1 launch for
    # the link lists; each wrapper counts its own.
    assert (it.launches - before[0], mt.launches - before[1],
            mt.launches_stream - before[2]) == (1, 1, 1)
    assert mt.route_for(torch.float32, nq, d) == "stream"
    s, r = mt.masked_topk(emb, alive, q, 1)
    torch.cuda.synchronize()
    assert torch.equal(out[1].long(), r)
    assert torch.equal(out[0], s), (out[0] - s).abs().max().item()
    # The link lists stay on the FMA stage: equal to the FMA route forced.
    fma = it._launch(*args, True, route="fma")
    for got, want in zip(out[2:], fma[2:]):
        assert torch.equal(got, want)


def test_ingest_scan_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    cols = ingest_arena(gen, 300, 32, torch.float32, cuda)
    q = grid(gen, (4, 32), torch.float32, cuda)
    qs = torch.zeros(4, dtype=torch.int32, device=cuda)
    none = torch.zeros(300, dtype=torch.bool, device=cuda)
    before = it.launches
    with pytest.raises(RuntimeError, match="wgmma"):       # f32 on the tensor cores
        it._launch(*cols, none, none, q, qs, 0, 3, (1, 0), True, route="wgmma")
    with pytest.raises(RuntimeError, match="fma"):         # bf16 on the FMA route
        it._launch(cols[0].bfloat16(), *cols[1:], none, none, q.bfloat16(), qs,
                   0, 3, (1, 0), True, route="fma")
    with pytest.raises(ValueError):
        it.ingest_topk(*cols, none, none, q, qs, 0, 129, (1, 0))
    with pytest.raises(ValueError):
        it.ingest_topk(*cols, none, none, q, qs, 0, 3, (1, 0, -1))
    assert it.launches == before


@pytest.mark.parametrize("b", [1, 7, 1000, 8192, 30_000])
def test_dedup_resolve_matches_plain_version(cuda, b):
    """The resolve kernel against its plain loop: dups of dups, probe and
    gram dups, padding, shard groups; 30,000 facts keep target and last in
    device memory instead of shared memory."""
    g = np.random.default_rng(b)
    n = max(1, b - b // 8)
    gs = g.uniform(-0.5, 1.0, b).astype(np.float32)
    ps = g.uniform(-0.5, 1.0, b).astype(np.float32)
    ps[g.random(b) < 0.05] = -1e30
    gj = np.minimum(g.integers(0, b, b), np.maximum(np.arange(b) - 1, 0))
    rows = np.where(np.arange(b) < n, g.permutation(10 * b)[:b], 10 * b)
    gid = np.where(np.arange(b) < n, g.integers(0, max(1, b // 50), b), -1)
    cols = [torch.from_numpy(x).to(cuda) for x in (
        gs, gj.astype(np.int32), ps, g.integers(0, 10 * b, b).astype(np.int32),
        rows < 10 * b, rows.astype(np.int32), gid.astype(np.int32))]
    before = dr.launches
    got = dr.dedup_resolve(*cols, 0.95, 10 * b)
    want = dr.dedup_resolve_reference(*[c.cpu() for c in cols], 0.95, 10 * b)
    torch.cuda.synchronize()
    assert dr.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    if b >= 1000:
        assert 0 < int(got[1].sum()) < b


def test_fused_ingest_syncs_only_at_the_readback(cuda, tmp_path):
    """A conversation end on the card: one fused dispatch (one ingest scan
    on the tensor cores, one resolve) and, under
    ``set_sync_debug_mode("error")``, no host wait but the one packed
    readback; the graph equals the classic ingest's."""
    from lazzaro_tpu_torch import MemoryConfig, MemorySystem

    def conversations(ms):
        for c in range(3):
            ms.start_conversation()
            for i in range(8):
                ms.add_to_short_term(f"I like topic {c % 2} number {i} a lot.",
                                     "semantic", 0.6)
            ms.end_conversation()

    # The third conversation end would consolidate (its own readback, held
    # by test_default_system_consolidates_through_one_launch_and_one_copy).
    kw = dict(enable_async=False, load_from_disk=False, verbose=False,
              device="cuda", auto_consolidate=False)
    ms = MemorySystem(db_dir=str(tmp_path / "f"),
                      config=MemoryConfig(dtype="bfloat16"), **kw)
    classic = MemorySystem(db_dir=str(tmp_path / "c"), config=MemoryConfig(
        dtype="bfloat16", ingest_fused=False, ingest_dedup_fused=False), **kw)
    index = ms.index
    ingest, readback = index.ingest_batch_dedup, index._readback
    readbacks = []

    def read_once(packed):
        torch.cuda.set_sync_debug_mode(0)
        try:
            readbacks.append(tuple(packed.shape))
            return readback(packed)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return ingest(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    index.ingest_batch_dedup, index._readback = strict, read_once
    try:
        before = (it.launches, it.launches_wgmma, dr.launches, mt.launches)
        conversations(ms)
        assert (it.launches - before[0], it.launches_wgmma - before[1],
                dr.launches - before[2], mt.launches - before[3]) == (3, 3, 3, 0)
        assert len(readbacks) == 3 and index.ingest_dispatch_count == 3
        del index.ingest_batch_dedup, index._readback
        conversations(classic)
        assert set(ms.buffer.nodes) == set(classic.buffer.nodes)
        assert set(index.edge_slots) == set(classic.index.edge_slots)
        q = "topic 1 number 3"
        assert ([n.id for n in ms.search_memories(q)]
                == [n.id for n in classic.search_memories(q)])
    finally:
        torch.cuda.set_sync_debug_mode(0)
        ms.close()
        classic.close()


# ------------------------------------------------------------------ K3
from lazzaro_tpu_torch.ops import graphops as gops  # noqa: E402


def pairwise_arena(gen, n, d, dtype, device):
    """Grid rows (exact sums) of two tenants with ~10% dead rows, and
    planted near-duplicates of unit norm: three identical rows (exact ties),
    groups of a base and up to six rows that each move one entry of it (a
    full list of 4), and copies at every offset across the diagonal of a
    64 x 128 tile (pairs (i, i + delta) for delta 1 .. 130)."""
    emb = grid(gen, (n, d), dtype, device)
    ten = torch.randint(0, 2, (n,), generator=gen, device=device).int()
    alive = torch.rand(n, generator=gen, device=device) < 0.9
    base = torch.zeros(d, device=device)
    base[:16] = 0.25
    rows = torch.randperm(n, generator=gen, device=device)
    take = 0

    def plant(r, v):
        emb[r] = v.to(dtype)
        ten[r], alive[r] = 0, True

    for g in range(min(8, n // 16)):
        members = rows[take:take + 7].sort().values
        take += 7
        for m, r in enumerate(members.tolist()):
            v = base.roll(g)
            if m:
                v[(g + m) % d] -= m / 64
            plant(r, v)
    if n > 8:
        tri = torch.zeros(d, device=device)
        tri[[1, 5, 9, 13]] = 0.5
        for r in rows[take:take + 3].tolist():
            plant(r, tri)
        take += 3
    for delta in range(1, 131):
        i = (delta * 37) % max(1, n - delta)
        if i + delta < n:
            v = torch.zeros(d, device=device)
            v[(delta % (d - 1)) + 1] = 1.0
            plant(i, v)
            plant(i + delta, v)
    mask = alive & (ten == 0)
    return emb, mask


def pairwise_both(emb, mask, thr=0.95, k=4, route=None):
    got = gops._launch(emb, mask, thr, k, route=route) if route else \
        gops.pairwise_merge_candidates(emb, mask, thr, k)
    want = gops.pairwise_merge_candidates_reference(emb, mask, thr, k)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 64), (63, 64), (129, 72), (4097, 64),
                                 (4097, 768), (131_072, 64)])
def test_pairwise_kernel_matches_plain_version(cuda, dtype, n, d):
    """K3 on the route the wrapper takes (tensor cores for bf16, FMA for
    f32): rows and scores bit for bit, ties to the lowest row, a full list,
    pairs across the diagonal at every offset, masked rows never listed."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    emb, mask = pairwise_arena(gen, n, d, dtype, cuda)
    before = (gops.launches, gops.launches_wgmma)
    s, r = pairwise_both(emb, mask)
    wg = int(dtype == torch.bfloat16)
    assert (gops.launches - before[0], gops.launches_wgmma - before[1]) == (1, wg)
    if n >= 4097:
        assert (r >= 0).all(dim=1).any()                      # a full list
        assert (r >= 0).sum() > 130
    assert not mask[r[r >= 0].long()].logical_not().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(600, 4), (1000, 8), (300, 1)])
def test_pairwise_kernel_under_heavy_contention(cuda, dtype, n, k):
    """A threshold every pair beats: each row lists its k best later rows
    out of hundreds of candidates, many of them exact ties (grid values),
    inserted by many blocks at once."""
    gen = torch.Generator(device=cuda).manual_seed(n * k)
    emb = grid(gen, (n, 64), dtype, cuda)
    emb[n // 2:] = emb[: n - n // 2]
    mask = torch.rand(n, generator=gen, device=cuda) < 0.8
    s, r = pairwise_both(emb, mask, thr=-10.0, k=k)
    live = mask.nonzero().view(-1)
    assert (r[live[:-k]] >= 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pairwise_kernel_corners(cuda, dtype):
    """An all-masked arena lists nothing; a mask of one tenant never pairs
    with the other's identical rows; the sentinel-like last row pairs like
    any other."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    n, d = 3000, 64
    emb = grid(gen, (n, d), dtype, cuda)
    emb[1500:] = emb[:1500]
    none = torch.zeros(n, dtype=torch.bool, device=cuda)
    s, r = pairwise_both(emb, none, thr=-10.0)
    assert (r == -1).all() and (s == -1e30).all()
    half = torch.arange(n, device=cuda) < 1500
    s, r = pairwise_both(emb, half, thr=-10.0)
    assert (r < 1500).all()
    v = torch.zeros(d, device=cuda)
    v[3] = 1.0
    emb[7], emb[n - 1] = v.to(dtype), v.to(dtype)
    s, r = pairwise_both(emb, torch.ones(n, dtype=torch.bool, device=cuda))
    assert r[7].tolist() == [n - 1, -1, -1, -1]


def test_pairwise_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    emb = grid(gen, (300, 32), torch.float32, cuda)
    mask = torch.ones(300, dtype=torch.bool, device=cuda)
    before = gops.launches
    with pytest.raises(RuntimeError, match="wgmma"):       # f32 on the tensor cores
        gops._launch(emb, mask, 0.95, 4, route="wgmma")
    with pytest.raises(RuntimeError, match="fma"):         # bf16 on the FMA route
        gops._launch(emb.bfloat16(), mask, 0.95, 4, route="fma")
    with pytest.raises(ValueError):
        gops.pairwise_merge_candidates(emb, mask, 0.95, k=9)
    with pytest.raises(ValueError):
        gops.pairwise_merge_candidates(emb, mask[:10], 0.95)
    assert gops.launches == before


def near_duplicate_dialogue(ms, words, convs=6):
    """Conversations of three facts, each a 30-word base with one more
    word (cosine ~0.97 to one another under the hashing embedder), and a
    chat turn that retrieves them and boosts their neighbours."""
    for c in range(convs):
        ms.start_conversation()
        base = " ".join(words[40 * c:40 * c + 30])
        for extra in range(3):
            ms.add_to_short_term(f"{base} {words[40 * c + 30 + extra]}",
                                 "semantic", 0.6)
        ms.chat(f"What about {words[40 * c]} {words[40 * c + 1]}?")
        ms.end_conversation()


def test_default_system_consolidates_through_one_launch_and_one_copy(cuda, tmp_path):
    """``MemorySystem()`` as configured by default (f32 arena, fused
    serving and ingest, ``auto_consolidate`` every 3 conversations) on the
    card: conversations 3 and 6 each consolidate through one K3 launch on
    the FMA route and, under ``set_sync_debug_mode("error")``, no host wait
    but the one packed readback of the pair lists."""
    from lazzaro_tpu_torch import MemorySystem

    ms = MemorySystem(enable_async=False, load_from_disk=False, verbose=False,
                      db_dir=str(tmp_path))
    index = ms.index
    merge, readback = index.merge_candidates, index._readback
    readbacks = []

    def read_once(packed):
        torch.cuda.set_sync_debug_mode(0)
        try:
            readbacks.append(tuple(packed.shape))
            return readback(packed)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        index._readback = read_once
        try:
            return merge(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            index._readback = readback

    index.merge_candidates = strict
    words = [f"zq{i}x" for i in range(400)]
    try:
        before = (gops.launches, gops.launches_wgmma)
        near_duplicate_dialogue(ms, words)
        torch.cuda.synchronize()
        assert (gops.launches - before[0], gops.launches_wgmma - before[1]) == (2, 0)
        assert [r[1] for r in readbacks] == [8, 8]
        assert ms.conversation_count == 6
    finally:
        torch.cuda.set_sync_debug_mode(0)
        ms.close()


def test_consolidation_merges_on_the_card_alike_on_both_ingests(cuda, tmp_path):
    """With the dedup gate (0.99) above the merge gate (0.95) the
    near-duplicates arrive as nodes, and the consolidations at conversations
    3 and 6 merge them on the card: the merge loop's arena writes
    (``add_edges``, ``merge_touch``, ``delete``), the refresh of the host
    copies after it, and chat turns over the merged graph. The fused and
    the classic ingest end with the same nodes, contents, edges, saliences
    and profile."""
    from lazzaro_tpu_torch import MemoryConfig, MemorySystem

    words = [f"zq{i}x" for i in range(400)]
    states = []
    for flags in ({}, {"ingest_fused": False, "ingest_dedup_fused": False}):
        ms = MemorySystem(enable_async=False, load_from_disk=False,
                          verbose=False, db_dir=str(tmp_path / str(len(states))),
                          max_buffer_size=1000, config=MemoryConfig(
                              dedup_similarity=0.99, **flags))
        results = []
        inner = ms.run_consolidation
        ms.run_consolidation = lambda *a, **k: results.append(inner(*a, **k)) or results[-1]
        try:
            before = gops.launches
            near_duplicate_dialogue(ms, words)
            assert len(results) == 2 and all("Merged" in r for r in results)
            assert gops.launches - before == 2
            states.append((results,
                           {nid: (n.content, round(n.salience, 6))
                            for nid, n in ms.buffer.nodes.items()},
                           {k: round(e.weight, 6) for k, e in ms.buffer.edges.items()},
                           dict(ms.profile.data)))
        finally:
            ms.close()
    assert states[0] == states[1]
    assert sum(" | " in c for c, _ in states[0][1].values()) >= 4
