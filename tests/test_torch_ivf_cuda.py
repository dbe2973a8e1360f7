"""K5, the IVF candidate scan, on the card against its plain version, and
the IVF serving paths of ``MemoryIndex`` on the card.

Marked ``cuda``: these tests need an NVIDIA GPU with ``nvcc`` and skip
elsewhere. Run them on the card with

    python -m pytest -m cuda tests/test_torch_ivf_cuda.py

Arena rows and queries are mostly small multiples of 1/256, so every
product and sum is exact in f32 and exact ties are common; the kernel must
agree with the plain version bit for bit. On Gaussian data too: the plain
version sums each pair in the kernel's order (``K5.lane_dot``). The int8
form's scores are exact at any input (int32 dots, then the same two f32
products).
"""

import numpy as np
import pytest
import torch

from lazzaro_tpu_torch.core.index import MemoryIndex
from lazzaro_tpu_torch.ops import ivf_topk as K5
from lazzaro_tpu_torch.ops import masked_topk as mt
from lazzaro_tpu_torch.ops.quant import quantize_rows
from lazzaro_tpu_torch.serve import RetrievalRequest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def grid(gen, shape, dtype, device):
    x = torch.randn(shape, generator=gen, device=device)
    return (torch.round(x * 16) / 256).to(dtype)


def gauss(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def fixture(cuda, dtype, n, d, c, m, e, p, nq, seed, values=grid):
    """An arena with three tenants, ~3% super rows, ~10% dead rows and
    exact duplicates; member tables filled to a random prefix (-1 after);
    extras that repeat member rows and hold every super row; each query's
    ``p`` clusters. ``values`` draws the rows and the queries."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    emb = values(gen, (n, d), dtype, cuda)
    emb[n // 2:n // 2 + 40] = emb[:40]
    alive = torch.rand(n, generator=gen, device=cuda) < 0.9
    tenant = torch.randint(0, 3, (n,), generator=gen, device=cuda,
                           dtype=torch.int32)
    sup = torch.rand(n, generator=gen, device=cuda) < 0.03
    perm = torch.randperm(n, generator=gen, device=cuda).int()
    members = torch.full((c, m), -1, dtype=torch.int32, device=cuda)
    fill = torch.randint(m // 4, m + 1, (c,), generator=gen, device=cuda)
    take = torch.arange(m, device=cuda)[None, :] < fill[:, None]
    flat = perm[:c * m].reshape(c, m) % n
    members = torch.where(take, flat, members)
    sup_rows = torch.nonzero(sup).flatten().int()
    extras = torch.full((e,), -1, dtype=torch.int32, device=cuda)
    rest = torch.cat([members[0, :8], sup_rows])[:e - 4]
    extras[:len(rest)] = rest
    cids = torch.stack([torch.randperm(c, generator=gen, device=cuda)[:p]
                        for _ in range(nq)]).int()
    q = values(gen, (nq, d), dtype, cuda)
    q[0] = emb[int(members[int(cids[0, 0]), 0])]
    q_ten = torch.randint(0, 3, (nq,), generator=gen, device=cuda,
                          dtype=torch.int32)
    npq = torch.randint(1, p + 1, (nq,), generator=gen, device=cuda,
                        dtype=torch.int32)
    return emb, (alive, tenant, sup), members, extras, cids, q, q_ten, npq


def equal(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert torch.equal(g, w), (g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,k,ragged", [(1, 10, False), (1, 136, True),
                                         (64, 136, True), (64, 10, False),
                                         (5, 300, True), (3, 700, False)])
def test_exact_form_matches_plain_version(cuda, dtype, nq, k, ragged):
    emb, cols, members, extras, cids, q, q_ten, npq = fixture(
        cuda, dtype, 20_000, 64, 64, 256, 64, 8, nq, nq + k)
    qd = q.float()
    before = K5.launches
    kw = dict(g=1, cols=cols, q_tenant=q_ten,
              nprobe_q=npq if ragged else None)
    got = K5.ivf_topk(emb, members, extras, cids, qd, k, **kw)
    want = K5.ivf_topk_reference(emb, members, extras, cids, qd, k, **kw)
    torch.cuda.synchronize()
    assert K5.launches == before + 1
    equal(got, want)


@pytest.mark.parametrize("nq,k,g", [(1, 136, 9), (64, 136, 9), (7, 300, 300)])
@pytest.mark.parametrize("d", [64, 100, 768])
def test_int8_form_matches_plain_version(cuda, nq, k, g, d):
    emb, cols, members, extras, cids, q, q_ten, npq = fixture(
        cuda, torch.float32, 20_000, d, 64, 256, 64, 8, nq, d + nq)
    shadow = quantize_rows(emb)
    qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    before = K5.launches_int8
    kw = dict(g=g, cols=cols, q_tenant=q_ten, nprobe_q=npq)
    got = K5.ivf_topk(shadow, members, extras, cids, qn, k, **kw)
    want = K5.ivf_topk_reference(shadow, members, extras, cids, qn, k, **kw)
    torch.cuda.synchronize()
    assert K5.launches_int8 == before + 1
    equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,k", [(1, 18), (64, 18), (9, 400)])
def test_classic_form_matches_plain_version(cuda, dtype, nq, k):
    emb, cols, members, extras, cids, q, _, _ = fixture(
        cuda, dtype, 20_000, 64, 64, 256, 64, 8, nq, 7 * nq + k)
    mask = cols[0] & (cols[1] == 1)
    before = K5.launches_classic
    got = K5.ivf_topk(emb, members, extras, cids, q.float(), k, mask=mask)
    want = K5.ivf_topk_reference(emb, members, extras, cids, q.float(), k,
                                 mask=mask)
    torch.cuda.synchronize()
    assert K5.launches_classic == before + 1
    equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["exact", "classic"])
@pytest.mark.parametrize("d,nq", [(64, 64), (264, 5), (768, 1), (768, 64)])
def test_gaussian_data_matches_plain_version(cuda, dtype, form, d, nq):
    """Rows and queries drawn from a Gaussian, whose f32 sums round: the
    kernel and the plain version still agree bit for bit, because both sum
    each pair in one order (``K5.lane_dot``)."""
    emb, cols, members, extras, cids, q, q_ten, npq = fixture(
        cuda, dtype, 20_000, d, 64, 256, 64, 8, nq, 11 * d + nq, values=gauss)
    qd = q.float()
    if form == "exact":
        kw = dict(g=1, cols=cols, q_tenant=q_ten, nprobe_q=npq)
    else:
        kw = dict(mask=cols[0] & (cols[1] == 1))
    got = K5.ivf_topk(emb, members, extras, cids, qd, 136, **kw)
    want = K5.ivf_topk_reference(emb, members, extras, cids, qd, 136, **kw)
    torch.cuda.synchronize()
    equal(got, want)


def test_a_tenant_with_few_candidates_fills_by_position(cuda):
    """A query whose tenant holds two valid candidates: the rest of each
    list is the lowest other positions at -1e30, with their slots' rows."""
    emb, cols, members, extras, cids, q, q_ten, _ = fixture(
        cuda, torch.bfloat16, 4_096, 64, 16, 64, 16, 4, 4, 5)
    alive, tenant, sup = cols
    tenant = torch.full_like(tenant, 2)
    tenant[members[cids[0, 0], :2].long()] = 7
    q_ten = torch.full_like(q_ten, 7)
    kw = dict(g=3, cols=(alive, tenant, torch.zeros_like(sup)), q_tenant=q_ten)
    got = K5.ivf_topk(emb, members, extras, cids, q.float(), 40, **kw)
    want = K5.ivf_topk_reference(emb, members, extras, cids, q.float(), 40,
                                 **kw)
    equal(got, want)
    assert (got[0][0, 2:] == -1e30).all()


def sparse_fixture(cuda, dtype, nq, d, seed, values=gauss):
    """Tables as K5's callers pass them, with their occupancy: of 64
    clusters of 256 slots, every fourth empty (occ 0), every fourth full
    (occ = M), the rest a sparse prefix of 1 to 64 rows; each query probes 8
    of them, every kind among them, and ``nprobe_q`` leaves ranks unprobed;
    the extras a packed prefix (``n_extras``) of member rows again and every
    super row."""
    emb, cols, members, extras, cids, q, q_ten, npq = fixture(
        cuda, dtype, 20_000, d, 64, 256, 64, 8, nq, seed, values=values)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    c, m = members.shape
    kind = torch.arange(c, device=cuda) % 4
    occ = torch.where(kind == 0, 0, torch.where(
        kind == 1, m, torch.randint(1, 65, (c,), generator=gen, device=cuda)))
    perm = torch.randperm(20_000, generator=gen, device=cuda).int()
    slots = torch.arange(m, device=cuda)[None, :]
    members = torch.where(slots < occ[:, None],
                          perm[:c * m].reshape(c, m), -1).int().contiguous()
    occ = occ.int()
    n_extras = int((extras >= 0).sum())
    cids = torch.stack([torch.cat([torch.tensor([4 * i % c, 4 * i % c + 1],
                                                device=cuda),
                                   torch.randperm(c, generator=gen,
                                                  device=cuda)[:6]])
                        for i in range(nq)]).int()
    # (a cluster may come twice in a query's list: the scan takes it twice)
    return emb, cols, members, extras, cids, q, q_ten, npq, occ, n_extras


def run_both(rows, members, extras, cids, qv, k, **kw):
    """The kernel and the plain version on one input; the launches and the
    card's kernels a call."""
    before = (K5.launches, K5.stage_launches)
    got = K5.ivf_topk(rows, members, extras, cids, qv, k, **kw)
    want = K5.ivf_topk_reference(rows, members, extras, cids, qv, k, **kw)
    torch.cuda.synchronize()
    equal(got, want)
    return K5.launches - before[0], K5.stage_launches - before[1], got


@pytest.mark.parametrize("nq", [1, 8, 64])
@pytest.mark.parametrize("form,dtype", [("exact", torch.bfloat16),
                                        ("exact", torch.float32),
                                        ("int8", torch.float32),
                                        ("classic", torch.bfloat16),
                                        ("classic", torch.float32)])
def test_occupied_walk_matches_plain_version(cuda, form, dtype, nq):
    """The walk over the occupied slots only (sparse, full and empty
    clusters among the probed, unprobed ranks, packed extras) gives the
    plain version's scores, positions and rows to the bit, in one pass of
    two card launches."""
    emb, cols, members, extras, cids, q, q_ten, npq, occ, n_ex = \
        sparse_fixture(cuda, dtype, nq, 768, 31 * nq + len(form))
    occ_kw = dict(occ=occ, n_extras=n_ex)
    if form == "classic":
        launched, stages, _ = run_both(emb, members, extras, cids, q.float(),
                                       18, mask=cols[0] & (cols[1] == 1),
                                       **occ_kw)
    elif form == "int8":
        qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        launched, stages, _ = run_both(quantize_rows(emb), members, extras,
                                       cids, qn, 136, g=9, cols=cols,
                                       q_tenant=q_ten, nprobe_q=npq, **occ_kw)
    else:
        launched, stages, _ = run_both(emb, members, extras, cids, q.float(),
                                       136, g=1, cols=cols, q_tenant=q_ten,
                                       nprobe_q=npq, **occ_kw)
    assert (launched, stages) == (1, 2)


@pytest.mark.parametrize("d", [64, 100])
def test_int8_occupied_walk_at_narrow_widths(cuda, d):
    """The int8 form's ring at a width of 16-byte chunks (64) and one whose
    last chunk is partial (100, 4-byte copies with the tail zero-filled)."""
    emb, cols, members, extras, cids, q, q_ten, npq, occ, n_ex = \
        sparse_fixture(cuda, torch.float32, 8, d, d)
    qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    run_both(quantize_rows(emb), members, extras, cids, qn, 136, g=9,
             cols=cols, q_tenant=q_ten, nprobe_q=npq, occ=occ, n_extras=n_ex)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fill_runs_past_the_occupied_prefix(cuda, dtype):
    """Every query probes a cluster of 5 occupied slots first, two of them
    its tenant's rows, and k = 40, g = 3: the fill is the lowest other
    positions, which run through that cluster's other occupied slots
    (other tenants' rows, never scored) into the tail the walk skips
    (rows -1): positions and rows from the positions alone."""
    emb, cols, members, extras, cids, q, q_ten, npq, occ, n_ex = \
        sparse_fixture(cuda, dtype, 4, 64, 5)
    alive, tenant, sup = cols
    used = torch.zeros(emb.shape[0], dtype=torch.bool, device=cuda)
    used[members[members >= 0].long()] = True
    used[extras[extras >= 0].long()] = True
    members[2] = -1
    members[2, :5] = torch.nonzero(~used).flatten()[:5].int()
    occ[2] = 5
    cids[:, 0] = 2
    tenant = torch.full_like(tenant, 2)
    mine = members[2, :2].long()
    tenant[mine] = 7
    alive = alive.clone()
    alive[mine] = True
    q_ten = torch.full_like(q_ten, 7)
    kw = dict(g=3, cols=(alive, tenant, torch.zeros_like(sup)), q_tenant=q_ten,
              occ=occ, n_extras=n_ex)
    _, _, got = run_both(emb, members, extras, cids, q.float(), 40, **kw)
    ann_s, ann_p, ann_r, _, gate_p, gate_r = got
    assert (ann_s[:, 2:] == -1e30).all()
    assert (ann_p[:, 2:] == torch.arange(2, 40, device=cuda)).all()
    assert (ann_r[:, 2:5] == members[2, 2:5]).all()
    assert (ann_r[:, 5:] == -1).all()
    assert (gate_p == torch.arange(3, device=cuda)).all()
    assert (gate_r == members[2, :3]).all()


@pytest.mark.parametrize("form", ["exact", "classic"])
@pytest.mark.parametrize("k", [300, 700])
def test_lists_past_a_pass_with_the_walk(cuda, form, k):
    """Lists longer than a pass (256) run in passes of two card launches
    each; a later pass admits only keys after the last one, the fill's
    positions too, with the skipped tails and unprobed ranks among them."""
    emb, cols, members, extras, cids, q, q_ten, npq, occ, n_ex = \
        sparse_fixture(cuda, torch.bfloat16, 5, 64, k)
    if form == "classic":
        kw = dict(mask=cols[0] & (cols[1] == 1))
    else:
        kw = dict(g=260, cols=cols, q_tenant=q_ten, nprobe_q=npq)
    launched, stages, got = run_both(emb, members, extras, cids, q.float(), k,
                                     occ=occ, n_extras=n_ex, **kw)
    assert (launched, stages) == (1, 2 * -(-k // 256))
    assert (got[0][:, -1] == -1e30).any()        # lists that run into the fill


def test_occupancy_contract_is_checked_by_the_plain_version(cuda):
    """A row past its cluster's occupancy breaks the contract the kernel
    relies on: the plain version refuses it."""
    emb, cols, members, extras, cids, q, q_ten, npq, occ, n_ex = \
        sparse_fixture(cuda, torch.float32, 2, 64, 9)
    bad = members.clone()
    c = int(torch.nonzero(occ == 0)[0, 0])
    bad[c, 3] = 5
    with pytest.raises(ValueError):
        K5.ivf_topk_reference(emb, bad, extras, cids, q.float(), 10,
                              mask=cols[0], occ=occ, n_extras=n_ex)


def test_refusals_raise(cuda):
    """The wrapper raises where the kernel takes no such scan: a width that
    is no multiple of 8 (exact) or 4 (int8), k past L."""
    emb, cols, members, extras, cids, q, q_ten, _ = fixture(
        cuda, torch.float32, 4_096, 64, 16, 64, 16, 4, 2, 6)
    with pytest.raises(ValueError):
        K5.ivf_topk(emb, members, extras, cids, q, 4 * 64 + 16 + 1, g=1,
                    cols=cols, q_tenant=q_ten)
    with pytest.raises(ValueError):
        K5.ivf_topk(emb[:, :60].contiguous(), members, extras, cids,
                    q[:, :60].contiguous(), 5, g=1, cols=cols, q_tenant=q_ten)


def test_index_serves_ivf_on_the_card(cuda):
    """A published build on the card: the classic search takes K5's classic
    form, a chat batch one K5 launch (the coarse stage one masked top-k
    launch), fused reads equal the classic IVF search on an f32 arena, and
    ``nprobe = C`` lists the exact rows."""
    rng = np.random.default_rng(0)
    n, d = 6000, 64
    cent = rng.standard_normal((40, d)).astype(np.float32)
    emb = cent[rng.integers(0, 40, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    idx = MemoryIndex(dim=d, capacity=n + 64, ivf_nprobe=8)
    idx.add([f"m{i}" for i in range(n)], emb, [0.5] * n, [0.0] * n,
            ["semantic"] * n, ["default"] * n, "u0")
    assert idx.ivf_maintenance()
    c0, m0 = K5.launches_classic, mt.launches
    (ids, _), = idx.search_batch(emb[3:4], "u0", k=5)
    assert ids[0] == "m3"
    assert K5.launches_classic == c0 + 1 and mt.launches == m0 + 1
    before = K5.launches
    reqs = [RetrievalRequest(query=emb[i], tenant="u0", k=10, boost=True,
                             nprobe=1 + i % 8) for i in range(16)]
    res = idx.search_fused_requests(reqs, cap_take=5, max_nbr=8,
                                    super_gate=0.4, acc_boost=0.05,
                                    nbr_boost=0.02)
    torch.cuda.synchronize()
    assert K5.launches == before + 1
    assert all(r.ids[0] == f"m{i}" for i, r in enumerate(res))
    # f32 arena: the fused reads and the classic IVF search of the same
    # queries score alike (the query cast to f32 either way): equal rows
    reads = idx.search_fused_requests(
        [RetrievalRequest(query=emb[i], tenant="u0", k=10) for i in range(16)],
        cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05, nbr_boost=0.02)
    classic = idx.search_batch(emb[:16], "u0", k=10, super_filter=-1)
    assert [r.ids for r in reads] == [ids for ids, _ in classic]
    idx.ivf_nprobe = idx._ivf.n_clusters
    full = idx.search_fused_requests(
        [RetrievalRequest(query=emb[i], tenant="u0", k=10) for i in range(8)],
        cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05, nbr_boost=0.02)
    exact = idx.search_batch(emb[:8], "u0", k=10, exact=True)
    for r, (ids, _) in zip(full, exact):
        assert set(r.ids) == set(ids)
