"""The port's version of ``tests/test_multi_tenant.py``: tenancy as an arena
column masked inside every scan. The JAX file runs 1,000 tenants x 100 rows
in its slow lane; here the index holds 200 tenants x 100 rows and the
system 40 users, so the tier-1 CPU lane finishes in seconds. Isolation of
search (single and batched, exact and int8), per-tenant eviction, decay
scoped to one tenant, and ``switch_user`` / ``get_all_users``."""

import numpy as np
import pytest

from lazzaro_tpu_torch import MemorySystem
from lazzaro_tpu_torch.config import MemoryConfig
from lazzaro_tpu_torch.core.index import MemoryIndex

N_TENANTS = 200
ROWS_PER_TENANT = 100
DIM = 64


def _build_index(int8):
    rng = np.random.default_rng(0)
    idx = MemoryIndex(dim=DIM, capacity=N_TENANTS * ROWS_PER_TENANT + 64,
                      edge_capacity=1024, int8_serving=int8, device="cpu")
    for t in range(N_TENANTS):
        emb = rng.standard_normal((ROWS_PER_TENANT, DIM)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        n = ROWS_PER_TENANT
        idx.add([f"t{t}:m{i}" for i in range(n)], emb, [0.5] * n, [0.0] * n,
                ["semantic"] * n, ["default"] * n, f"user{t}")
    return idx


@pytest.mark.parametrize("int8", [False, True])
def test_many_tenant_isolation_eviction_decay(int8):
    idx = _build_index(int8)
    assert len(idx._tenants) == N_TENANTS
    rng = np.random.default_rng(1)
    sample = rng.integers(0, N_TENANTS, size=25)
    for t in sample.tolist():
        other = (t + 1) % N_TENANTS
        q = idx.state.emb[idx.id_to_row[f"t{other}:m0"]].numpy()
        ids, _ = idx.search(q, f"user{t}", k=5)
        assert ids and all(i.startswith(f"t{t}:") for i in ids)
    qs = idx.state.emb[np.asarray([idx.id_to_row[f"t7:m{i}"]
                                   for i in range(8)])].numpy()
    for ids, _ in idx.search_batch(qs, "user7", k=3):
        assert ids and all(i.startswith("t7:") for i in ids)
    for t in sample[:5].tolist():
        cands = idx.evict_candidates(f"user{t}", k=7)
        assert cands and all(nid.startswith(f"t{t}:") for nid, _ in cands)
    r3 = [idx.id_to_row[f"t3:m{i}"] for i in range(5)]
    r4 = [idx.id_to_row[f"t4:m{i}"] for i in range(5)]
    before = idx.state.salience.numpy().copy()
    idx.decay("user3", rate=0.1)
    after = idx.state.salience.numpy()
    assert (after[r3] < before[r3]).all()
    np.testing.assert_array_equal(after[r4], before[r4])


def test_system_many_users_switch_and_enumerate(tmp_path):
    n_users = 40
    ms = MemorySystem(enable_async=False, db_dir=str(tmp_path / "db"),
                      verbose=False, load_from_disk=False, device="cpu",
                      config=MemoryConfig(journal=False))
    first = ms.user_id
    for u in range(n_users):
        ms.switch_user(f"user{u}")
        ms.start_conversation()
        ms.add_to_short_term(f"user {u} owns artifact number {u}",
                             "semantic", 0.8)
        ms.end_conversation()
    users = ms.get_all_users()
    assert len([u for u in users if u.startswith("user")]) == n_users
    for u in (0, 19, 39):
        ms.switch_user(f"user{u}")
        hits = ms.search_memories(f"artifact number {u}")
        assert hits, f"user{u} lost their graph"
        assert all(f"user {u} " in n.content for n in hits)
    ms.switch_user(first)
    ms.close()
