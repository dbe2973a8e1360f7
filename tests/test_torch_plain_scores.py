"""The plain scans' scores on the CPU: a pair's score is a function of its
query and its row alone.

The port's plain versions (``ops.chunking.nt_dot`` and every plain arena
scan built on it: ``ops.topk.masked_topk``, ``ops.ingest_topk.
ingest_topk_reference``, the fused and the sharded plain paths) must score a
row with the same bits whether it sits in a whole arena or in one of its
shards, at any offset, and whatever number of queries the batch holds. A
row-sharded ``MemorySystem`` and the single-device one place reloaded rows
in an order that follows Python's set iteration (so the hash seed), and they
are held equal record for record; with a blocked CPU matrix product the
same pair rounded differently in another slice, and the dialogue diverged
under some hash seeds. Every comparison here is bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lazzaro_tpu_torch.ops import ingest_topk as it
from lazzaro_tpu_torch.ops.chunking import nt_dot
from lazzaro_tpu_torch.ops.topk import masked_topk

REPO = Path(__file__).resolve().parents[1]


def unit_rows(seed, n, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


def bits(x):
    return x.contiguous().view(torch.int32)


# Row slices: 8 shards of 9, a one-row offset, single rows, ragged ranges.
SLICES = ([(9 * p, 9 * p + 9) for p in range(8)]
          + [(1, 72), (0, 71), (5, 6), (71, 72), (13, 50)])


@pytest.mark.parametrize("d", [64, 768])
def test_a_pair_scores_alike_at_every_position_slice_and_batch(d):
    rows, qs = unit_rows(d, 72, d), unit_rows(d + 1, 16, d)
    whole = bits(nt_dot(qs, rows))
    for nq in (1, 2, 5, 16):
        for lo, hi in SLICES:
            got = bits(nt_dot(qs[:nq], rows[lo:hi]))
            assert torch.equal(got, whole[:nq, lo:hi]), (nq, lo, hi)
        # the same queries at another place in the batch
        got = bits(nt_dot(qs[16 - nq:], rows))
        assert torch.equal(got, whole[16 - nq:]), nq
    # bf16 rows are widened exactly: the same bits as their f32 copy
    r16, q16 = rows.bfloat16(), qs.bfloat16()
    assert torch.equal(bits(nt_dot(q16[:5], r16[13:50])),
                       bits(nt_dot(q16.float(), r16.float()))[:5, 13:50])


@pytest.mark.parametrize("nq, n, d", [(16, 600, 768), (512, 700, 32), (3, 2000, 64)])
def test_chunked_cpu_dot_equals_one_reduction(nq, n, d):
    """Past ``CPU_DOT_ROWS`` rows and ``CPU_DOT_ELEMS`` products the CPU
    form walks row chunks and query groups; each score keeps the bits of
    the pair's products summed over d in one reduction."""
    rows, qs = unit_rows(n + d, n, d), unit_rows(nq + d, nq, d)
    want = (qs[:, None, :] * rows[None]).sum(-1)
    assert torch.equal(bits(nt_dot(qs, rows)), bits(want))
    for lo, hi in ((0, 1), (255, 257), (n - 3, n)):
        assert torch.equal(bits(nt_dot(qs[lo % nq:], rows[lo:hi])),
                           bits(want[lo % nq:, lo:hi])), (lo, hi)


def test_plain_scans_score_a_shard_as_the_whole_arena():
    """``masked_topk``'s and the ingest scan's plain versions on 8 shards of
    9 rows list each shard's rows with the scores the whole arena gives
    them."""
    d = 64
    rows, qs = unit_rows(7, 72, d), unit_rows(8, 5, d)
    alive = torch.ones(72, dtype=torch.bool)
    ws, wr = masked_topk(rows, alive, qs, 72)
    whole = {(q, int(r)): s for q in range(5)
             for s, r in zip(bits(ws[q]).tolist(), wr[q].tolist())}
    zeros = torch.zeros(9, dtype=torch.int32)
    none = torch.zeros(9, dtype=torch.bool)
    for p in range(8):
        shard = rows[9 * p:9 * p + 9]
        s, r = masked_topk(shard, alive[:9], qs, 9)
        for q in range(5):
            for sc, row in zip(bits(s[q]).tolist(), r[q].tolist()):
                assert sc == whole[(q, 9 * p + row)]
        out = it.ingest_topk_reference(
            shard, alive[:9], zeros, none, zeros, none, none, qs,
            torch.zeros(5, dtype=torch.int32), 0, 9, (0,))
        for q in range(5):
            assert bits(out[0][q]).item() == whole[(q, 9 * p + int(out[1][q]))]
            for sc, row in zip(bits(out[2][q]).tolist(), out[3][q].tolist()):
                assert sc == whole[(q, 9 * p + row)]


def test_mesh_dialogue_equals_one_device_under_a_hash_seed_that_diverged():
    """``PYTHONHASHSEED=5`` reordered the reload's rows so that the 8-shard
    dialogue and the single-device one scored a pair one ulp apart (and a
    0.0 against -1.3e-9), which reordered a ranking. The equality test of
    ``test_torch_mesh_system.py`` runs again in a process with that seed."""
    env = dict(os.environ, PYTHONHASHSEED="5", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "tests/test_torch_mesh_system.py",
         "-k", "equals_the_single_device_run"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    assert "2 passed" in proc.stdout, proc.stdout[-2000:]
