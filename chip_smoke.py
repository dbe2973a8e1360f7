#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lazzaro_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi) and torch's name;
  2. build    every ``lazzaro_tpu_torch/csrc/*.cu`` with nvcc, all at once;
  3. kernels  each kernel, in every call form, against its plain PyTorch
              version on the card, at every shape the main paths give it and
              at edge cases, with times and bounds (the top-k scans on the
              route the wrapper takes, on bf16, on the default f32 arena
              and on a 3,072-wide f32 one, the FMA route also forced at
              small Q, then the cross-shard merge, and
              ``make_sharded_topk`` and the keyed grouped scan over 8
              shards with their launches a call, the flash-attention
              forward and its dQ and dK/dV backward kernels at the decoder's
              shapes, K4 (the int8 scan of quantized serving) in its keyed
              and additive forms over the int8 shadow of the 1,048,576-row
              arena (a list past 256 too), over a 131,072 x 1,536 shadow,
              and on the dp4a stage forced, each row naming the route its
              launch took; K5 (the IVF candidate scan) in its exact form over
              bf16 and f32 arenas at Q = 1 and 64 with per-query nprobe
              (1, 4, 8), its int8 form and its classic form, on member
              tables of phase 4's build geometry (1,024 clusters of 2,048
              slots) and Gaussian queries; times are device times from
              ``torch.profiler``, the top-k scans' split into stage 1 and
              the merge, event times of back-to-back calls beside them,
              the flash kernels' achieved
              TFLOP/s and share of the bound); then the state dispatch
              guard on two twin 20,000-row indexes (a transient fault
              retried to bit-parity, a poisoned index raising
              ``ArenaPoisoned`` on every touch and recovered by
              ``load_index``);
  4. main     ``MemorySystem`` on a bf16 768-d arena of 1,048,576 rows, its
              ``ArrowStore`` and journals under a temporary directory
              (every phase's are; removed at the end). The
              classic path: fill it through ``end_conversation`` with
              ``FILL`` facts (3/8 of the arena: 8,192 per conversation, two
              tenants in blocks, each conversation end saving to the store,
              a near-duplicate every 101 facts), then ``switch_user`` back to
              the first tenant, which reloads her ~195k rows from the store
              onto the card (seconds by part, the served top-k held to the
              one before), then chat turns, one more
              conversation end and ``search_memories`` for facts whose answer
              is known; the masked top-k kernel is then held against its
              plain version on the filled arena. The fused path on the same
              system (``serve_fused=True``): chat turns that miss and that
              hit the super-node gate, ``search_memories`` and 64-query
              batches, each dispatch one two-tier kernel launch and one
              device-to-host copy. Each path's kernel launches are counted
              from 0 over that path alone. After its 34th conversation the
              phase records, without boosting or counting, what the mesh
              phase must reproduce. Every dedup probe of the fill must
              scan on the tensor-core route. Then one ``run_consolidation``,
              one all-tenant ``lifecycle_sweep`` (one dispatch, one copy)
              held bit-equal to the classic per-tenant loop on a twin of
              the states, with its kernels, copies, device ms and bytes
              bound beside the loop's, and ``save_index`` / ``load_index``
              of the filled index: every column bit-equal, the same
              classic and fused reads, seconds, bytes and peak memory; then
              that checkpoint loaded again with ``int8_serving=True`` in the
              system's place: 8 chat turns, 8 searches, a 64-query batch and
              a 64-request fleet, each dispatch one K4 keyed launch (on the
              tensor cores) and one copy, one transient ``index.dispatch`` fault retried, a
              classic search on K4's additive form, recall@10 and scores
              against the exact reads, p50s beside the exact ones; then the
              same index with ``ivf_serving = 8``: ``ivf_maintenance``
              (timed), recall@10 against the exact reads, ``nprobe = C``
              against exact, the fused reads against the classic
              ``ivf_search``, 8 chat turns, 8 searches, a 64-query batch
              and a 64-request fleet with per-request nprobe, each
              dispatch one K5 launch and one copy, one conversation end
              through the fused dedup ingest with online IVF (one
              dispatch, one copy, appends and overflows), 4 chat turns
              with int8 serving composed;
  4c. default ``MemorySystem()`` as configured by default (f32, the store and
              both journals): nine conversations consolidating three times,
              each conversation end's ingest, merge scan and saves under
              sync debug mode "error"; a restart that must give the same
              rankings, profile and salience bits; a crash whose turns and
              uncommitted fact batch the next start replays through the
              fused ingest on the card; the fused and classic ingests held
              equal on the same dialogue; every K1 launch of the phase one
              pass on the streaming stage, no ``masked_topk`` launch in
              the fused ingest; ``save_snapshot`` / ``load_snapshot`` into
              a ``lifecycle_fused=False`` system that must serve the same,
              then two ``lifecycle_tick(force=True)`` on each, equal; then
              the nine-conversation dialogue with ``int8_serving=True``,
              every chat turn one K4 launch, the shadow equal to
              ``quantize_rows`` of the arena at every conversation end;
  4b. mesh    the same path on ``MemorySystem(mesh=...)``: the same arena
              row-sharded over 8 shards (one per card when the cards divide
              8, else all on ``cuda:0``), filled for 34 conversations
              (278,528 facts) and held equal to phase 4's record (counts,
              ``search_batch`` ids and scores, fused gate verdicts and ids),
              then classic and fused serving as in phase 4, every search one
              grouped scan per card (a stage 1 and a stage 2 a pass; the
              merge kernel only past one card), every fused dispatch one
              grouped two-tier scan per card and one device-to-host copy,
              the routes taken printed; ``make_sharded_topk`` on the filled
              arena against one scan of the whole arena and its plain
              version; one mesh ``lifecycle_sweep`` (one merge launch)
              against a one-device sweep of the same rows;
  5. lm       the decoder LM at full width (``LMConfig()``: 18 layers, hidden
              2048, 8 query and 2 kv heads of 256, ~1.1 B parameters, bf16,
              random weights from a seed): ``logits_for`` on a 2,047-token
              text through the flash kernel against the same weights'
              materialized-scores path, then ``MemorySystem`` with
              ``OnDeviceLLM`` serving chat turns (KV-cache decoding) and one
              ``end_conversation`` whose extraction runs the on-device
              constrained JSON loop, then a search. Flash launches are
              counted from 0 over this phase;
  6. train    the same decoder at full width trained with AdamW (optax's
              adamw defaults) on one B=2, T=2,048 batch of byte-tokenized
              text: one step's loss and gradients through flash against the
              materialized-scores path, then ``TRAIN_STEPS`` steps through
              ``make_train_step`` (18 forward and 36 backward kernel
              launches each, counted from 0 over the steps), then
              ``logits_for`` on the trained weights against freshly cast
              copies;
then the card's name and power limit, one JSON line listing every kernel, and
as the last line ``{"ok": true, "device": {...}}``. Without a GPU, or outside
a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from collections import deque

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,    # dense bf16 tensor-core rate
            "float32": 67e12,      # f32 outside the tensor cores
            "int8": 1979e12}       # dense int8 tensor-core rate

ARENA_ROWS = 1_048_576             # capacity + 1, 256 x TOPK_BLOCK
DIM = 768
PER_CONV = 8_192                   # facts per conversation (ingest_coalesce_max)
# Phase 4's fill: 3/8 of the arena, 48 conversations, 24 a tenant. Filling
# the whole arena took ~500 s of host work (the store's parquet writes
# ~300 s of it), more than the 1,200 s run can hold beside the rest; half
# of it left the run near 800 s once the IVF drive joined it.
FILL = 3 * ARENA_ROWS // 8         # facts the fill ingests, a PER_CONV multiple
MIN_ROWS = 262_144                 # the least fill worth a run (PALLAS_TOPK_MIN_ROWS)
# The mesh phase's fill: 34 conversations (278,528 facts). A conversation
# shares its group directions with the tenant's conversation 32 before it
# (Corpus), so the 33rd and 34th are each tenant's first to link to earlier
# facts, and the parity record after them covers the link verdicts.
MESH_CONVS = MIN_ROWS // PER_CONV + 2
MESH_SHARDS = 8                    # shards of the mesh on one card
PARITY_FACTS = 32                  # snapshot queries per tenant
TENANTS = ("alice", "bob")
TOPICS = ["work", "hobbies", "family", "travel", "health", "food", "sports",
          "music", "books", "tech", "home", "finance"]
DUP_EVERY = 101
# Fact geometry: w_t * topic + w_g * group + w_n * noise (unit parts). Group
# mates (same tenant, same slot, conversations K apart) score ~0.84, above
# the 0.5 link gate and below the 0.95 dedup gate; a fact scores ~0.3 against
# its shard's super node, under the 0.4 gate, so every chat turn runs both the
# gate search and the ANN search.
TOPIC_W, GROUP_W, NOISE_W = 0.3, 0.75 ** 0.5, 0.16 ** 0.5
# Flash-attention cases (label, B, T, S, H, Hkv, D, dtype): the decoder's
# shapes at full width (logits_for of 2,047 tokens, a batch of 4 at max_seq),
# LMConfig.small()'s heads, chunked prefill (S > T), MQA, and f32.
FLASH_CASES = [
    ("logits_for_b1_t2047_h8_kv2_d256_bf16", 1, 2047, 2047, 8, 2, 256, "bfloat16"),
    ("b4_t2048_h8_kv2_d256_bf16", 4, 2048, 2048, 8, 2, 256, "bfloat16"),
    ("small_b8_t1024_h8_kv2_d64_bf16", 8, 1024, 1024, 8, 2, 64, "bfloat16"),
    ("chunked_b1_t13_s2048_h8_kv2_d256_bf16", 1, 13, 2048, 8, 2, 256, "bfloat16"),
    ("mqa_b2_t1024_h8_kv1_d128_bf16", 2, 1024, 1024, 8, 1, 128, "bfloat16"),
    ("f32_b2_t512_h8_kv2_d64", 2, 512, 512, 8, 2, 64, "float32"),
]
# Tolerances (max |kernel - plain| of O, and of the f32 LSE). f32: the two
# differ only in the order of f32 sums. bf16: both round P to bf16 before
# P.V, but O is rounded to bf16 after sums in another order, so a value may
# land one bf16 step away (1.6e-2 in [2, 4)).
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-3)}
# Flash backward cases (label, B, T, S, H, Hkv, D, dtype): the training
# step's shape at full width (LMConfig(), B=2, T=2,048), a ragged T, the
# small config's heads, chunked S > T, MQA (rep = 8), and f32.
FLASH_BWD_CASES = [
    ("train_b2_t2048_h8_kv2_d256_bf16", 2, 2048, 2048, 8, 2, 256, "bfloat16"),
    ("ragged_b1_t2047_h8_kv2_d256_bf16", 1, 2047, 2047, 8, 2, 256, "bfloat16"),
    ("small_b8_t1024_h8_kv2_d64_bf16", 8, 1024, 1024, 8, 2, 64, "bfloat16"),
    ("chunked_b1_t64_s2048_h8_kv2_d256_bf16", 1, 64, 2048, 8, 2, 256, "bfloat16"),
    ("mqa_b2_t1024_h8_kv1_d128_bf16", 2, 1024, 1024, 8, 1, 128, "bfloat16"),
    ("f32_b2_t512_h8_kv2_d64", 2, 512, 512, 8, 2, 64, "float32"),
]
# Tolerance of dq, dk and dv, as max |kernel - plain| over the plain result's
# largest magnitude. f32: the two differ only in the order of f32 sums.
# bf16: both round P and dS to bf16 at the same points and sum in f32, but
# in other orders, so an element of P or dS may round to the neighbouring
# bf16 value before its product, and the outputs are rounded to bf16 after.
FLASH_BWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# Kernel cases are timed as the median of this many windows (a host stall
# inflates one window, not the median).
WINDOWS = 5
# Small-Q cases also timed on the FMA route, forced (phase 3): the route
# every scan of up to 16 queries took before the streaming route (f32) and
# the tensor cores (bf16) took them, and the one an f32 scan too wide for
# the streaming route takes, so that the route rule stays visible.
FORCED_FMA = ("chat_ann_q1_k10_bf16", "chat_ann_q1_k10_f32", "q8_k10_f32",
              "chat_ann_q1_k10_f32_d3072", "chat_q1_k128_kq10",
              "chat_q1_k128_kq10_f32")
LM_TOKENS = 2047                   # logits_for length: BOS + 2,046 bytes
# Largest |logit| difference of the full-width forward through the kernel
# against the materialized-scores path: that path rounds the scores to bf16
# before the softmax, the kernel keeps them in f32, and 18 layers carry the
# difference through a bf16 residual branch.
LM_LOGIT_TOL = 0.25
# The extraction pins its schema and a content prefix: the pipeline drops
# facts whose content is empty, which random weights may well produce.
EXTRACTION_SCAFFOLD = '{"memories": [{"content": "The user said: '
LM_CHAT = ["I work as a data engineer on a big ETL project.",
           "My sister lives in Lisbon and we talk every Sunday.",
           "I am training for a marathon in October."]
# Training phase: one batch of B=2 rows of T=2,048 byte tokens, AdamW at
# optax.adamw(TRAIN_LR)'s defaults, TRAIN_STEPS steps.
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 2, 2048, 10, 3e-4
# Flash against the materialized-scores path, one step from the same
# weights: the plain path rounds the scores to bf16 before the softmax and
# the kernels keep them in f32, so logits differ by a few hundredths (0.0393
# at LMConfig() on the H100) and the gradients by the bf16 rounding that
# follows through 18 layers. Loss within TRAIN_LOSS_TOL, every tensor's gradients at cosine
# above TRAIN_GRAD_COS.
TRAIN_LOSS_TOL, TRAIN_GRAD_COS = 1e-2, 0.99
# Phases 4 and 4b's flags. As the JAX bench builds its fill: the store and
# the ingest journal on, the turn journal off.
SLICE = dict(serve_fused=False, ingest_fused=False, ingest_dedup_fused=False,
             lifecycle_fused=False, journal=False, ingest_journal=True,
             auto_consolidate=False)
# Phase 4's: the fused dedup ingest, the default (phase 4b's mesh takes the
# classic ingest, SLICE).
FUSED_INGEST = dict(SLICE, ingest_fused=True, ingest_dedup_fused=True)


def log(msg: str) -> None:
    print(msg, flush=True)


# Every MemorySystem of the run writes its store and journals under one
# temporary directory on local disk, which main() removes at the end.
STORE_ROOT = None


def store_dir(name: str) -> str:
    return os.path.join(STORE_ROOT, name)


def disk_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _store_seconds(tel, kind: str, marks: dict) -> dict:
    """Seconds by part from the ``store.<kind>_ms`` timer samples recorded
    since ``marks`` (timer key -> sample count)."""
    out = {}
    for key, samples in list(tel.timers.items()):
        if not key.startswith(f"store.{kind}_ms{{"):
            continue
        part = key.split('"')[1]
        new = list(samples)[marks.get(key, 0):]
        out[part] = out.get(part, 0.0) + sum(new) / 1e3
    return out


def fill_order(convs: int):
    """The fill's conversation order. ``switch_user`` saves a tenant and
    reloads the next from the store, so the tenants' conversations run in
    blocks, each tenant's in its own order (no tenant sees another's rows,
    so each one's final state is the interleaved run's): alice's first
    ``MESH_CONVS // 2``, bob's first as many (the mesh phase's whole fill,
    where the parity snapshot is taken), then bob's rest and alice's rest.
    Node ids count across tenants, so phase 4b keeps this order too."""
    own = [[c for c in range(convs) if c % len(TENANTS) == t]
           for t in range(len(TENANTS))]
    half = MESH_CONVS // 2
    return own[0][:half] + own[1][:half] + own[1][half:] + own[0][half:]


def nvidia_smi(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_build() -> float:
    from lazzaro_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    names = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    started = [(name, *cuda_build.start_build(name, verbose=True))
               for name in names]
    for name, proc, out in started:
        text = cuda_build.finish_build(proc, out)
        for line in text.splitlines():
            if "Compiling entry function" in line:
                log(f"  ptxas {name}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line or "arning" in line:
                log(f"  ptxas {name}: {line.strip()}")
    secs = time.perf_counter() - t0
    log(f"[build] {len(names)} source(s) {names} built in {secs:.2f} s")
    return secs


def cuda_ms(fn, reps: int, windows: int = 1) -> float:
    """ms per call of ``fn``: the median over ``windows`` windows of ``reps``
    calls, each timed with CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _device_kernels(fn, calls: int):
    """The CUDA kernel events ``torch.profiler`` records over ``calls`` calls
    of ``fn``, after one warm-up call. The profiler now and then hands back
    a window without device events, or without some of them (a call's
    kernels then do not divide by ``calls``); the window is then run again,
    up to four times, and the fullest window is kept."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    best = (0, [])
    for _ in range(4):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == cuda]
        if sum(e.self_device_time_total for e in kernels) > 0:
            seen = sum(e.count for e in kernels)
            if seen % calls == 0:
                return kernels
            best = max(best, (seen, kernels), key=lambda b: b[0])
    if best[0]:
        return best[1]
    raise RuntimeError("torch.profiler recorded no device time")


def device_ms(fn, calls: int) -> float:
    """ms of device time per call of ``fn``: the sum of the CUDA kernels
    that ``torch.profiler`` records over ``calls`` calls, after one warm-up
    call. Unlike :func:`cuda_ms` it leaves out the gaps in which the device
    waits for the host, which for a call of ~0.05 ms are as long as the
    call itself."""
    kernels = _device_kernels(fn, calls)
    return sum(e.self_device_time_total for e in kernels) / 1e3 / calls


def device_split(fn, calls: int, stage1: str = "scan_stage1",
                 merge: str = "scan_merge") -> dict:
    """Device ms per call of ``fn`` under ``torch.profiler`` (as
    :func:`device_ms`), with the top-k scan's two stages apart: stage 1
    (kernels named ``stage1*``: ``scan_stage1``, or ``ingest_stage1`` for
    the ingest mode, ``i8_stage1`` for K4), the merge (``scan_merge``, or
    K4's ``i8_select``) and the rest (casts, masks and K4's query
    quantization around the launch), and the launches of the two stages a
    call that the trace shows."""
    kernels = _device_kernels(fn, calls)

    def total(needle):
        return sum(e.self_device_time_total for e in kernels
                   if needle in e.key) / 1e3 / calls

    out = {"all": total(""), "stage1": total(stage1),
           "merge": total(merge),
           "scan_kernels": sum(e.count for e in kernels if stage1 in e.key
                               or merge in e.key) / calls}
    out["rest"] = out["all"] - out["stage1"] - out["merge"]
    return out


def grid_values(gen, shape, dtype, device):
    """Normal draws rounded to multiples of 1/256: their products and sums
    are exact in f32 whatever the summation order, so the kernel and the
    plain version must agree bit for bit, exact ties included."""
    import torch

    x = torch.randn(shape, generator=gen, device=device)
    return (torch.round(x * 16) / 256).to(dtype)


def kernel_cases(device):
    """(label, emb, madd, queries, k) at the main path's shapes."""
    import torch

    from lazzaro_tpu_torch.ops.topk import NEG_INF as NEG

    gen = torch.Generator(device=device).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    big = grid_values(gen, (ARENA_ROWS, DIM), bf16, device)
    alive = torch.rand(big.shape[0], generator=gen, device=device) < 0.9
    madd_big = torch.where(alive, 0.0, NEG).float()

    def queries(emb, q):
        return grid_values(gen, (q, emb.shape[1]), emb.dtype, device)

    # Every launch shape of the main path on the full arena: a chat turn's
    # super-node gate and ANN search, search_memories (limit 5), the dedup
    # probe of a fill conversation (8,192 facts) and of the last one (64);
    # then search_memories_batch of 64 queries at limit 10; then more
    # batch sizes (bf16 takes the tensor cores at every Q), a large list
    # batch and lists in three passes.
    cases = [
        ("chat_gate_q1_k1_bf16", big, madd_big, queries(big, 1), 1),
        ("chat_ann_q1_k10_bf16", big, madd_big, queries(big, 1), 10),
        ("search_q1_k5_bf16", big, madd_big, queries(big, 1), 5),
        ("dedup_q8192_k1_bf16", big, madd_big, queries(big, 8192), 1),
        ("dedup_q64_k1_bf16", big, madd_big, queries(big, 64), 1),
        ("search_batch_q64_k10_bf16", big, madd_big, queries(big, 64), 10),
        ("q8_k10_bf16", big, madd_big, queries(big, 8), 10),
        ("q17_k10_bf16", big, madd_big, queries(big, 17), 10),
        ("q1024_k10_bf16", big, madd_big, queries(big, 1024), 10),
        ("q64_k300_bf16", big, madd_big, queries(big, 64), 300),
    ]
    mid = grid_values(gen, (262_144, DIM), f32, device)
    cases.append(("q128_k16_f32", mid, torch.zeros(mid.shape[0], device=device),
                  queries(mid, 128), 16))
    ragged = big[:100_003]
    cases.append(("ragged_n100003_q3_k10_bf16", ragged, madd_big[:100_003],
                  queries(ragged, 3), 10))
    # Exact duplicates: 4,096 distinct rows repeated, queries drawn from
    # them, so every top-k list is a run of exact ties; k = serve_k_max, and
    # k = 300, which runs in three passes with ties across their seams.
    base = grid_values(gen, (4_096, DIM), f32, device)
    dup = base.repeat(13, 1)
    for k in (128, 300):
        cases.append((f"duplicates_q16_k{k}_f32", dup,
                      torch.zeros(dup.shape[0], device=device),
                      base[:16].clone(), k))
    # Fewer live rows than k: the tail fills with the lowest dead rows.
    few = big[:20_000]
    madd_few = torch.full((few.shape[0],), NEG, device=device)
    madd_few[torch.tensor([5, 77, 1_000, 19_999], device=device)] = 0.0
    cases.append(("few_live_q5_k16_bf16", few, madd_few, queries(few, 5), 16))
    # The default arena type (MemoryConfig.dtype, f32): a chat turn's ANN
    # search and a small batch on the streaming route, 3.2 GB of arena.
    big32 = grid_values(gen, (ARENA_ROWS, DIM), f32, device)
    cases.append(("chat_ann_q1_k10_f32", big32, madd_big, queries(big32, 1), 10))
    cases.append(("q8_k10_f32", big32, madd_big, queries(big32, 8), 10))
    # A wide f32 arena (d = 3,072, text-embedding-3-large's width): rows of
    # 12 KB, four a ring stage, on the streaming route.
    wide = grid_values(gen, (262_144, 3_072), f32, device)
    cases.append(("chat_ann_q1_k10_f32_d3072", wide,
                  madd_big[:wide.shape[0]].contiguous(), queries(wide, 1), 10))
    return cases


def bound(emb, queries, k):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (arena, mask and queries read once, results written once) over HBM
    bandwidth and its multiply-adds over the peak rate of the arena type."""
    n, d = emb.shape
    q = queries.shape[0]
    item = emb.element_size()
    moved = n * d * item + n * 4 + q * d * item + q * k * (4 + 8)
    ops = 2.0 * n * d * q
    peak = PEAK_OPS["bfloat16" if item == 2 else "float32"]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _check_equal(label, got, want):
    """Every output tensor equal; returns the largest score error (0.0)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            err = max(err, float((g - w).abs().max()))
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(
                f"{label}: kernel disagrees with the plain version "
                f"({bad} entries differ, max |score err| {err})")
    return err


def _case_row(kernel, form, label, route, n, q, k, fn, plain_fn, lib_fn, b,
              err, reps, plain_reps, stage1="scan_stage1", merge="scan_merge"):
    """One timed case: device times under ``torch.profiler`` of the kernel
    (stage 1 and the merge apart), its plain version and the library call;
    CUDA-event times of back-to-back calls of the kernel and the library
    beside them (they include the wrapper's host work)."""
    split = device_split(fn, reps, stage1, merge)
    ms = split["all"]
    plain = device_ms(plain_fn, plain_reps)
    lib = device_ms(lib_fn, reps) if lib_fn is not None else None
    event = cuda_ms(fn, reps)
    lib_event = cuda_ms(lib_fn, reps) if lib_fn is not None else None
    b_ms, b_by = b
    log(f"[kernels] {kernel} {label} ({route} route): rows equal, max_abs_err "
        f"{err}, device ms {ms:.4f} (stage 1 {split['stage1']:.4f}, merge "
        f"{split['merge']:.4f}, rest {split['rest']:.4f}), plain_ms {plain:.4f}, "
        f"library_ms {lib}, bound_ms {b_ms:.4f} ({b_by}); events of "
        f"back-to-back calls: kernel {event:.4f}, library {lib_event}")
    return {"kernel": kernel, "form": form, "case": label, "route": route,
            "n": n, "q": q, "k": k, "ms": ms, "stage1_ms": split["stage1"],
            "merge_ms": split["merge"], "scan_kernels": split["scan_kernels"],
            "event_ms": event, "plain_ms": plain,
            "library_ms": lib, "library_event_ms": lib_event,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


def phase_kernels(device):
    import torch

    from lazzaro_tpu_torch.ops import masked_topk as mt

    rows_out = []
    for label, emb, madd, q, k in kernel_cases(device):
        nq = q.shape[0]
        route = mt.route_for(emb.dtype, nq, emb.shape[1])
        err = _check_equal(label, mt.masked_topk(emb, madd, q, k),
                           mt.masked_topk_reference(emb, madd, q, k))
        big_q = nq > 1024
        # Yardstick only (the port never calls it): one product with the
        # mask folded in, then torch.topk.
        madd_t = madd.to(emb.dtype)
        rows_out.append(_case_row(
            "masked_topk", "classic", label, route, emb.shape[0], nq, k,
            lambda: mt.masked_topk(emb, madd, q, k),
            lambda: mt.masked_topk_reference(emb, madd, q, k),
            lambda: torch.topk(torch.addmm(madd_t, q, emb.t()), k),
            bound(emb, q, k), err, 3 if big_q else 20, 1 if big_q else 3))
        if label == "chat_ann_q1_k10_bf16":
            # The dispatch form (pallas_topk.py:masked_topk_auto) launches
            # the same kernel on the same inputs.
            err = _check_equal("auto", mt.masked_topk_auto(emb, madd, q, k),
                               mt.masked_topk_reference(emb, madd, q, k))
            rows_out.append(_case_row(
                "masked_topk", "auto", "auto_q1_k10_bf16", route, emb.shape[0],
                1, k, lambda: mt.masked_topk_auto(emb, madd, q, k),
                lambda: mt.masked_topk_reference(emb, madd, q, k),
                lambda: torch.topk(torch.addmm(madd_t, q, emb.t()), k),
                bound(emb, q, k), err, 20, 3))
        other = "fma" if label in FORCED_FMA else None
        if other:
            # A record of the route rule: the route the wrapper does not
            # take at this Q, forced.
            forced = f"{label}_forced_{other}"
            err = _check_equal(forced, mt._launch(emb, madd, q, k, route=other),
                               mt.masked_topk_reference(emb, madd, q, k))
            rows_out.append(_case_row(
                "masked_topk", "classic", forced, other, emb.shape[0], nq, k,
                lambda: mt._launch(emb, madd, q, k, route=other),
                lambda: mt.masked_topk_reference(emb, madd, q, k),
                lambda: torch.topk(torch.addmm(madd_t, q, emb.t()), k),
                bound(emb, q, k), err, 20, 3))
    return rows_out


def ragged_cases(device):
    """The ragged single-mask form (pallas_topk.py:masked_topk_arena_ragged)
    at a ragged N = 100,003, Q = 3, ceiling K = 10, k_q = {1, 5, 10}."""
    import torch

    from lazzaro_tpu_torch.ops import masked_topk as mt

    gen = torch.Generator(device=device).manual_seed(2)
    emb = grid_values(gen, (100_003, DIM), torch.bfloat16, device)
    alive = torch.rand(emb.shape[0], generator=gen, device=device) < 0.9
    q = grid_values(gen, (3, DIM), torch.bfloat16, device)
    k_q = torch.tensor([1, 5, 10], dtype=torch.int32, device=device)
    k = 10
    err = _check_equal("ragged", mt.masked_topk_ragged(emb, alive, q, k_q, k),
                       mt.masked_topk_ragged_reference(emb, alive, q, k_q, k))
    madd_t = torch.where(alive, 0.0, -1e30).to(emb.dtype)
    return [_case_row(
        "masked_topk", "ragged", "ragged_n100003_q3_k10_kq1-5-10_bf16",
        mt.route_for(emb.dtype, 3, DIM), emb.shape[0], 3, k,
        lambda: mt.masked_topk_ragged(emb, alive, q, k_q, k),
        lambda: mt.masked_topk_ragged_reference(emb, alive, q, k_q, k),
        lambda: torch.topk(torch.addmm(madd_t, q, emb.t()), k),
        bound(emb, q, k), err, 20, 3)]


def fused_bound(emb, q, k):
    """(bound_ms, bound_by) of the two-tier scan: the arena and its three row
    columns (alive, tenant, is_super: 6 bytes a row) and the queries with
    their tenant and k read once, the gate and the [Q, k] lists written
    once; 2*N*d*Q operations at the arena type's peak."""
    n, d = emb.shape
    nq = q.shape[0]
    item = emb.element_size()
    moved = n * d * item + 6 * n + nq * (d * item + 8) + nq * (8 + 8 * k)
    ops = 2.0 * n * d * nq
    peak = PEAK_OPS["bfloat16" if item == 2 else "float32"]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fused_cases(device):
    """(label, queries, tenant, k_q, k_live) of the two-tier kernel on the
    1,048,576-row bf16 arena of two tenants with ~1% super rows, plus a
    tenant (2) without super rows and one (3) with three rows; k = 128."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    n = ARENA_ROWS
    emb = grid_values(gen, (n, DIM), torch.bfloat16, device)
    alive = torch.rand(n, generator=gen, device=device) < 0.9
    tenant = (torch.rand(n, generator=gen, device=device) < 0.5).int()
    sup = torch.rand(n, generator=gen, device=device) < 0.01
    tenant[n // 2:n // 2 + 1000] = 2
    sup[n // 2:n // 2 + 1000] = False
    short = [100, n * 4 // 7, n * 6 // 7]
    tenant[short] = 3
    alive[short] = True
    sup[short] = False
    alive[-1] = False                              # the sentinel row
    tenant = torch.where(alive, tenant, -1).int()
    cols = (emb, alive, tenant, sup)

    def batch(ten, kq):
        nq = len(ten)
        return (grid_values(gen, (nq, DIM), torch.bfloat16, device),
                torch.tensor(ten, dtype=torch.int32, device=device),
                torch.tensor(kq, dtype=torch.int32, device=device))

    pad = [-1] * 7
    chat = batch([0] + pad, [10] + [0] * 7)
    fleet_t = [i % 2 for i in range(64)]
    fleet_k = [(5, 10, 128)[i % 3] for i in range(64)]
    # A lone request is a batch of 1 (bucket_size keeps the power-of-two
    # ladder below serve_pad_granularity): the main path's chat and search
    # shapes. The Q = 8 cases are one live query among padding.
    cases = [
        ("chat_q1_k128_kq10", *batch([0], [10]), 10),
        ("search_q1_k128_kq5", *batch([1], [5]), 5),
        ("chat_q8_k128_kq10", *chat, 10),
        ("chat_q8_k128_kq10_lists128", *chat, None),
        ("search_q8_k128_kq5", *batch([1] + pad, [5] + [0] * 7), 5),
        ("batch_q64_k128_kq10", *batch([0] * 64, [10] * 64), 10),
        ("fleet_q64_k128_kq5-10-128", *batch(fleet_t, fleet_k), 128),
        ("corners_q8_k128_kq10", *batch([2, 3, 0, 1, 2, 3, -1, -1],
                                        [10, 10, 10, 10, 5, 128, 0, 0]), 128),
    ]
    return cols, cases


def phase_fused_kernel(device):
    import torch

    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import masked_topk as mt

    (emb16, alive, tenant, sup), cases = fused_cases(device)
    k = 128
    rows_out = []
    # The keyed chat turn on the default arena type (f32), the same rows.
    chat = next(c for c in cases if c[0] == "chat_q1_k128_kq10")
    cases.append(("chat_q1_k128_kq10_f32", *chat[1:]))
    forced = [(f"{c[0]}_forced_fma", *c[1:], "fma") for c in cases
              if c[0] in FORCED_FMA]
    emb32 = None
    for label, q, q_ten, k_q, k_live, *force in cases + forced:
        emb = emb16
        if "_f32" in label:
            if emb32 is None:
                emb32 = emb16.float()
            emb, q = emb32, q.float()
        route = force[0] if force else mt.route_for(emb.dtype, q.shape[0], DIM)

        def run(emb=emb, q=q, q_ten=q_ten, k_q=k_q, k_live=k_live, force=force):
            if force:
                return ft._launch(emb, alive, tenant, sup, q, q_ten, k_q, k,
                                  emb.shape[0] - 1, k_live, route=force[0])
            return ft.fused_topk(emb, alive, tenant, sup, q, q_ten, k_q, k,
                                 k_live=k_live)

        got = run()
        want = ft.fused_topk_reference(emb, alive, tenant, sup, q, q_ten,
                                       k_q, k)
        err = _check_equal(label, got, want)
        if label.startswith("corners"):
            # tenant 2 has no super row: gate (-1e30, row 0); tenant 3 has
            # three rows: its tail is rows 0, 1, ... at -1e30
            if not (got[1][0] == 0 and got[0][0] == -1e30):
                raise AssertionError("empty gate is not (-1e30, row 0)")
            if got[3][1, 3:6].tolist() != [0, 1, 2]:
                raise AssertionError("short tenant's tail is not rows 0, 1, 2")

        def lib(emb=emb, q=q, q_ten=q_ten):
            # Yardstick only: one product, the tier masks, two torch.topk.
            s = torch.matmul(q, emb.t()).float()
            ok = alive[None, :] & (tenant[None, :] == q_ten[:, None])
            torch.topk(torch.where(ok & sup[None, :], s, -1e30), 1)
            return torch.topk(torch.where(ok & ~sup[None, :], s, -1e30), k)

        rows_out.append(_case_row(
            "fused_topk", "two_tier", label, route, emb.shape[0], q.shape[0],
            k, run,
            lambda emb=emb, q=q, q_ten=q_ten, k_q=k_q: ft.fused_topk_reference(
                emb, alive, tenant, sup, q, q_ten, k_q, k),
            lib, fused_bound(emb, q, k), err, 20, 3))
    return rows_out


INT8_K = 128 + 8                   # serve_k_max + coarse_fetch_slack
INT8_G = 1 + 8                     # the gate's coarse list


def int8_bound(n, d, nq, k, g, keyed):
    """(bound_ms, bound_by) of K4: the shadow's codes and scales and the row
    columns (tenant, alive, is_super: 6 bytes a row; the additive form's
    madd: 4) and the f32 queries (with their tenant) read once, the lists
    written once; 2*N*d*Q int8 operations at the int8 tensor rate."""
    moved = (n * (d + 4) + (6 if keyed else 4) * n + nq * (4 * d + 4)
             + nq * 8 * (k + g))
    ops = 2.0 * n * d * nq
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS["int8"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def int8_library(codes, scale, q, cols, q_ten, k, g):
    """The library yardstick of K4 (timed here, never called by the port):
    ``torch._int_mm`` of the quantized queries (padded to 32 rows, its least
    M) against the codes, the two scales, the tier masks and ``torch.topk``;
    None where ``_int_mm`` refuses the shape."""
    import torch

    from lazzaro_tpu_torch.ops.quant import quantize_rows

    nq = q.shape[0]
    pad = max(32, -(-nq // 8) * 8)

    def run():
        qq, qs = quantize_rows(q)
        qp = torch.zeros((pad, qq.shape[1]), dtype=torch.int8, device=q.device)
        qp[:nq] = qq
        dots = torch._int_mm(qp, codes.t())[:nq]
        s = (dots.float() * qs[:, None]) * scale[None, :]
        if cols is None:
            return torch.topk(s, k)
        alive, tenant, sup = cols
        ok = alive[None, :] & (tenant[None, :] == q_ten[:, None])
        torch.topk(torch.where(ok & sup[None, :], s, -1e30), g)
        return torch.topk(torch.where(ok & ~sup[None, :], s, -1e30), k)

    try:
        run()
        torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"[kernels] int8_topk library form refused ({e}); library_ms null")
        return None
    return run


INT8_WIDE = (131_072, 1536)         # the wide shadow: rows, d


def phase_int8_kernel(device):
    """K4 against its plain version on the card, bit-equal: the keyed form
    over the shadow of the 1,048,576 x 768 bf16 arena of the two-tier cases
    at the chat turn's Q = 1 and a fleet's Q = 64 (k = 128 + 8, g = 1 + 8),
    at the corners (an empty gate, a tenant of three rows, pad queries) and
    with a list past 256 (k = 300: two passes); the keyed chat turn over a
    131,072 x 1,536 shadow (past the first form's 1,040); the additive form
    at a classic search's Q = 1, k = 10; and the two chat-turn shapes on the
    dp4a stage forced (the first form's route, a record beside the tensor
    cores'). Each row names the route the launch took (the wrapper's
    counters), its stage 1 and stage 2 timed apart."""
    import torch

    from lazzaro_tpu_torch.ops import int8_topk as k4
    from lazzaro_tpu_torch.ops.quant import quantize_rows

    (emb16, alive, tenant, sup), _ = fused_cases(device)
    codes, scale = quantize_rows(emb16)
    del emb16
    gen = torch.Generator(device=device).manual_seed(4)
    n = codes.shape[0]
    wn, wd = INT8_WIDE
    wcodes, wscale = quantize_rows(grid_values(gen, (wn, wd), torch.bfloat16,
                                               device))
    wide_cols = (alive[:wn], tenant[:wn], sup[:wn])

    def queries(nq, d=DIM):
        x = grid_values(gen, (nq, d), torch.float32, device)
        return x / x.norm(dim=1, keepdim=True)

    def ten(ts):
        return torch.tensor(ts, dtype=torch.int32, device=device)

    def taken(fn):
        """The result of one call and the route its launch took."""
        before = (k4.launches_wgmma, k4.launches_dp4a)
        out = fn()
        return out, ("wgmma" if k4.launches_wgmma > before[0] else "dp4a")

    # The fleet's k = 1 case keeps lists of one: its time beside the
    # fleet's is the products' share, the rest the lists'.
    fleet = ten([i % 2 for i in range(64)])
    full = (codes, scale, (alive, tenant, sup))
    cases = [("chat_keyed_q1_k136_g9", full, queries(1), ten([0]), INT8_K,
              INT8_G, None),
             ("fleet_keyed_q64_k136_g9", full, queries(64), fleet, INT8_K,
              INT8_G, None),
             ("corners_keyed_q8_k136_g9", full, queries(8),
              ten([2, 3, 0, 1, 2, 3, -1, -1]), INT8_K, INT8_G, None),
             ("fleet_keyed_q64_k1_g1", full, queries(64), fleet, 1, 1, None),
             ("chat_keyed_q1_k300_g9", full, queries(1), ten([0]), 300,
              INT8_G, None),
             (f"chat_keyed_q1_k136_g9_d{wd}", (wcodes, wscale, wide_cols),
              queries(1, wd), ten([0]), INT8_K, INT8_G, None),
             ("chat_keyed_q1_k136_g9_dp4a_forced", full, queries(1), ten([0]),
              INT8_K, INT8_G, "dp4a")]
    rows_out = []
    for label, (cd, sc, cols), q, q_ten, k, g, force in cases:
        def run(cd=cd, sc=sc, cols=cols, q=q, q_ten=q_ten, k=k, g=g, force=force):
            if force:
                return k4._launch(cd, sc, q, k, g, cols=cols, tenant=q_ten,
                                  route=force)
            return k4.int8_topk_keyed(cd, sc, *cols, q, q_ten, k, g)

        def plain(cd=cd, sc=sc, cols=cols, q=q, q_ten=q_ten, k=k, g=g):
            return k4.int8_topk_keyed_reference(cd, sc, *cols, q, q_ten, k, g)

        got, route = taken(run)
        err = _check_equal(label, got, plain())
        if label.startswith("corners"):
            if not (got[0][0] == -1e30).all() or got[1][0].tolist() != list(range(INT8_G)):
                raise AssertionError("K4: an empty gate list is not NEG_INF "
                                     "over rows 0, 1, ...")
            if not ((got[2][1, :3] > -1e29).all() and (got[2][1, 3:] == -1e30).all()):
                raise AssertionError("K4: the short tenant's list is not its 3 rows")
        lib = int8_library(cd, sc, q, cols, q_ten, k, g)
        rows_out.append(_case_row(
            "int8_topk", "keyed", label, route, cd.shape[0], q.shape[0], k,
            run, plain, lib, int8_bound(cd.shape[0], cd.shape[1], q.shape[0],
                                        k, g, True),
            err, 20, 3, stage1="i8_stage1", merge="i8_select"))
    q = queries(1)
    madd = torch.where(alive, 0.0, -1e30).float()
    for label, force in (("search_additive_q1_k10", None),
                         ("search_additive_q1_k10_dp4a_forced", "dp4a")):
        def run_add(q=q, force=force):
            if force:
                return k4._launch(codes, scale, q, 10, madd=madd, route=force)
            return k4.int8_topk(codes, scale, alive, q, 10)

        def plain_add(q=q):
            return k4.int8_topk_reference(codes, scale, alive, q, 10)

        got, route = taken(run_add)
        err = _check_equal(label, got, plain_add())
        rows_out.append(_case_row(
            "int8_topk", "additive", label, route, n, 1, 10, run_add,
            plain_add, int8_library(codes, scale, q, None, None, 10, 0),
            int8_bound(n, DIM, 1, 10, 0, False), err, 20, 3,
            stage1="i8_stage1", merge="i8_select"))
    return rows_out


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


# Phase 4's build over about FILL live rows (the fill less its duplicates):
IVF_C = _pow2(math.isqrt(FILL))    # C = pow2(sqrt(N))
IVF_M = _pow2(4 * (FILL // IVF_C))  # M = pow2(4 N / C)
IVF_LIVE = FILL // IVF_C           # live member rows a cluster holds there
IVF_E = 1024                       # the extras: residual, fresh and super rows
IVF_P = 8                          # MemoryConfig.ivf_serving of the IVF drive
IVF_K = 128 + 8                    # serve_k_max + coarse_fetch_slack
IVF_G = 1 + 8                      # the int8 form's gate list
IVF_NPROBES = (1, 4, 8)            # the fleet's per-request nprobe


def ivf_tables(alive, sup, device):
    """Member tables of phase 4's build geometry over the kernel arena:
    ``IVF_C`` clusters of ``IVF_M`` slots holding ``IVF_C * IVF_LIVE``
    random live rows (a dense prefix each, -1 after), extras of ``IVF_E``
    rows (super rows among them, a few member rows again: a reused slot)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(9)
    live = torch.nonzero(alive).flatten()
    pick = torch.randperm(len(live), generator=gen, device=device)
    rows = live[pick[:IVF_C * IVF_LIVE]]
    c = torch.randint(0, IVF_C, (len(rows),), generator=gen, device=device)
    order = torch.sort(c, stable=True).indices
    sc = c[order]
    rank = torch.arange(len(sc), device=device) - torch.searchsorted(sc, sc)
    if int(rank.max()) >= IVF_M:
        raise AssertionError("ivf_tables: a cluster outgrew its slots")
    members = torch.full((IVF_C, IVF_M), -1, dtype=torch.int32, device=device)
    members[sc, rank] = rows[order].int()
    sup_rows = torch.nonzero(sup & alive).flatten()[:IVF_E // 4].int()
    rest = live[pick[IVF_C * IVF_LIVE:IVF_C * IVF_LIVE + IVF_E // 2]].int()
    extras = torch.full((IVF_E,), -1, dtype=torch.int32, device=device)
    fill = torch.cat([members[:4, :16].flatten(), sup_rows, rest])[:IVF_E]
    extras[:len(fill)] = fill
    return members, extras, len(fill)


def ivf_sparse(members, alive, device):
    """The build geometry's tables with the occupancy a live index drifts
    to: every fourth cluster empty, every fourth full (``IVF_M`` rows), the
    rest as built; returns the members and their occupancy."""
    import torch

    gen = torch.Generator(device=device).manual_seed(11)
    live = torch.nonzero(alive).flatten()
    out = members.clone()
    kind = torch.arange(IVF_C, device=device) % 4
    out[kind == 0] = -1
    full = torch.nonzero(kind == 1).flatten()
    pick = torch.randint(0, len(live), (len(full), IVF_M), generator=gen,
                         device=device)
    out[full] = live[pick].int()
    return out, (out >= 0).sum(dim=1).int()


def ivf_valid(members, extras, cids, ok_rows, npq):
    """The candidate slots K5 loads a row for: ``[Q]`` counts of slots that
    hold a row of a probed cluster (``npq`` per query) and pass
    ``ok_rows [Q, N]``-style masks (a callable of the candidate rows)."""
    import torch

    from lazzaro_tpu_torch.ops.ivf_topk import ivf_candidates

    cand = ivf_candidates(members, extras, cids)
    pm = cids.shape[1] * members.shape[1]
    pos = torch.arange(cand.shape[1], device=cand.device)
    probed = (pos >= pm)[None, :] | ((pos // members.shape[1])[None, :]
                                     < npq[:, None])
    return ((cand >= 0) & probed & ok_rows(cand)).sum(dim=1)


def ivf_bound(n_valid, d, item, nq, slots, k, g, extra_row_bytes):
    """(bound_ms, bound_by) of K5: the live candidate rows (``n_valid`` of
    them over the batch, ``item`` bytes an element, plus their row columns)
    and every probed slot and extra (4 bytes) read once, the queries and
    their columns read once, the lists written once; 2 * d operations a
    loaded row. The centroid table is not K5's to read: the coarse stage
    that picks ``cids`` is a launch of the masked top-k (#1), not timed
    here."""
    moved = (n_valid * (d * item + extra_row_bytes) + nq * slots * 4
             + nq * (d * 4 + 8) + nq * 12 * (k + g))
    ops = 2.0 * n_valid * d
    peak = PEAK_OPS["bfloat16" if item == 2 else
                    "int8" if item == 1 else "float32"]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ivf_library(rows, members, extras, cids, q, k, g, cols, q_ten, npq, mask):
    """The library yardstick of K5 (timed here, never called by the port):
    per chunk of 8 queries the candidate rows gathered by ``index_select``,
    scored by ``bmm`` (the int8 form's codes widened to f32, then the two
    scales) and cut by ``torch.topk`` per tier."""
    import torch

    from lazzaro_tpu_torch.ops.ivf_topk import ivf_candidates
    from lazzaro_tpu_torch.ops.quant import quantize_rows

    int8 = isinstance(rows, tuple)
    if int8:
        codes, scale = rows
        qq, qs = quantize_rows(q)
        qv = qq.float()
    else:
        qv = q.to(rows.dtype)
    nq, d = q.shape
    m_w = members.shape[1]
    pm = cids.shape[1] * m_w

    def run():
        out = []
        for i in range(0, nq, 8):
            cand = ivf_candidates(members, extras, cids[i:i + 8])
            safe = torch.clamp(cand, min=0).long()
            c, length = cand.shape
            if int8:
                vecs = codes.index_select(0, safe.flatten()).view(c, length, d)
                s = torch.bmm(vecs.float(), qv[i:i + 8, :, None])[:, :, 0]
                s = (s * qs[i:i + 8, None]) * scale[safe]
            else:
                vecs = rows.index_select(0, safe.flatten()).view(c, length, d)
                s = torch.bmm(vecs, qv[i:i + 8, :, None])[:, :, 0].float()
            if mask is not None:
                out.append(torch.topk(torch.where((cand >= 0) & mask[safe], s,
                                                  -1e30), k))
                continue
            alive, tenant, sup = cols
            pos = torch.arange(length, device=cand.device)
            ok = ((cand >= 0) & alive[safe]
                  & (tenant[safe] == q_ten[i:i + 8, None])
                  & ((pos >= pm)[None, :]
                     | ((pos // m_w)[None, :] < npq[i:i + 8, None])))
            out.append(torch.topk(torch.where(ok & ~sup[safe], s, -1e30), k))
            out.append(torch.topk(torch.where(ok & sup[safe], s, -1e30), g))
        return out

    return run


def phase_ivf_kernel(device):
    """K5 against its plain version on the card, bit-equal, at the IVF
    drive's shapes: tables of phase 4's build geometry (``ivf_tables``)
    over the 1,048,576 x 768 arena of the two-tier cases, bf16 and f32;
    the exact form at the chat turn's Q = 1 (nprobe 8) and a fleet's Q =
    64 (per-request nprobe 1, 4, 8), k = 128 + 8 and a top-1 gate; the int8
    form over the arena's shadow (g = 1 + 8); the classic form at a
    search's Q = 1 and a batch's Q = 64 (k = 10 + 8). The queries are
    Gaussian, so the f32 sums round and the two agree only because both
    sum in one order (``ivf_topk.lane_dot``). Every case passes the tables'
    occupancy (``occ``, ``n_extras``), as the index does; two more cases
    take a table of empty, full and built clusters (a fleet), and a tenant
    with two rows, whose lists fill through the slots the walk skips (a
    chat turn). Each row's bound counts the rows this case's queries load;
    stage 1 (``gv_stage1``) and stage 2 (``gv_select``) are timed apart."""
    import torch

    from lazzaro_tpu_torch.ops import ivf_topk as k5
    from lazzaro_tpu_torch.ops.quant import quantize_rows

    (emb16, alive, tenant, sup), _ = fused_cases(device)
    members, extras, n_extras = ivf_tables(alive, sup, device)
    occ = (members >= 0).sum(dim=1).int()
    sparse, sparse_occ = ivf_sparse(members, alive, device)
    gen = torch.Generator(device=device).manual_seed(10)
    cols = (alive, tenant, sup)


    def batch(nq):
        cids = torch.argsort(torch.rand((nq, IVF_C), generator=gen,
                                        device=device), dim=1)[:, :IVF_P].int()
        q = torch.randn((nq, DIM), generator=gen, device=device)
        q_ten = torch.tensor([i % 2 for i in range(nq)], dtype=torch.int32,
                             device=device)
        npq = torch.tensor([IVF_P] if nq == 1 else
                           [IVF_NPROBES[i % 3] for i in range(nq)],
                           dtype=torch.int32, device=device)
        return cids, q, q_ten, npq

    chat, fleet = batch(1), batch(64)
    # On the sparse tables, a chat query whose first cluster is empty and
    # whose second holds the two rows of its tenant: its lists fill with
    # the empty cluster's slots, which the walk skips.
    few_cids = chat[0].clone()
    few_cids[0, :2] = torch.tensor([0, 2], device=device)   # empty, as built
    few_tenant = tenant.clone()
    few_tenant[sparse[2, :2].long()] = 9
    few = (few_cids, chat[1], torch.full_like(chat[2], 9), chat[3])
    shadow = quantize_rows(emb16)
    classic_mask = alive & (tenant == 0)
    slots = IVF_P * IVF_M + IVF_E
    rows_out = []
    for dtype in (torch.bfloat16, torch.float32):
        emb = emb16 if dtype == torch.bfloat16 else emb16.float()
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        built = (members, occ, tenant)
        cases = [(f"chat_q1_np8_{tag}", "exact", emb, chat, IVF_K, 1, built),
                 (f"fleet_q64_np1-4-8_{tag}", "exact", emb, fleet, IVF_K, 1,
                  built)]
        if dtype == torch.bfloat16:
            cases += [("chat_int8_q1_np8", "int8", shadow, chat, IVF_K, IVF_G,
                       built),
                      ("fleet_int8_q64_np1-4-8", "int8", shadow, fleet, IVF_K,
                       IVF_G, built),
                      ("search_classic_q1_k18_bf16", "classic", emb, chat, 18, 0,
                       built),
                      ("batch_classic_q64_k18_bf16", "classic", emb, fleet, 18,
                       0, built),
                      ("fleet_sparse_q64_np1-4-8_bf16", "exact", emb, fleet,
                       IVF_K, 1, (sparse, sparse_occ, tenant)),
                      ("chat_fill_q1_np8_bf16", "exact", emb, few, IVF_K, 1,
                       (sparse, sparse_occ, few_tenant))]
        for label, form, rows, (cids, q, q_ten, npq), k, g, tabs in cases:
            nq = q.shape[0]
            mem, occ_t, ten = tabs
            if form == "classic":
                kw = dict(mask=classic_mask)
                qv = q
                n_valid = ivf_valid(mem, extras, cids,
                                    lambda c: classic_mask[c.clamp(min=0).long()],
                                    torch.full_like(npq, IVF_P))
            else:
                kw = dict(g=g, cols=(alive, ten, sup), q_tenant=q_ten,
                          nprobe_q=npq)
                qv = (q / q.norm(dim=1, keepdim=True) if form == "int8"
                      else q.to(dtype).float())
                n_valid = ivf_valid(
                    mem, extras, cids,
                    lambda c, q_ten=q_ten, ten=ten: (
                        alive[c.clamp(min=0).long()]
                        & (ten[c.clamp(min=0).long()] == q_ten[:, None])), npq)
            kw.update(occ=occ_t, n_extras=n_extras)

            def run(rows=rows, mem=mem, cids=cids, qv=qv, k=k, kw=kw):
                return k5.ivf_topk(rows, mem, extras, cids, qv, k, **kw)

            def plain(rows=rows, mem=mem, cids=cids, qv=qv, k=k, kw=kw):
                return k5.ivf_topk_reference(rows, mem, extras, cids, qv,
                                             k, **kw)

            got = run()
            err = _check_equal(label, [t for t in got if t is not None],
                               [t for t in plain() if t is not None])
            fill = got[0][0] <= -1e29
            if label.startswith("chat_fill") and not (
                    int(fill.sum()) >= k // 2 and bool((got[2][0][fill] == -1).any())):
                raise AssertionError(f"{label}: the list did not fill "
                                     "through the skipped slots")
            item = 1 if form == "int8" else emb.element_size()
            b = ivf_bound(int(n_valid.sum()), DIM, item, nq, slots, k, g,
                          10 if form == "int8" else 6)
            lib = ivf_library(rows, mem, extras, cids, qv, k, g,
                              (alive, ten, sup), q_ten, npq,
                              classic_mask if form == "classic" else None)
            row = _case_row("ivf_topk", form, label, k5.route_for(form),
                            emb.shape[0], nq, k, run, plain, lib, b, err, 20,
                            2, stage1="gv_stage1", merge="gv_select")
            row["live_rows_loaded"] = int(n_valid.sum())
            row["candidates_per_query"] = slots
            rows_out.append(row)
        del emb
    return rows_out


def ingest_bound(emb, nq, k, modes, with_probe=True):
    """(bound_ms, bound_by) of the ingest scan: the arena and its row
    columns (alive, tenant, is_super, shard, the two exclusion masks: 12
    bytes a row) and the queries with their shard read once, the probe and
    every mode's [Q, k] list written once; 2*N*d*Q operations at the arena
    type's peak."""
    n, d = emb.shape
    item = emb.element_size()
    moved = (n * d * item + 12 * n + nq * (d * item + 4)
             + nq * (8 * with_probe + 8 * k * modes))
    ops = 2.0 * n * d * nq
    peak = PEAK_OPS["bfloat16" if item == 2 else "float32"]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ingest_corners(device):
    """K1 on a 20,000-row grid arena, both routes, against its plain
    version: a tenant with fewer eligible rows than k (its tail the lowest
    other rows at -1e30), an empty tenant (probe (-1e30, row 0)), mode -1,
    and a live sentinel row of the tenant (never listed)."""
    import torch

    from lazzaro_tpu_torch.ops import ingest_topk as it

    gen = torch.Generator(device=device).manual_seed(5)
    n, k = 20_000, 8
    for dtype in (torch.bfloat16, torch.float32):
        emb = grid_values(gen, (n, DIM), dtype, device)
        alive = torch.rand(n, generator=gen, device=device) < 0.9
        ten = torch.zeros(n, dtype=torch.int32, device=device)
        sup = torch.zeros(n, dtype=torch.bool, device=device)
        shard = torch.randint(0, 3, (n,), generator=gen, device=device).int()
        few = torch.tensor([5, 77, 1_000, n - 1], device=device)
        alive[few] = True
        ten[few] = 1                          # 3 rows and the live sentinel
        excl = torch.arange(n, device=device) == n - 1
        q = emb[few].clone()
        for tenant in (1, 2):                 # tenant 2 owns no row
            args = (emb, alive, ten, sup, shard, excl, excl, q, shard[few],
                    tenant, k, (-1, 0))
            got = it.ingest_topk(*args)
            _check_equal(f"ingest corners {dtype} tenant {tenant}", got,
                         it.ingest_topk_reference(*args))
            if tenant == 1 and (got[5][0, 3:].tolist() != [0, 1, 2, 3, 4]
                                or (torch.cat([got[1].view(-1), got[3].view(-1),
                                               got[5].view(-1)]) == n - 1).any()):
                raise AssertionError("ingest corners: short tenant's tail or "
                                     "the sentinel row is wrong")
            if tenant == 2 and not ((got[0] == -1e30).all()
                                    and (got[1] == 0).all()):
                raise AssertionError("empty tenant's probe is not (-1e30, row 0)")
    log("[kernels] ingest_topk corners (few rows, empty tenant, mode -1, live "
        "sentinel) equal on both routes")


def phase_ingest_kernel(device):
    """K1, the ingest mode of the top-k scan, and the dedup resolve kernel
    at the fused ingest's shapes on the 1,048,576 x 768 arena (bf16, then
    the default f32), against their plain versions; grid values, so rows,
    verdicts and scores must be equal. The arena has two tenants, one live
    sentinel row of tenant 0 (probe- and link-excluded), 12 shards; half of
    each batch repeats arena rows (probe duplicates). The f32 batches of a
    conversation end (Q = 1, 8, 16) take the streaming stage in one launch
    and no ``masked_topk`` launch; each is also timed with the FMA stage
    forced."""
    import torch

    from lazzaro_tpu_torch.ops import dedup_resolve as dr
    from lazzaro_tpu_torch.ops import ingest_topk as it
    from lazzaro_tpu_torch.ops import masked_topk as mt

    gen = torch.Generator(device=device).manual_seed(3)
    n = ARENA_ROWS
    emb16 = grid_values(gen, (n, DIM), torch.bfloat16, device)
    alive = torch.rand(n, generator=gen, device=device) < 0.9
    ten = (torch.rand(n, generator=gen, device=device) < 0.5).int()
    sup = (torch.rand(n, generator=gen, device=device) < 0.01) & alive
    shard = torch.randint(0, len(TOPICS), (n,), generator=gen, device=device).int()
    alive[-1] = True
    ten = torch.where(alive, ten, -1).int()
    ten[-1] = 0
    probe_excl = torch.arange(n, device=device) == n - 1
    rows_out, resolve_in = [], None
    emb32 = None
    for label, dtype, nq, with_probe in (
            ("ingest_q8192_k3_bf16", torch.bfloat16, PER_CONV, True),
            ("ingest_q16_k3_bf16", torch.bfloat16, 16, True),
            ("link_q8192_k3_bf16", torch.bfloat16, PER_CONV, False),
            ("ingest_q8192_k3_f32", torch.float32, PER_CONV, True),
            ("ingest_q1_k3_f32", torch.float32, 1, True),
            ("ingest_q8_k3_f32", torch.float32, 8, True),
            ("ingest_q16_k3_f32", torch.float32, 16, True)):
        if dtype == torch.float32 and emb32 is None:
            emb32 = emb16.float()
        emb = emb16 if dtype == torch.bfloat16 else emb32
        batch = torch.randperm(n - 1, generator=gen, device=device)[:nq]
        # half repeats arena rows (probe duplicates), the last eighth
        # repeats new facts (intra-batch duplicates)
        q = torch.cat([emb[batch[:nq // 2]],
                       grid_values(gen, (nq - nq // 2, DIM), dtype, device)])
        q[nq - nq // 8:] = q[nq // 2:nq // 2 + nq // 8].clone()
        qs = torch.randint(0, len(TOPICS), (nq,), generator=gen, device=device).int()
        link_excl = probe_excl.index_fill(0, batch, True)
        args = (emb, alive, ten, sup, shard, probe_excl, link_excl, q, qs, 0, 3,
                (1, 0), with_probe)
        got = it.ingest_topk(*args)
        err = _check_equal(label, got, it.ingest_topk_reference(*args))
        if (torch.cat([x.view(-1) for x in got[1::2]]) == n - 1).any():
            raise AssertionError(f"{label}: the excluded sentinel row was listed")
        if label == "ingest_q8192_k3_bf16":
            resolve_in = (q, batch, got[0][:, 0], got[1][:, 0])
        pmask = alive & (ten == 0) & ~sup & ~probe_excl
        lmask = pmask & ~link_excl

        def lib(emb=emb, q=q, qs=qs, pmask=pmask, lmask=lmask,
                with_probe=with_probe):
            # Yardstick only: chunked products, the masks, torch.topk a mode.
            for i in range(0, q.shape[0], 512):
                s = torch.matmul(q[i:i + 512], emb.t()).float()
                if with_probe:
                    torch.topk(torch.where(pmask, s, -1e30), 1)
                same = qs[i:i + 512, None] == shard[None, :]
                torch.topk(torch.where(lmask & same, s, -1e30), 3)
                torch.topk(torch.where(lmask, s, -1e30), 3)

        big = nq > 1024
        route = it.route_for(dtype, nq, DIM)
        rows_out.append(_case_row(
            "ingest_topk", "ingest" if with_probe else "link", label, route, n,
            nq, 3, lambda args=args: it.ingest_topk(*args),
            lambda args=args: it.ingest_topk_reference(*args), lib,
            ingest_bound(emb, nq, 3, 2, with_probe), err, 2 if big else 20,
            1 if big else 3, stage1="stage1"))
        if route == "stream":
            # One launch, no masked_topk launch; then the FMA stage forced,
            # the route these batches took before the streaming ingest mode.
            before = (it.launches, it.launches_stream, mt.launches)
            it.ingest_topk(*args)
            seen = (it.launches - before[0], it.launches_stream - before[1],
                    mt.launches - before[2])
            if seen != (1, 1, 0):
                raise AssertionError(f"{label}: (K1, streamed, masked_topk) "
                                     f"launches {seen}, not (1, 1, 0)")
            forced = f"{label}_forced_fma"
            err = _check_equal(forced, it._launch(*args, route="fma"),
                               it.ingest_topk_reference(*args))
            rows_out.append(_case_row(
                "ingest_topk", "ingest", forced, "fma", n, nq, 3,
                lambda args=args: it._launch(*args, route="fma"),
                lambda args=args: it.ingest_topk_reference(*args), lib,
                ingest_bound(emb, nq, 3, 2, with_probe), err, 20, 3,
                stage1="stage1"))
    del emb32
    ingest_corners(device)

    # The resolve of the Q = 8,192 batch: the gram of its facts, the probe
    # the kernel just took as a cosine (grid rows are not unit vectors),
    # shard groups by topic.
    q, batch, p_s, p_r = resolve_in
    qf = torch.nn.functional.normalize(q.float(), dim=1)
    norms = q.float().norm(dim=1) * emb16[p_r.long()].float().norm(dim=1)
    p_s = torch.where(p_s > -1e29, p_s / norms.clamp(min=1e-9), p_s)
    b = qf.shape[0]
    gram = qf @ qf.t()
    del qf
    valid = torch.ones(b, dtype=torch.bool, device=device)
    gid = torch.randint(0, len(TOPICS), (b,), generator=gen, device=device).int()
    cols = (p_s.contiguous(), p_r.contiguous(), valid, batch.int(), gid)
    resolve_rows = resolve_cases(gram, cols, n - 1)
    return rows_out, resolve_rows


RESOLVE_GATE = 0.95                # MemoryConfig.dedup_similarity


def resolve_bound(valid, gram_form):
    """(bound_ms, "bytes") of one resolve call: the gram's strict lower
    triangle at the valid columns (4 bytes a float, the gram form only),
    then a fact's columns read once (p_s, p_r, rows, chain_gid 4 bytes,
    valid 1; g_s and g_j 4 more in the walk form) and its outputs written
    once (target and chain_src 4 bytes, dup 1). The arg-max and the walk do
    no arithmetic worth the card's peak."""
    import torch

    b = valid.shape[0]
    later = (b - 1 - torch.arange(b, device=valid.device)) * valid
    moved = (4 * int(later.sum()) if gram_form else 8 * b) + 17 * b + 9 * b
    return 1e3 * moved / HBM_BYTES_PER_S, "bytes"


def resolve_cases(gram, cols, cap):
    """The dedup resolve at the fill's mega-batch (B = 8,192) against its
    plain version, bit for bit: the gram form (stage A, the arg-max over the
    triangle, and stage B, the walk, timed apart), the walk form on the
    composition's (g_s, g_j), and the deepest chain (each fact a duplicate
    of the one before). Prints the composition the gram form replaced (the
    ``[B, B]`` mask, ``masked_fill``, ``argmax``, ``gather``) timed on the
    card. ``plain_ms`` is the plain version on the card tensors: the
    composition on the card, then the loop on the host."""
    import torch

    from lazzaro_tpu_torch.ops import dedup_resolve as dr

    p_s, p_r, valid, rows, gid = cols
    b = rows.shape[0]

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    def case(label, form, fn, plain_fn, want, with_gram):
        got = fn()
        for g, w in zip(got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"dedup_resolve {label}: the kernel "
                                     f"disagrees with the plain version")
        plain = host_ms(plain_fn)
        # Each stage's mean over the events the trace shows: a window can
        # miss an event, and a sum over the calls would then read low.
        kernels = _device_kernels(fn, 20)
        seen = {}
        for stage, name in (("A", "resolve_gram_argmax"), ("B", "resolve_walk")):
            evs = [e for e in kernels if name in e.key]
            n = sum(e.count for e in evs)
            ms = sum(e.self_device_time_total for e in evs) / 1e3
            seen[stage] = (ms / n if n else 0.0, n)
        ms = seen["A"][0] + seen["B"][0]
        bms, by = resolve_bound(valid, with_gram)
        dups = int(want[1].sum())
        log(f"[kernels] dedup_resolve {label}: target, dup, chain_src equal "
            f"({dups} duplicates), device ms {ms:.4f} (stage A "
            f"{seen['A'][0]:.4f}, stage B {seen['B'][0]:.4f}; the trace shows "
            f"{seen['A'][1]} and {seen['B'][1]} of 20 calls' launches), plain "
            f"ms {plain:.1f}, library_ms none, bound_ms {bms:.6f} ({by}), "
            f"{bms / ms:.3f} of it")
        return dups, {"kernel": "dedup_resolve", "form": form, "case": label,
                      "route": "cuda", "n": b, "q": b, "k": 0, "ms": ms,
                      "stage_a_ms": seen["A"][0], "stage_b_ms": seen["B"][0],
                      "plain_ms": plain, "library_ms": None, "bound_ms": bms,
                      "bound_by": by, "max_abs_err": 0.0}

    out = []
    cpu = [c.cpu() for c in cols]
    want = dr.dedup_resolve_gram_reference(gram.cpu(), *cpu, RESOLVE_GATE, cap)
    dups, row = case(
        f"dedup_resolve_gram_b{b}", "gram",
        lambda: dr.dedup_resolve_gram(gram, *cols, RESOLVE_GATE, cap),
        lambda: dr.dedup_resolve_gram_reference(gram, *cols, RESOLVE_GATE, cap),
        want, True)
    if not 0 < dups < b:
        raise AssertionError(f"dedup_resolve case has {dups} duplicates of {b}")
    out.append(row)

    # What the gram form replaced: the composition on the card.
    removed = device_ms(lambda: dr.gram_argmax_reference(gram, valid), 10)
    log(f"[kernels] dedup_resolve: the composition the gram form replaced "
        f"(the [B, B] earlier mask, masked_fill, argmax, gather) device ms "
        f"{removed:.4f} at B = {b}; the gram form {row['ms']:.4f}; the walk "
        f"form's kernel alone below")
    row["replaced_composition_ms"] = removed

    g_s, g_j = dr.gram_argmax_reference(gram, valid)
    walk_in = (g_s, g_j.int()) + tuple(cols)
    want_walk = dr.dedup_resolve_reference(*[c.cpu() for c in walk_in],
                                           RESOLVE_GATE, cap)
    for g, w in zip(want_walk, want):
        if not torch.equal(g, w):
            raise AssertionError("dedup_resolve: the walk form's plain version "
                                 "disagrees with the gram form's")
    out.append(case(
        f"dedup_resolve_walk_b{b}", "walk",
        lambda: dr.dedup_resolve(*walk_in, RESOLVE_GATE, cap),
        lambda: dr.dedup_resolve_reference(*walk_in, RESOLVE_GATE, cap),
        want_walk, False)[1])
    del g_s, g_j, walk_in

    # The deepest chain: gram[i, i - 1] over the gate, 0.5 elsewhere.
    chain = torch.full_like(gram, 0.5)
    del gram
    idx = torch.arange(1, b, device=chain.device)
    chain[idx, idx - 1] = 0.99
    low = (torch.full_like(p_s, -1e30),) + tuple(cols[1:])
    want = dr.dedup_resolve_gram_reference(chain.cpu(), *[c.cpu() for c in low],
                                           RESOLVE_GATE, cap)
    if int(want[1].sum()) != b - 1 or not (want[0] == rows[0].cpu()).all():
        raise AssertionError("dedup_resolve: the chain case is not one chain")
    out.append(case(
        f"dedup_resolve_chain_b{b}", "gram",
        lambda: dr.dedup_resolve_gram(chain, *low, RESOLVE_GATE, cap),
        lambda: dr.dedup_resolve_gram_reference(chain, *low, RESOLVE_GATE, cap),
        want, True)[1])
    return out


PAIR_ROWS = 131_072                # arena rows of the K3 kernel cases
MERGE_SIM = 0.95                   # MemoryConfig.merge_similarity


def pairwise_bound(n_live, n, d, item, k=4):
    """(bound_ms, bound_by) of the all-pairs merge scan over the n_live
    rows of the mask in an n-row arena: the mask's rows read once (n_live *
    d * item) with the mask (n bytes), the [n, k] scores and rows written
    once; 2 * d * n_live * (n_live - 1) / 2 operations (the pairs j > i
    these inputs need) at the arena type's peak."""
    moved = n_live * d * item + n + n * k * 8
    ops = float(d) * n_live * (n_live - 1)
    peak = PEAK_OPS["bfloat16" if item == 2 else "float32"]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pairwise_library(emb, mask, rows, thr, k=4):
    """Yardstick only (the port never calls it): the library form of the
    scan for the query rows ``rows``, chunked products, the j > i and mask
    test with torch.where, torch.topk."""
    import torch

    n = emb.shape[0]
    col = torch.arange(n, device=emb.device)
    out = []
    for i in range(0, rows.shape[0], 512):
        r = rows[i:i + 512]
        s = torch.matmul(emb[r], emb.t()).float()
        valid = mask[r][:, None] & mask[None, :] & (col[None, :] > r[:, None])
        ts, tj = torch.topk(torch.where(valid, s, float("-inf")), k)
        out.append(torch.where(ts > thr, tj, -1))
    return out


def pairwise_arena(gen, n, dtype, device):
    """Grid rows of two tenants (the mask: tenant 0's live non-super rows)
    with planted near-duplicates of unit norm, exact in any summation
    order: 64 groups of a base and six rows that each move one entry of it
    (a full list of 4 for the base), 64 triples of identical rows (exact
    ties) and identical pairs at every offset 1 .. 258 across the diagonal
    of a 128 x 256 tile."""
    import torch

    emb = grid_values(gen, (n, DIM), dtype, device)
    ten = (torch.rand(n, generator=gen, device=device) < 0.5).int()
    alive = torch.rand(n, generator=gen, device=device) < 0.95
    sup = (torch.rand(n, generator=gen, device=device) < 0.01) & alive
    rows = torch.randperm(n, generator=gen, device=device).tolist()
    planted = []
    base = torch.zeros(DIM, device=device)
    base[:16] = 0.25
    for g in range(64):
        for m in range(7):
            v = base.roll(8 * g)
            if m:
                v[(8 * g + m) % DIM] -= m / 64
            planted.append((rows.pop(), v))
    for t in range(64):
        v = torch.zeros(DIM, device=device)
        v[[(t + o) % DIM for o in (0, 64, 128, 192)]] = 0.5
        planted += [(rows.pop(), v) for _ in range(3)]
    for delta in range(1, 259):
        i = (delta * 977) % (n - delta)
        v = torch.zeros(DIM, device=device)
        v[(300 + delta) % DIM] = 1.0
        planted += [(i, v), (i + delta, v)]
    for r, v in planted:
        emb[r] = v.to(dtype)
        ten[r], alive[r], sup[r] = 0, True, False
    return emb, alive & (ten == 0) & ~sup


def phase_pairwise_kernel(device):
    """K3, the pairwise mode of the top-k scan (the all-pairs merge scan of
    run_consolidation), on 131,072 x 768 grid arenas (bf16, then f32) of
    two tenants with planted near-duplicate groups, triples of identical
    rows and pairs across the diagonal at every offset: rows and scores
    equal to the plain version; device times of the kernel, the plain
    version and the library form beside the bound."""
    import torch

    from lazzaro_tpu_torch.ops import graphops as gops

    gen = torch.Generator(device=device).manual_seed(11)
    rows_out = []
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        label = f"pairwise_{PAIR_ROWS}_{name}"
        emb, mask = pairwise_arena(gen, PAIR_ROWS, dtype, device)
        got = gops.pairwise_merge_candidates(emb, mask, MERGE_SIM)
        want = gops.pairwise_merge_candidates_reference(emb, mask, MERGE_SIM)
        err = _check_equal(label, got, want)
        hits = int((got[1] >= 0).sum())
        full = int((got[1] >= 0).all(dim=1).sum())
        if hits < 258 + 64 * 3 or full < 64:
            raise AssertionError(f"{label}: {hits} pairs, {full} full lists")
        n_live = int(mask.sum())
        b_ms, b_by = pairwise_bound(n_live, PAIR_ROWS, DIM, emb.element_size())
        live_rows = mask.nonzero().view(-1)
        ms = device_ms(lambda: gops.pairwise_merge_candidates(emb, mask, MERGE_SIM), 3)
        plain = device_ms(
            lambda: gops.pairwise_merge_candidates_reference(emb, mask, MERGE_SIM), 1)
        lib = device_ms(lambda: pairwise_library(emb, mask, live_rows, MERGE_SIM), 1)
        log(f"[kernels] pairwise_topk {label} ({gops.route_for(dtype)} route): "
            f"rows and scores equal, {hits} pairs, {full} full lists, "
            f"{n_live} live rows, max_abs_err {err}, device ms {ms:.4f}, "
            f"plain_ms {plain:.4f}, library_ms {lib:.4f}, bound_ms {b_ms:.4f} "
            f"({b_by})")
        rows_out.append({"kernel": "pairwise_topk", "form": "pairwise",
                         "case": label, "route": gops.route_for(dtype),
                         "n": PAIR_ROWS, "q": n_live, "k": 4, "ms": ms,
                         "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                         "bound_by": b_by, "max_abs_err": err})
        del emb, mask, got, want
        torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------


def _unit_rows(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


class Corpus:
    """Deterministic clustered facts. Fact ``i`` belongs to conversation
    ``c = i // PER_CONV`` of tenant ``TENANTS[c % 2]``; its text is
    ``"fact <i>: user detail number <i>"`` and its vector is built from a
    topic direction, a group direction shared with the same slot of that
    tenant's conversations ``K`` apart, and its own noise. Every 101st fact
    is a near-duplicate (cosine ~0.97) of a fact of the tenant's previous
    conversation (of its predecessor in a tenant's first conversation)."""

    def __init__(self, n_facts: int, seed: int = 0):
        self.seed = seed
        convs = -(-n_facts // PER_CONV)
        self.k_groups = max(1, (convs // len(TENANTS)) // 4)
        self.topic_dirs = _unit_rows(np.random.default_rng([seed, 0])
                                     .standard_normal((len(TOPICS), DIM)))
        self._blocks: dict = {}

    def _block(self, kind: int, key: int) -> np.ndarray:
        got = self._blocks.get((kind, key))
        if got is None:
            if len(self._blocks) >= 8:
                self._blocks.pop(next(iter(self._blocks)))
            rng = np.random.default_rng([self.seed, kind, key])
            got = _unit_rows(rng.standard_normal((PER_CONV, DIM),
                                                 dtype=np.float32))
            self._blocks[(kind, key)] = got
        return got

    def _group_key(self, i: int) -> int:
        c = i // PER_CONV
        return (c % len(TENANTS)) * self.k_groups + (c // len(TENANTS)) % self.k_groups

    def topic(self, i: int) -> str:
        slot = self._group_key(i) * PER_CONV + i % PER_CONV
        return TOPICS[slot % len(TOPICS)]

    @staticmethod
    def is_dup(i: int) -> bool:
        return i > 0 and i % DUP_EVERY == DUP_EVERY - 1

    @staticmethod
    def dup_base(i: int) -> int:
        step = PER_CONV * len(TENANTS)
        return i - step if i >= step else i - 1

    @staticmethod
    def text(i: int) -> str:
        return f"fact {i}: user detail number {i}"

    def vectors(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        out = np.empty((len(idx), DIM), np.float32)
        for c in np.unique(idx // PER_CONV):
            sel = np.nonzero(idx // PER_CONV == c)[0]
            rows = idx[sel] % PER_CONV
            first = int(c) * PER_CONV
            gkey = self._group_key(first)
            slots = gkey * PER_CONV + rows
            v = (TOPIC_W * self.topic_dirs[slots % len(TOPICS)]
                 + GROUP_W * self._block(2, gkey)[rows]
                 + NOISE_W * self._block(1, int(c))[rows])
            out[sel] = v
        dups = np.nonzero([self.is_dup(int(i)) for i in idx])[0]
        if len(dups):
            base = self.vectors([self.dup_base(int(idx[j])) for j in dups])
            noise = np.stack([self._block(3, int(idx[j]) // PER_CONV)
                              [int(idx[j]) % PER_CONV] for j in dups])
            out[dups] = base + 0.25 * noise
        return _unit_rows(out)

    def payload(self, ids) -> str:
        return json.dumps({"memories": [
            {"content": self.text(i), "type": "semantic", "salience": 0.6,
             "topic": self.topic(i)} for i in ids]})


class CorpusEmbedder:
    """``fact <i>: ...`` texts embed to the corpus vector of fact ``i``; any
    other text to a unit vector seeded by its CRC32."""

    dim = DIM

    def __init__(self, corpus: Corpus):
        self.corpus = corpus
        self._memo: dict = {}

    def warm(self, texts) -> None:
        """Embed ``texts`` now, so that later single calls cost a lookup and
        the timed turns measure the system, not this generator."""
        self._memo.update(zip(texts, self.batch_embed(texts)))

    def _index(self, text: str):
        if text.startswith("fact ") and ":" in text:
            head = text[5:text.index(":")]
            if head.isdigit():
                return int(head)
        return None

    def batch_embed(self, texts):
        memo = [self._memo.get(t) for t in texts]
        if all(m is not None for m in memo):
            return np.stack(memo)
        idx = [self._index(t) for t in texts]
        out = np.empty((len(texts), DIM), np.float32)
        facts = [j for j, i in enumerate(idx) if i is not None]
        if facts:
            out[facts] = self.corpus.vectors([idx[j] for j in facts])
        for j, i in enumerate(idx):
            if i is None:
                rng = np.random.default_rng(zlib.crc32(texts[j].encode()))
                out[j] = _unit_rows(rng.standard_normal(DIM))
        return out

    def embed(self, text):
        got = self._memo.get(text)
        return (got if got is not None else self.batch_embed([text])[0]).tolist()


class PayloadLLM:
    """Extraction calls pop the next queued fact payload; chat calls answer
    "Noted." and keep the messages, so the smoke can see what was
    retrieved."""

    def __init__(self):
        self.payloads: deque = deque()
        self.last_messages = None

    def completion(self, messages, response_format=None):
        if response_format is not None:
            return self.payloads.popleft() if self.payloads else '{"memories": []}'
        self.last_messages = messages
        return "Noted."


def p50(xs):
    return float(np.percentile(np.asarray(xs, np.float64), 50))


def phase_main(launches_out: dict, parity: dict):
    """Phase 4; ``parity`` receives the snapshot the mesh phase must
    reproduce."""
    import torch

    from lazzaro_tpu_torch import MemoryConfig, MemorySystem
    from lazzaro_tpu_torch.ops import masked_topk as mt

    fill = FILL
    convs = fill // PER_CONV
    corpus = Corpus(ARENA_ROWS)
    llm = PayloadLLM()
    cfg = MemoryConfig(**FUSED_INGEST, dtype="bfloat16", embed_dim=DIM,
                       initial_capacity=ARENA_ROWS - 1, max_edges=4 * fill)
    torch.cuda.reset_peak_memory_stats()
    ms = MemorySystem(device="cuda", config=cfg, enable_async=False,
                      load_from_disk=False, max_buffer_size=2 * fill,
                      db_dir=store_dir("main"),
                      user_id=TENANTS[0], verbose=False, llm_provider=llm,
                      embedding_provider=CorpusEmbedder(corpus))
    try:
        summary, served = _drive(ms, llm, corpus, convs, fill, launches_out,
                                 mt, torch, snapshot=parity)
        summary["fused"] = _drive_fused(ms, corpus, served, launches_out,
                                        torch)
        summary["consolidation"] = _consolidate_filled(ms, launches_out, torch)
        summary["lifecycle"] = _lifecycle_filled(ms, torch)
        summary["checkpoint"], back = _checkpoint_filled(ms, corpus, summary,
                                                         torch)
        summary["quant"] = _quant_filled(ms, back, corpus, served,
                                         summary["fused"], launches_out, torch)
        summary["ivf"] = _ivf_filled(ms, back, corpus, served,
                                     summary["fused"], summary["quant"],
                                     launches_out, torch)
        return summary
    finally:
        shutil.rmtree(os.path.join(STORE_ROOT, "checkpoint"),
                      ignore_errors=True)
        ms.close()


LOW_SIM = 0.8                      # fills K3's lists on the filled arena
# Two f32 sums of the same 768 bf16 products in two orders: on corpus rows
# each lies up to ~1.2e-6 from the exact sum (H100 probe over 20,000
# pairs), and sqrt(d) * 2**-24 = 1.65e-6 is its rms bound, so the two may
# differ by ~3.3e-6; and a pair of rows whose exact scores are that close
# may come out in either order.
SUM_TOL = 4e-6


def _check_k3_filled(emb, mask, torch):
    """K3 held against its plain version on the filled arena, at the main
    path's shape and data, before the consolidation. One plain call at
    ``LOW_SIM``, where the corpus's group partners (cosine ~0.84) fill the
    lists of about every row, on the mask's rows gathered in ascending
    order (rows outside the mask hold no pair; a monotone gather keeps
    every pair's products and the tie order), mapped back to arena rows;
    then the kernel on the whole arena at ``LOW_SIM`` and at the merge gate
    (the plain lists at the gate are those at ``LOW_SIM`` whose score beats
    it: the top 4 do not depend on the threshold). The arena's rows are not
    grid values, so the two sum a pair in other orders: scores must agree
    within ``SUM_TOL`` where both hold the same row, and a slot whose rows
    differ passes only as a tie that order decides, both picks' f64 scores
    within ``SUM_TOL`` of each other (or, against a -1, the pick's f64
    score within ``SUM_TOL`` of the threshold). Returns a summary."""
    from lazzaro_tpu_torch.ops import graphops as gops
    from lazzaro_tpu_torch.ops.topk import NEG_INF

    live = mask.nonzero().view(-1)
    t = time.perf_counter()
    s_c, j_c = gops.pairwise_merge_candidates_reference(
        emb[live], torch.ones_like(live, dtype=torch.bool), LOW_SIM)
    torch.cuda.synchronize()
    out = {"plain_s": time.perf_counter() - t}
    want_s = torch.full((emb.shape[0], 4), NEG_INF, device=emb.device)
    want_j = torch.full((emb.shape[0], 4), -1, dtype=torch.int32, device=emb.device)
    want_s[live] = s_c
    want_j[live] = torch.where(j_c >= 0, live[j_c.clamp(min=0).long()].int(), -1)
    del s_c, j_c
    for thr in (LOW_SIM, MERGE_SIM):
        got = gops.pairwise_merge_candidates(emb, mask, thr)
        keep = want_s > thr
        want = (torch.where(keep, want_s, NEG_INF), torch.where(keep, want_j, -1))
        label = f"pairwise filled arena at {thr}"
        same = got[1] == want[1]
        both = same & (got[1] >= 0)
        err = float((got[0] - want[0]).abs().where(both, 0.0).max())
        if err > SUM_TOL:
            raise AssertionError(f"{label}: score error {err} > {SUM_TOL}")
        bad = (~same).any(dim=1).nonzero().view(-1).tolist()
        if len(bad) > 64:
            raise AssertionError(f"{label}: {len(bad)} rows differ")
        ties = 0
        for i in bad:
            q = emb[i].double()
            for g, w in zip(got[1][i].tolist(), want[1][i].tolist()):
                if g == w:
                    continue
                sg = float(emb[g].double() @ q) if g >= 0 else thr
                sw = float(emb[w].double() @ q) if w >= 0 else thr
                if abs(sg - sw) > SUM_TOL:
                    raise AssertionError(
                        f"{label}: row {i} holds {g} ({sg}) where the plain "
                        f"version holds {w} ({sw}): not a tie")
                ties += 1
        hits = int((got[1] >= 0).sum())
        out[str(thr)] = {"pairs": hits, "max_abs_err": err, "tie_slots": ties,
                         "rows_differing": len(bad)}
    if out[str(LOW_SIM)]["pairs"] < live.shape[0] // 4:
        raise AssertionError(f"pairwise filled arena: only "
                             f"{out[str(LOW_SIM)]['pairs']} pairs at {LOW_SIM}")
    return out


def _stage_seconds(tel, marks):
    """Seconds by stage from the ``consolidation.stage_ms`` timer samples
    recorded since ``marks`` (timer key -> sample count)."""
    out = {}
    for key, samples in list(tel.timers.items()):
        if not key.startswith("consolidation.stage_ms{"):
            continue
        stage = key.split('"')[1]
        new = list(samples)[marks.get(key, 0):]
        out[stage] = out.get(stage, 0.0) + sum(new) / 1e3
    return out


def _consolidate_filled(ms, launches_out, torch):
    """One ``run_consolidation`` of the current tenant on the filled
    1,048,576-row bf16 arena, half full (the fill itself runs with
    ``auto_consolidate=False``: 64 conversations would consolidate 21
    times). First K3 is held against its plain version on this arena
    (:func:`_check_k3_filled`). Then the consolidation: its seconds by stage
    from the system's own ``consolidation.stage_ms`` spans (host wall time;
    ``pairs`` is the K3 launch, its one readback and the decode), its
    counts, the device memory it took at its peak; then K3's time at this
    shape beside its bound, twice: on the arena as the consolidation calls
    it (the mask over every row) and on the tenant's rows alone (gathered
    beforehand, an all-true mask), so the share of the arena's rows past
    the live ones is measured; and the library form timed on 8,192 query
    rows and scaled to the tenant's rows."""
    from lazzaro_tpu_torch.ops import graphops as gops

    # The serving phase's strict readback (sync debug mode "error" after
    # each copy) goes: the consolidation's host work waits on the device.
    ms.index.__dict__.pop("_readback", None)
    tid = ms.index._tenants[ms.user_id]
    st = ms.index.state
    mask = st.alive & (st.tenant_id == tid) & ~st.is_super
    n_live = int(mask.sum())
    check = _check_k3_filled(st.emb, mask, torch)
    del mask
    gc.collect()
    torch.cuda.empty_cache()

    tel = ms.telemetry
    marks = {k: len(v) for k, v in tel.timers.items()}
    nodes_before = ms.buffer.size()[0]
    gops.launches = gops.launches_wgmma = 0
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = ms.run_consolidation()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    launches_out["pairwise_topk"] = gops.launches
    if (gops.launches, gops.launches_wgmma) != (1, 1):
        raise AssertionError(f"consolidation made {gops.launches} K3 launches "
                             f"({gops.launches_wgmma} on the tensor cores), not 1")
    spans = _stage_seconds(tel, marks)
    pairs = int(tel.gauges["consolidation.merge_pairs"])
    comps = int(tel.gauges["consolidation.components"])
    if pairs != check[str(MERGE_SIM)]["pairs"]:
        raise AssertionError(f"consolidation read {pairs} pairs, the checked "
                             f"scan {check[str(MERGE_SIM)]['pairs']}")
    mask = st.alive & (st.tenant_id == tid) & ~st.is_super
    # CUDA events: a call of ~0.6 s dwarfs the host's share, and a
    # profiler window has missed this kernel's events (0.94 of ~665 ms).
    k3_ms = cuda_ms(lambda: gops.pairwise_merge_candidates(st.emb, mask,
                                                           MERGE_SIM), 1)
    # Both bounds count the rows the timed calls scan (the tenant's after
    # the merge).
    emb_live = st.emb[mask]
    n_timed = emb_live.shape[0]
    b_ms, b_by = pairwise_bound(n_timed, st.emb.shape[0], DIM,
                                st.emb.element_size())
    all_live = torch.ones(n_timed, dtype=torch.bool, device=emb_live.device)
    k3_live_ms = cuda_ms(lambda: gops.pairwise_merge_candidates(
        emb_live, all_live, MERGE_SIM), 1)
    live_b_ms, _ = pairwise_bound(n_timed, n_timed, DIM, st.emb.element_size())
    del emb_live, all_live
    q_rows = mask.nonzero().view(-1)[:8192]
    lib_8192 = cuda_ms(lambda: pairwise_library(st.emb, mask, q_rows,
                                                MERGE_SIM), 1)
    lib_scaled = lib_8192 * n_live / q_rows.shape[0]
    merged = nodes_before - ms.buffer.size()[0]
    out = {"seconds": total, "stage_s": spans, "k3_event_ms": k3_ms,
           "k3_bound_ms": b_ms, "k3_bound_by": b_by,
           "k3_live_rows_event_ms": k3_live_ms, "k3_live_rows_bound_ms": live_b_ms,
           "k3_timed_rows": n_timed, "n_live": n_live,
           "pairs": pairs, "merged": merged, "components": comps,
           "nodes_before": nodes_before, "peak_gib_over_held": peak_gib,
           "held_gib": held / 2 ** 30, "k3_check": check,
           "library_ms_8192_rows": lib_8192,
           "library_ms_scaled_to_tenant": lib_scaled,
           "result": result.splitlines()}
    low = check[str(LOW_SIM)]
    log(f"[main] K3 on the filled arena against its plain version: at "
        f"{LOW_SIM} {low['pairs']} pairs, rows equal but {low['tie_slots']} "
        f"tie slots, max_abs_err {low['max_abs_err']}; at {MERGE_SIM} "
        f"{check[str(MERGE_SIM)]['pairs']} pairs (plain version "
        f"{check['plain_s']:.1f} s)")
    log(f"[main] run_consolidation on the filled arena ({n_live} live rows of "
        f"tenant {ms.user_id}): {total:.2f} s; stages (s) "
        f"{ {k: round(v, 3) for k, v in spans.items()} }; {pairs} pairs, "
        f"{merged} merged, {comps} components; device memory at its peak "
        f"{peak_gib:.2f} GiB over the {held / 2 ** 30:.2f} GiB held; K3 "
        f"{k3_ms:.2f} ms by CUDA events on the arena (bound {b_ms:.2f}, "
        f"{b_by}), {k3_live_ms:.2f} ms on the tenant's rows alone (bound "
        f"{live_b_ms:.2f}); library "
        f"form {lib_8192:.2f} ms on {q_rows.shape[0]} query rows, scaled to "
        f"the tenant's rows {lib_scaled:.1f} ms (scaled, not run)")
    return out


# ---------------------------------------------------------------------------
# The all-tenant lifecycle sweep and the index checkpoint on the filled arena
# ---------------------------------------------------------------------------

LIFECYCLE_K = 8                    # MemoryConfig.lifecycle_archive_k


def _lifecycle_kw(ms) -> dict:
    cfg = ms.config
    return dict(rate=cfg.decay_rate, salience_floor=cfg.salience_floor,
                prune_threshold=cfg.prune_threshold,
                weights=(cfg.importance_w_salience, cfg.importance_w_access,
                         cfg.importance_w_recency),
                archive_k=LIFECYCLE_K)


def _unstrict_index(index) -> None:
    """Drop the serving phase's strict wrappers (:func:`_strict_dispatch`)
    from ``index``: the checks after it wait on the device by design."""
    for name in ("_readback", "search_fused_requests"):
        index.__dict__.pop(name, None)


def _classic_twin(index):
    """A second view of ``index`` for the classic loop: the columns the
    lifecycle writes (salience, edge weight and alive) cloned on the card,
    the edge bookkeeping copied, everything else shared and only read."""
    import copy
    import dataclasses

    from lazzaro_tpu_torch.core.index import _EdgeSlotMap

    twin = copy.copy(index)
    twin.state = dataclasses.replace(index.state,
                                     salience=index.state.salience.clone())
    es = index.edge_state
    twin.edge_state = dataclasses.replace(es, weight=es.weight.clone(),
                                          alive=es.alive.clone())
    twin.edge_slots = _EdgeSlotMap(dict(index.edge_slots))
    twin._free_edge_slots = list(index._free_edge_slots)
    return twin


def _classic_loop(index, tenants, kw, now):
    """decay, prune_edges and evict_candidates per tenant (the classic
    loop of ``MemorySystem._lifecycle_classic``)."""
    removed, verdicts = [], {}
    for t in tenants:
        index.decay(t, kw["rate"], kw["salience_floor"])
        removed.extend(index.prune_edges(t, kw["prune_threshold"]))
        verdicts[t] = index.evict_candidates(t, kw["archive_k"], now=now,
                                             weights=kw["weights"])
    return removed, verdicts


def _profile_once(fn, torch):
    """One call of ``fn`` under ``torch.profiler``: its kernels (count and
    device ms) and its device-to-host copies, as the trace shows them
    (None where the profiler recorded no device event)."""
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == cuda]
    kernels = [e for e in evs if not e.key.startswith(("Memcpy", "Memset"))]
    if not sum(e.self_device_time_total for e in kernels):
        return {"kernels": None, "device_ms": None, "dtoh_copies": None}
    return {"kernels": sum(e.count for e in kernels),
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "dtoh_copies": sum(e.count for e in evs if "DtoH" in e.key)}


def lifecycle_bound(rows: int, edges: int):
    """The sweep's least time: each column it reads once (salience, alive,
    tenant id, last access, access count, super bit of every row; weight,
    alive and tenant id of every edge slot) and each it writes once
    (salience; weight, alive) over the HBM rate. Its operations are a few
    per element, far under the bytes."""
    read = rows * (4 + 1 + 4 + 4 + 4 + 1) + edges * (4 + 1 + 4)
    written = rows * 4 + edges * (4 + 1)
    return (read + written) / HBM_BYTES_PER_S * 1e3, "bytes"


def _lifecycle_filled(ms, torch) -> dict:
    """One ``MemoryIndex.lifecycle_sweep`` over both tenants of the filled
    arena against the classic loop on a twin of its states: the same
    salience, edge weight and edge alive bits, removed edges and verdicts.
    Then each path's kernels, device ms and device-to-host copies by one
    profiled call on the twin, the sweep program's device ms over three
    calls and its bytes bound."""
    from lazzaro_tpu_torch.core import state as S

    index = ms.index
    _unstrict_index(index)
    kw = _lifecycle_kw(ms)
    tenants = [t for t in TENANTS if t in index._tenants]
    passes = {t: 1 for t in tenants}
    now = time.time()
    twin = _classic_twin(index)
    reads = []
    inner = index._readback

    def counted(packed):
        reads.append(tuple(packed.shape))
        return inner(packed)

    index._readback = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fused = index.lifecycle_sweep(passes, now=now, **kw)
    finally:
        del index._readback
    fused_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    removed, verdicts = _classic_loop(twin, tenants, kw, now)
    torch.cuda.synchronize()
    classic_ms = (time.perf_counter() - t0) * 1e3
    same = {
        "salience": torch.equal(index.state.salience.view(torch.int32),
                                twin.state.salience.view(torch.int32)),
        "edge_weight": torch.equal(index.edge_state.weight.view(torch.int32),
                                   twin.edge_state.weight.view(torch.int32)),
        "edge_alive": torch.equal(index.edge_state.alive, twin.edge_state.alive),
        "removed_edges": sorted(fused["removed_edges"]) == sorted(removed),
        "verdicts": all([(n, i) for n, i, _ in fused["verdicts"][t]]
                        == verdicts[t] for t in tenants)}
    if not all(same.values()) or len(reads) != 1 or fused["dispatches"] != 1 \
            or not all(fused["verdicts"][t] for t in tenants):
        raise AssertionError(f"lifecycle sweep vs the classic loop: {same}, "
                             f"readbacks {reads}, dispatches "
                             f"{fused['dispatches']}")
    rows, edges = index.state.salience.shape[0], index.edge_state.src.shape[0]
    prof_f = _profile_once(lambda: twin.lifecycle_sweep(passes, now=now, **kw),
                           torch)
    prof_c = _profile_once(lambda: _classic_loop(twin, tenants, kw, now), torch)
    dev = index.device
    pt = torch.zeros((8,), dtype=torch.int32, device=dev)
    for t in tenants:
        pt[index._tenants[t]] = 1
    tids = torch.tensor([index._tenants[t] for t in tenants]
                        + [-1] * (8 - len(tenants)), dtype=torch.int32,
                        device=dev)
    args = (pt, tids, kw["rate"], kw["salience_floor"], kw["prune_threshold"],
            now - index.epoch, *kw["weights"])
    cap = index._prune_cap()
    sweep_dev = device_ms(lambda: S.lifecycle_sweep(
        twin.state, twin.edge_state, *args, prune_cap=cap,
        archive_k=LIFECYCLE_K), 3)
    b_ms, b_by = lifecycle_bound(rows, edges)
    out = {"rows": rows, "edge_slots": edges, "live_edges": len(twin.edge_slots),
           "decayed_rows": fused["decayed_rows"],
           "decayed_edges": fused["decayed_edges"],
           "pruned_edges": fused["pruned_edges"], "wall_ms": fused_ms,
           "classic_wall_ms": classic_ms, "readbacks": len(reads),
           "profiled": prof_f, "classic_profiled": prof_c,
           "sweep_device_ms_3_calls": sweep_dev, "bound_ms": b_ms,
           "bound_by": b_by, "prune_cap": cap}
    log(f"[main] lifecycle sweep over {len(tenants)} tenants of the filled "
        f"arena ({rows} rows, {edges} edge slots, {out['live_edges']} live "
        f"edges): {fused['decayed_rows']} rows and {fused['decayed_edges']} "
        f"edges decayed, {fused['pruned_edges']} pruned; salience, edge "
        f"weight and alive bits, removed edges and verdicts equal to the "
        f"classic loop; wall {fused_ms:.2f} ms (classic loop {classic_ms:.2f} "
        f"ms); one profiled call: sweep {prof_f}, classic loop {prof_c}; "
        f"the sweep program {sweep_dev:.3f} device ms a call over 3 calls, "
        f"bound {b_ms:.3f} ms ({b_by}); {len(reads)} readback")
    return out


def _searches_equal(a, b, corpus, torch) -> dict:
    """Classic ``search_batch`` and fused reads of both tenants on two
    indexes: the same rows and the same score bits. Kernel launch counts
    are restored after (a check, not the main path)."""
    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import masked_topk as mt
    from lazzaro_tpu_torch.ops import sharded_merge as sm
    from lazzaro_tpu_torch.serve.scheduler import RetrievalRequest

    counts = [(m, n, getattr(m, n)) for m in (mt, ft, sm)
              for n in ("launches", "launches_wgmma", "launches_stream",
                        "stage_launches") if hasattr(m, n)]
    facts = [c * PER_CONV + (331 * c) % PER_CONV for c in range(8)]
    q = corpus.vectors(facts)
    kw = dict(cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
              nbr_boost=0.02, now=time.time())
    out = {}
    try:
        for t in TENANTS:
            classic = [idx.search_batch(q, t, k=10) for idx in (a, b)]
            reqs = [RetrievalRequest(query=x, tenant=t, k=10, boost=False)
                    for x in q]
            fused = [[(r.ids, np.float32(r.scores).view(np.int32).tolist())
                      for r in idx.search_fused_requests(reqs, **kw)]
                     for idx in (a, b)]
            out[t] = {"classic": classic[0] == classic[1],
                      "fused": fused[0] == fused[1],
                      "nonempty": all(ids for ids, _ in classic[0])}
    finally:
        for m, n, v in counts:
            setattr(m, n, v)
    return out


def _checkpoint_filled(ms, corpus, single, torch):
    """``save_index`` of the filled index under the smoke's temporary
    directory and ``load_index`` of it onto the card: every column and the
    bookkeeping equal, the same classic and fused results; the seconds of
    each, the bytes on disk and the load's peak device memory beside the
    store reload's. Returns them and the loaded index (the quantized
    phase serves it next)."""
    from lazzaro_tpu_torch.core import checkpoint as ckpt

    index = ms.index
    path = os.path.join(STORE_ROOT, "checkpoint")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_index(index, path)
    save_s = time.perf_counter() - t0
    size = disk_bytes(path)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    back = ckpt.load_index(path, device=index.device, telemetry=ms.telemetry,
                           serve_ragged=index.serve_ragged,
                           serve_k_max=index.serve_k_max,
                           serve_pad_granularity=index.serve_pad_granularity)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    cols = {}
    for kind, names, sa, sb in (("arena", ckpt._ARENA_COLS, index.state, back.state),
                                ("edge", ckpt._EDGE_COLS, index.edge_state,
                                 back.edge_state)):
        for c in names:
            x, y = getattr(sa, c), getattr(sb, c)
            if x.is_floating_point():
                view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
                x, y = x.view(view), y.view(view)
            cols[f"{kind}_{c}"] = x.dtype == y.dtype and torch.equal(x, y)
    books = {"id_to_row": back.id_to_row == index.id_to_row,
             "edge_slots": dict(back.edge_slots) == dict(index.edge_slots),
             # a load keys every tenant, the live index those given rows
             "tenant_nodes": ({t: v for t, v in back.tenant_nodes.items() if v}
                              == {t: v for t, v in index.tenant_nodes.items()
                                  if v}),
             "tenants": back._tenants == index._tenants}
    served = _searches_equal(index, back, corpus, torch)
    ok = (all(cols.values()) and all(books.values())
          and all(all(v.values()) for v in served.values()))
    reload_s = round(sum(single["reload"]["load_s"].values()), 2)
    out = {"save_s": save_s, "load_s": load_s, "bytes_on_disk": size,
           "load_peak_gib_over_held": peak_gib, "held_gib": held / 2 ** 30,
           "columns_equal": all(cols.values()), "bookkeeping": books,
           "served": served, "store_reload_s": reload_s}
    if not ok:
        raise AssertionError(f"checkpoint round trip: columns {cols}, "
                             f"bookkeeping {books}, served {served}")
    log(f"[main] index checkpoint of the filled arena ({len(index)} rows, "
        f"{len(index.edge_slots)} edges): save {save_s:.2f} s, load "
        f"{load_s:.2f} s, {size} bytes on disk, the load's peak device "
        f"memory {peak_gib:.2f} GiB over the {held / 2 ** 30:.2f} GiB held "
        f"(the store's reload of tenant {TENANTS[0]}'s rows took "
        f"{reload_s} s); every column bit-equal, id map, edge slots and "
        f"tenants equal, classic and fused reads of both tenants equal "
        f"(rows and score bits)")
    return out, back


QUANT_TURNS = 8                    # chat turns and searches of the quant phase
QUANT_SCORE_TOL = 1e-5             # a rescore against the exact scan (bf16)


def _recall_and_scores(exact_res, quant_res) -> dict:
    """recall@10 of the quantized reads against the exact reads of the same
    queries, the largest |score| difference over the rows both return, and
    the gate verdicts and gate ids that differ."""
    hits = total = 0
    err = 0.0
    gates = 0
    for e, q in zip(exact_res, quant_res):
        e_ids = e.ids[:10]
        hits += len(set(e_ids) & set(q.ids[:10]))
        total += len(e_ids)
        es = dict(zip(e.ids, e.scores))
        for qid, sc in zip(q.ids, q.scores):
            if qid in es:
                err = max(err, abs(float(sc) - float(es[qid])))
        gates += (e.fast, e.gate_id) != (q.fast, q.gate_id)
    return {"recall_at_10": hits / max(total, 1), "max_abs_err": err,
            "gate_differs": gates, "queries": len(exact_res)}


def _drive_facts(corpus, served, seed, turns, suffix):
    """The facts a drive of the checkpoint's index serves: ``turns`` chat
    facts and ``turns`` search facts of the served tenant (none a duplicate
    or a target), the chat prompts (each fact, then ``suffix``), the 64
    batch facts (the targets first) and their texts. Returns ``(chats,
    searches, prompts, batch_facts, texts)``."""
    rng = np.random.default_rng(seed)
    own, targets = served["own"], served["targets"]
    facts = []
    while len(targets) + len(facts) < 64 or len(facts) < 2 * turns:
        i = int(rng.choice(own)) * PER_CONV + int(rng.integers(PER_CONV))
        if not corpus.is_dup(i) and i not in facts and i not in targets:
            facts.append(i)
    chats, searches = facts[:turns], facts[turns:2 * turns]
    prompts = [f"{corpus.text(i)}. {suffix}" for i in chats]
    batch_facts = (targets + facts)[:64]
    return (chats, searches, prompts, batch_facts,
            [corpus.text(i) for i in batch_facts])


def _drive_vectors(ms, corpus, prompts, facts, batch_facts):
    """The read batch of a drive's checks: the prompts' embeddings, then
    the vectors of ``facts`` and of the batch facts."""
    return np.stack([np.asarray(ms._get_embedding(p), np.float32)
                     for p in prompts] + list(corpus.vectors(facts))
                    + list(corpus.vectors(batch_facts)))


def _fleet_requests(corpus, batch_facts, nprobes=None):
    """A 64-request fleet of two tenants: alice's batch facts and bob's
    rows in turn, k = 5, 10 and 128 in turn (and ``nprobes`` in turn)."""
    from lazzaro_tpu_torch.serve import RetrievalRequest

    bob = [PER_CONV + 5 + 7 * j for j in range(32)]
    return [RetrievalRequest(
        query=corpus.vectors([batch_facts[j // 2] if j % 2 == 0
                              else bob[j // 2]])[0],
        tenant=TENANTS[j % 2], k=(5, 10, 128)[j % 3],
        nprobe=None if nprobes is None else nprobes[j % 3]) for j in range(64)]


def _quant_filled(ms, qidx, corpus, served, exact_fused, launches_out,
                  torch) -> dict:
    """Quantized serving on the filled arena: the index that
    :func:`_checkpoint_filled` loaded from its checkpoint, switched to
    ``int8_serving``, put in the system's place, and driven through the entry points the
    exact fused phase drives, on fewer turns: 8 chat turns, 8
    ``search_memories``, a 64-query ``search_memories_batch`` and a
    64-request two-tenant fleet, every dispatch one K4 keyed launch, no
    two-tier or classic launch, and one copy (sync debug mode "error"); a
    classic ``search_batch`` through K4's additive form; one transient
    ``index.dispatch`` fault on a chat turn, retried by the guard. Before
    any boost, read batches of the same queries on the exact and the
    quantized index give recall@10 of the quantized path, and every score
    the quantized path returns is held to the exact scan's score for the
    same row within ``QUANT_SCORE_TOL``."""
    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import int8_topk as k4
    from lazzaro_tpu_torch.ops import masked_topk as mt
    from lazzaro_tpu_torch.reliability.faults import INJECTOR
    from lazzaro_tpu_torch.serve import RetrievalRequest

    exact = ms.index
    qidx.int8_serving = True
    qidx.coarse_slack = ms.config.coarse_fetch_slack
    chats, searches, prompts, batch_facts, texts = _drive_facts(
        corpus, served, 13, QUANT_TURNS, "Anything new about it?")
    ms.embedder.warm(prompts + texts)
    kw = dict(cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
              nbr_boost=0.02, now=time.time())
    vecs = _drive_vectors(ms, corpus, prompts, chats + searches, batch_facts)

    t0 = time.perf_counter()
    qidx._int8_shadow_for(qidx.state)
    torch.cuda.synchronize()
    shadow_s = time.perf_counter() - t0
    reads = [RetrievalRequest(query=v, tenant=TENANTS[0], k=10, boost=False)
             for v in vecs]
    counts = [(m, n, getattr(m, n)) for m in (mt, ft)
              for n in ("launches", "launches_wgmma", "launches_stream",
                        "stage_launches")]
    exact_res = exact.search_fused_requests(reads, **kw)
    for m, n, v in counts:                   # a check, not the main path
        setattr(m, n, v)
    quant_res = qidx.search_fused_requests(reads, **kw)
    check = _recall_and_scores(exact_res, quant_res)
    if (check["max_abs_err"] > QUANT_SCORE_TOL or check["gate_differs"]
            or check["recall_at_10"] < 0.95):
        raise AssertionError(f"quantized reads against the exact ones: {check}")

    ms.index = qidx
    ms.config.int8_serving = True
    ms.query_cache.invalidate_results()
    retries0 = ms.telemetry.counter_total("serve.dispatch_retries")
    try:
        warm = ms.warmup_serving((1, 64))
        readbacks = _strict_dispatch(qidx, torch)
        k4.launches = k4.launches_keyed = k4.launches_dp4a = 0
        k4.launches_wgmma = 0
        k4.stage_launches = ft.launches = mt.launches = 0
        want = (1, 0, 0, 1)
        chat_ms, search_ms = [], []
        for j, p in enumerate(prompts):
            if j == QUANT_TURNS // 2:
                INJECTOR.clear()
                INJECTOR.arm("index.dispatch", times=1)
            before = (k4.launches_keyed, ft.launches, mt.launches,
                      len(readbacks))
            t1 = time.perf_counter()
            ms.chat(p)
            chat_ms.append(1e3 * (time.perf_counter() - t1))
            got = tuple(a - b for a, b in zip(
                (k4.launches_keyed, ft.launches, mt.launches, len(readbacks)),
                before))
            if got != want:
                raise AssertionError(f"quant chat turn made (K4 keyed, "
                                     f"two-tier, classic, copies) = {got}")
        fired = INJECTOR.fired("index.dispatch")
        INJECTOR.clear()
        retries = ms.telemetry.counter_total("serve.dispatch_retries") - retries0
        if fired != 1 or retries != 1:
            raise AssertionError(f"the transient fault fired {fired} times "
                                 f"and was retried {retries} times, not 1")
        for i in searches:
            before = (k4.launches_keyed, len(readbacks))
            t1 = time.perf_counter()
            hits = ms.search_memories(corpus.text(i))
            search_ms.append(1e3 * (time.perf_counter() - t1))
            if (k4.launches_keyed - before[0], len(readbacks) - before[1]) != (1, 1):
                raise AssertionError("quant search_memories is not one dispatch")
            if not hits or hits[0].content != corpus.text(i):
                raise AssertionError(f"quant search_memories missed fact {i}")

        def one_launch_p50(fn, what):
            runs = []
            for _ in range(3):
                before = k4.launches_keyed
                t1 = time.perf_counter()
                out = fn()
                runs.append(1e3 * (time.perf_counter() - t1))
                if k4.launches_keyed - before != 1:
                    raise AssertionError(f"quant {what} is not one dispatch")
            return p50(runs), out

        batch_ms, res = one_launch_p50(
            lambda: ms.search_memories_batch(texts, limit=10),
            "search_memories_batch(64)")
        for text, hits in zip(texts, res):
            if not hits or hits[0].content != text:
                raise AssertionError(f"quant batch search missed {text!r}")
        fleet = _fleet_requests(corpus, batch_facts)
        sched = ms._ensure_scheduler()
        fleet_ms, out = one_launch_p50(
            lambda: [f.result() for f in sched.submit_many(fleet)],
            "64-request fleet")
        for req, r in zip(fleet, out):
            if len(r.ids) != req.k or any(
                    not q.startswith(req.tenant + ":") for q in r.ids):
                raise AssertionError(f"quant fleet request of {req.tenant} "
                                     f"k={req.k} got {len(r.ids)} ids")
        torch.cuda.synchronize()
    finally:
        INJECTOR.clear()
        vars(qidx).pop("search_fused_requests", None)
        vars(qidx).pop("_readback", None)
        torch.cuda.set_sync_debug_mode(0)
        ms.index = exact
        ms.config.int8_serving = False
        ms.query_cache.invalidate_results()
    fused_launches = k4.launches
    before = k4.launches
    classic = qidx.search_batch(corpus.vectors(searches), TENANTS[0], k=10)
    torch.cuda.synchronize()
    if k4.launches - before != 1 or k4.launches_keyed != fused_launches:
        raise AssertionError("the classic int8 search is not one additive K4 launch")
    for i, (ids, _) in zip(searches, classic):
        node = ms.buffer.get_node(ids[0].partition(":")[2]) if ids else None
        if node is None or node.content != corpus.text(i):
            raise AssertionError(f"the classic int8 search missed fact {i}")
    launches_out["int8_topk"] = k4.launches
    launches_out["int8_topk_wgmma"] = k4.launches_wgmma
    launches_out["int8_topk_dp4a"] = k4.launches_dp4a
    if k4.launches_wgmma != k4.launches:
        raise AssertionError(f"{k4.launches_dp4a} K4 launches of the 768-wide "
                             f"shadow left the tensor cores")
    del qidx
    gc.collect()
    torch.cuda.empty_cache()
    out = {
        "shadow_build_s": shadow_s,
        "warmup_ms": {str(k): v for k, v in warm.items()},
        "chat_p50_ms": p50(chat_ms), "search_p50_ms": p50(search_ms),
        "batch64_p50_ms": batch_ms, "fleet64_mixed_k_p50_ms": fleet_ms,
        "exact_chat_miss_p50_ms": exact_fused["chat_miss_p50_ms"],
        "exact_search_p50_ms": exact_fused["search_p50_ms"],
        "exact_batch64_p50_ms": exact_fused["batch64_p50_ms"],
        "exact_fleet64_mixed_k_p50_ms": exact_fused["fleet64_mixed_k_p50_ms"],
        "k4_launches": k4.launches, "k4_keyed_launches": k4.launches_keyed,
        "k4_wgmma_launches": k4.launches_wgmma,
        "k4_kernels": k4.stage_launches, "dispatches_per_turn": 1,
        "copies_per_turn": 1, "readbacks": len(readbacks),
        "transient_fault_retries": retries, "reads_vs_exact": check}
    log(f"[quant] int8 serving on the filled arena (the checkpoint's index, "
        f"shadow of {len(exact)} rows built in {shadow_s:.3f} s): chat p50 "
        f"{out['chat_p50_ms']:.2f} ms (exact {out['exact_chat_miss_p50_ms']:.2f}), "
        f"search_memories p50 {out['search_p50_ms']:.2f} ms (exact "
        f"{out['exact_search_p50_ms']:.2f}), search_memories_batch(64) p50 "
        f"{batch_ms:.2f} ms (exact {out['exact_batch64_p50_ms']:.2f}), mixed-k "
        f"fleet(64) p50 {fleet_ms:.2f} ms (exact "
        f"{out['exact_fleet64_mixed_k_p50_ms']:.2f}); {k4.launches} K4 launches "
        f"({k4.launches_keyed} keyed, {k4.launches_wgmma} on the tensor cores, "
        f"{k4.stage_launches} kernels), one launch "
        f"and one copy a dispatch, 0 two-tier or classic launches; one "
        f"transient index.dispatch fault retried once; reads of "
        f"{check['queries']} queries against the exact path: recall@10 "
        f"{check['recall_at_10']:.4f}, max |score - exact score| "
        f"{check['max_abs_err']:.3g}, {check['gate_differs']} gate verdicts differ")
    return out


IVF_TURNS = 8                      # chat turns and searches of the IVF drive
IVF_INT8_TURNS = 4                 # chat turns with int8 serving composed
# Fused IVF reads against the classic IVF search of the same queries: the
# classic form scores the f32 query against the bf16 rows widened to f32
# (lazzaro_tpu/ops/ivf.py:ivf_search), the fused form the query rounded to
# bf16 (core/state.py:_ivf_two_tier), so scores at each rank agree within
# 2^-9 * |q| * |x| (a cosine: 2^-9) and rows may swap inside that band.
IVF_FORM_TOL = 2.0 ** -9


def _rank_scores_agree(ref, got, tol) -> dict:
    """Two runs of the same reads: per query the same ids, or lists whose
    scores at every rank agree within ``tol`` (rows swapped inside a near
    tie); raises otherwise. Returns the counts and the largest difference
    of the scores at one rank."""
    swaps, err = 0, 0.0
    for a, b in zip(ref, got):
        a_ids, a_s = (a.ids, a.scores) if hasattr(a, "ids") else a
        b_ids, b_s = (b.ids, b.scores) if hasattr(b, "ids") else b
        if len(a_ids) != len(b_ids):
            raise AssertionError(f"{len(a_ids)} ids against {len(b_ids)}")
        diff = max([abs(float(x) - float(y)) for x, y in zip(a_s, b_s)],
                   default=0.0)
        err = max(err, diff)
        if a_ids != b_ids:
            if diff > tol:
                raise AssertionError(f"ids differ past a near tie: {a_ids} "
                                     f"{a_s} against {b_ids} {b_s}")
            swaps += 1
    return {"queries": len(ref), "near_tie_swaps": swaps,
            "max_rank_score_diff": err}


def _ivf_filled(ms, qidx, corpus, served, exact_fused, quant, launches_out,
                torch) -> dict:
    """IVF serving on the filled arena: the index that
    :func:`_checkpoint_filled` loaded (after the quantized phase), with
    ``ivf_serving = IVF_P``: ``ivf_maintenance`` builds the coarse index
    (timed); reads of the same queries give recall@10 against the exact
    index, ``nprobe = C`` gives the exact rows, and the fused reads agree
    with the classic ``ivf_search`` of the same queries. Then, in the
    system's place: 8 chat turns, 8 ``search_memories``, a 64-query batch
    and a 64-request fleet with per-request ``nprobe`` (1, 4, 8), every
    dispatch one K5 launch (its coarse stage one masked top-k launch), no
    two-tier or K4 launch and one copy (sync debug mode "error"); one
    conversation end through the fused dedup ingest, whose one dispatch
    and one copy append the new rows to their clusters (appends and
    overflows counted); then 4 chat turns with ``int8_serving`` composed,
    each one K5 launch of the int8 form."""
    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import int8_topk as k4
    from lazzaro_tpu_torch.ops import ivf_topk as k5
    from lazzaro_tpu_torch.ops import masked_topk as mt
    from lazzaro_tpu_torch.serve import RetrievalRequest

    t_drive = time.perf_counter()
    exact = ms.index
    qidx.int8_serving = False
    qidx.ivf_nprobe = IVF_P
    qidx.ivf_online = True
    tel = ms.telemetry
    t0 = time.perf_counter()
    if not qidx.ivf_maintenance():
        raise AssertionError("ivf_maintenance built nothing")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ivf = qidx._ivf
    n_c, m_w = ivf.n_clusters, ivf.members.shape[1]
    occupied = int((ivf.members >= 0).sum())
    log(f"[ivf] ivf_maintenance over {len(qidx)} rows: {n_c} clusters of "
        f"{m_w} slots ({occupied} rows in clusters, "
        f"{int((ivf.residual >= 0).sum())} in the residual) in {build_s:.2f} s")

    _, searches, prompts, batch_facts, texts = _drive_facts(
        corpus, served, 17, IVF_TURNS, "What else?")
    int8_prompts = [p + " Int8?" for p in prompts[:IVF_INT8_TURNS]]
    ms.embedder.warm(prompts + int8_prompts + texts)
    kw = dict(cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
              nbr_boost=0.02, now=time.time())
    vecs = _drive_vectors(ms, corpus, prompts, searches, batch_facts)
    reads = [RetrievalRequest(query=v, tenant=TENANTS[0], k=10, boost=False)
             for v in vecs]
    counts = [(m, n, getattr(m, n)) for m in (mt, ft, k5)
              for n in ("launches", "launches_wgmma", "launches_stream",
                        "launches_int8", "launches_classic", "stage_launches")
              if hasattr(m, n)]
    try:                                     # checks, not the main path
        exact_res = exact.search_fused_requests(reads, **kw)
        ivf_res = qidx.search_fused_requests(reads, **kw)
        check = _recall_and_scores(exact_res, ivf_res)
        qidx.ivf_nprobe = n_c
        full = _rank_scores_agree(exact_res,
                                  qidx.search_fused_requests(reads, **kw),
                                  QUANT_SCORE_TOL)
        qidx.ivf_nprobe = IVF_P
        classic = qidx.search_batch(vecs, TENANTS[0], k=10, super_filter=-1)
        forms = _rank_scores_agree(classic, ivf_res, IVF_FORM_TOL)
    finally:
        for m, n, v in counts:
            setattr(m, n, v)
    if check["max_abs_err"] > QUANT_SCORE_TOL or check["recall_at_10"] <= 0:
        raise AssertionError(f"IVF reads against the exact ones: {check}")
    log(f"[ivf] reads of {check['queries']} queries: recall@10 "
        f"{check['recall_at_10']:.4f} against the exact index at nprobe "
        f"{IVF_P}, max |score - exact score| {check['max_abs_err']:.3g}, "
        f"{check['gate_differs']} gate verdicts differ; nprobe = C ({n_c}) "
        f"against exact: {full}; fused against classic ivf_search: {forms}")

    ms.index = qidx
    ms.config.ivf_serving = IVF_P
    ms.query_cache.invalidate_results()
    try:
        warm = ms.warmup_serving((1, 64))
        readbacks = _strict_dispatch(qidx, torch)
        for m, n in ((k5, "launches"), (k5, "launches_int8"),
                     (k5, "launches_classic"), (k5, "stage_launches"),
                     (mt, "launches"), (ft, "launches"), (k4, "launches")):
            setattr(m, n, 0)

        def made():
            return (k5.launches, mt.launches, ft.launches, k4.launches,
                    len(readbacks))

        def one_dispatch(fn, what):
            before = made()
            t1 = time.perf_counter()
            out = fn()
            ms_ = 1e3 * (time.perf_counter() - t1)
            got = tuple(a - b for a, b in zip(made(), before))
            if got != (1, 1, 0, 0, 1):
                raise AssertionError(f"IVF {what} made (K5, coarse masked "
                                     f"top-k, two-tier, K4, copies) = {got}")
            return ms_, out

        chat_ms = [one_dispatch(lambda p=p: ms.chat(p), "chat turn")[0]
                   for p in prompts]
        search_ms = []
        for i in searches:
            t, hits = one_dispatch(lambda i=i: ms.search_memories(corpus.text(i)),
                                   "search_memories")
            search_ms.append(t)
            if not hits or hits[0].content != corpus.text(i):
                raise AssertionError(f"IVF search_memories missed fact {i}")
        runs = [one_dispatch(lambda: ms.search_memories_batch(texts, limit=10),
                             f"search_memories_batch({len(texts)})")
                for _ in range(3)]
        hit = sum(bool(h) and h[0].content == t
                  for t, h in zip(texts, runs[-1][1]))
        fleet = _fleet_requests(corpus, batch_facts, IVF_NPROBES)
        sched = ms._ensure_scheduler()
        fleet_runs = [one_dispatch(
            lambda: [f.result() for f in sched.submit_many(fleet)],
            "64-request fleet") for _ in range(3)]
        for req, r in zip(fleet, fleet_runs[-1][1]):
            if not r.ids or any(not q.startswith(req.tenant + ":")
                                for q in r.ids):
                raise AssertionError(f"IVF fleet request of {req.tenant} "
                                     f"k={req.k} got {r.ids[:3]}")
        serve_k5 = k5.launches
        torch.cuda.synchronize()
        for name in ("search_fused_requests", "_readback"):
            vars(qidx).pop(name, None)
        torch.cuda.set_sync_debug_mode(0)

        # one conversation end through the fused dedup ingest, online IVF
        c = FILL // PER_CONV
        if TENANTS[c % len(TENANTS)] != ms.user_id:
            c += 1
        ingest_reads = _strict_ingest(qidx, torch)
        d0 = qidx.ingest_dispatch_count
        app0 = tel.counter_total("ivf.appends")
        ovf0 = tel.counter_total("ivf.member_overflows")
        fresh0 = len(qidx._ivf_fresh)
        occ0 = int(qidx._ivf_dev[2].sum())
        ms.llm.payloads.append(corpus.payload(range(c * PER_CONV,
                                                    (c + 1) * PER_CONV)))
        t1 = time.perf_counter()
        ms.start_conversation()
        ms.add_to_short_term(f"conversation {c}", "episodic", 0.5)
        ms.end_conversation()
        torch.cuda.synchronize()
        conv_s = time.perf_counter() - t1
        for name in ("ingest_batch_dedup", "_readback"):
            vars(qidx).pop(name, None)
        torch.cuda.set_sync_debug_mode(0)
        dispatches = qidx.ingest_dispatch_count - d0
        appends = tel.counter_total("ivf.appends") - app0
        overflows = tel.counter_total("ivf.member_overflows") - ovf0
        if dispatches != 1 or len(ingest_reads) != 1:
            raise AssertionError(f"the IVF conversation end made {dispatches} "
                                 f"dispatches and {len(ingest_reads)} copies")
        if appends <= 0 or int(qidx._ivf_dev[2].sum()) != occ0 + appends or (
                len(qidx._ivf_fresh) - fresh0 != overflows):
            raise AssertionError(f"online IVF: {appends} appends, "
                                 f"{overflows} overflows, fresh rows "
                                 f"{fresh0} -> {len(qidx._ivf_fresh)}")
        got = ms.search_memories(corpus.text(c * PER_CONV + 17))
        if not got or got[0].content != corpus.text(c * PER_CONV + 17):
            raise AssertionError("a fact of the IVF conversation end is not "
                                 "served")

        # int8 serving composed on the IVF program
        qidx.int8_serving = True
        qidx.coarse_slack = ms.config.coarse_fetch_slack
        qidx._int8_shadow_for(qidx.state)
        torch.cuda.synchronize()
        readbacks = _strict_dispatch(qidx, torch)
        i8_0, k5_0 = k5.launches_int8, k5.launches
        int8_ms = [one_dispatch(lambda p=p: ms.chat(p), "int8 chat turn")[0]
                   for p in int8_prompts]
        if (k5.launches_int8 - i8_0, k5.launches - k5_0) != (IVF_INT8_TURNS,
                                                             IVF_INT8_TURNS):
            raise AssertionError("an int8 IVF chat turn is not one K5 launch "
                                 "of the int8 form")
        torch.cuda.synchronize()
    finally:
        for name in ("search_fused_requests", "_readback",
                     "ingest_batch_dedup"):
            vars(qidx).pop(name, None)
        torch.cuda.set_sync_debug_mode(0)
        ms.index = exact
        ms.config.ivf_serving = 0
        ms.query_cache.invalidate_results()
    launches_out["ivf_topk"] = k5.launches
    launches_out["ivf_topk_by_route"] = {
        "fma": k5.launches - k5.launches_int8, "dp4a": k5.launches_int8}
    out = {
        "build_s": build_s, "clusters": n_c, "member_slots": m_w,
        "rows_in_clusters": occupied,
        "warmup_ms": {str(k): v for k, v in warm.items()},
        "chat_p50_ms": p50(chat_ms), "search_p50_ms": p50(search_ms),
        "batch64_p50_ms": p50([t for t, _ in runs]),
        "batch64_self_hits": hit,
        "fleet64_nprobe_1_4_8_p50_ms": p50([t for t, _ in fleet_runs]),
        "int8_chat_p50_ms": p50(int8_ms),
        "exact_chat_miss_p50_ms": exact_fused["chat_miss_p50_ms"],
        "exact_search_p50_ms": exact_fused["search_p50_ms"],
        "exact_batch64_p50_ms": exact_fused["batch64_p50_ms"],
        "exact_fleet64_mixed_k_p50_ms": exact_fused["fleet64_mixed_k_p50_ms"],
        "quant_chat_p50_ms": quant["chat_p50_ms"],
        "quant_batch64_p50_ms": quant["batch64_p50_ms"],
        "reads_vs_exact": check, "nprobe_c_vs_exact": full,
        "fused_vs_classic": forms, "conversation_end_s": conv_s,
        "ingest_dispatches": dispatches, "ingest_copies": len(ingest_reads),
        "online_appends": appends, "online_overflows": overflows,
        "drive_s": time.perf_counter() - t_drive,
        "k5_launches": k5.launches, "k5_serving_launches": serve_k5,
        "k5_int8_launches": k5.launches_int8, "k5_kernels": k5.stage_launches,
        "dispatches_per_turn": 1, "copies_per_turn": 1}
    log(f"[ivf] IVF serving on the filled arena (nprobe {IVF_P} of {n_c}): "
        f"chat p50 {out['chat_p50_ms']:.2f} ms (exact "
        f"{out['exact_chat_miss_p50_ms']:.2f}, int8 {quant['chat_p50_ms']:.2f}, "
        f"IVF with int8 {out['int8_chat_p50_ms']:.2f}), search_memories p50 "
        f"{out['search_p50_ms']:.2f} ms (exact {out['exact_search_p50_ms']:.2f}), "
        f"search_memories_batch({len(texts)}) p50 {out['batch64_p50_ms']:.2f} "
        f"ms (exact {out['exact_batch64_p50_ms']:.2f}, {hit}/{len(texts)} self "
        f"hits), fleet(64, "
        f"nprobe 1/4/8) p50 {out['fleet64_nprobe_1_4_8_p50_ms']:.2f} ms (exact "
        f"mixed-k {out['exact_fleet64_mixed_k_p50_ms']:.2f}); one K5 launch, "
        f"one coarse masked top-k launch and one copy a dispatch; the "
        f"conversation end ({PER_CONV} facts) one dispatch and one copy in "
        f"{conv_s:.2f} s, {appends} online appends, {overflows} overflows "
        f"into the extras; {k5.launches} K5 launches ({k5.launches_int8} of "
        f"the int8 form, {k5.stage_launches} kernels); the IVF drive took "
        f"{out['drive_s']:.1f} s")
    return out


def phase_guard(device) -> dict:
    """The state dispatch guard on the card (``reliability.guard``): two
    twin bf16 indexes of 20,000 rows with int8 serving; a transient
    ``index.dispatch`` fault on a boosting fused dispatch of one is retried,
    and every arena, edge and shadow column of the two stays bit-equal;
    then a mutation that fails after its first write (the poison hook)
    raises ``ArenaPoisoned``, every later touch raises it too, and
    ``load_index`` of a checkpoint taken before gives an index bit-equal to
    the twin that never failed, serving the same."""
    import torch

    from lazzaro_tpu_torch import MemoryIndex
    from lazzaro_tpu_torch.core import checkpoint as ckpt
    from lazzaro_tpu_torch.core import state as S
    from lazzaro_tpu_torch.reliability.errors import ArenaPoisoned
    from lazzaro_tpu_torch.reliability.faults import (INJECTOR,
                                                      poison_states_hook)
    from lazzaro_tpu_torch.serve.scheduler import RetrievalRequest
    from lazzaro_tpu_torch.utils.telemetry import Telemetry

    n = 20_000
    emb = np.random.default_rng(21).standard_normal((n, DIM)).astype(np.float32)
    ids = [f"g{i}" for i in range(n)]

    def build():
        idx = MemoryIndex(DIM, capacity=n + 64, dtype="bfloat16", device=device,
                          int8_serving=True, epoch=0.0, telemetry=Telemetry())
        idx.add(ids, emb, [0.5] * n, [0.0] * n, ["semantic"] * n, ["s"] * n,
                "t", is_super=[i % 500 == 0 for i in range(n)])
        idx.add_edges([(ids[i], ids[i + 1], 0.7) for i in range(0, 4000, 2)],
                      "t", now=1.0)
        return idx

    def reqs(boost):
        return [RetrievalRequest(query=emb[i * 97] + 0.01, tenant="t", k=10,
                                 boost=boost) for i in range(8)]

    def equal(x, y):
        for fields, sx, sy in ((S.ARENA_FIELDS, x.state, y.state),
                               (S.EDGE_FIELDS, x.edge_state, y.edge_state)):
            for c in fields:
                u, v = getattr(sx, c), getattr(sy, c)
                if u.is_floating_point():
                    view = torch.int16 if u.dtype == torch.bfloat16 else torch.int32
                    u, v = u.view(view), v.view(view)
                if not torch.equal(u, v):
                    return False
        return (x._int8_shadow is None or y._int8_shadow is None
                or all(torch.equal(u, v) for u, v in zip(x._int8_shadow,
                                                        y._int8_shadow)))

    kw = dict(cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
              nbr_boost=0.02, now=50.0)
    a, b = build(), build()
    path = os.path.join(STORE_ROOT, "guard_checkpoint")
    INJECTOR.clear()
    try:
        INJECTOR.arm("index.dispatch", times=1)
        ra = a.search_fused_requests(reqs(True), **kw)
        rb = b.search_fused_requests(reqs(True), **kw)
        torch.cuda.synchronize()
        fired = INJECTOR.fired("index.dispatch")
        retried = a.telemetry.counter_total("serve.dispatch_retries")
        same = [x.ids == y.ids and x.scores == y.scores for x, y in zip(ra, rb)]
        parity = equal(a, b)
        if fired != 1 or retried != 1 or not all(same) or not parity:
            raise AssertionError(f"transient fault: fired {fired}, retried "
                                 f"{retried}, results equal {same}, state "
                                 f"bit-equal {parity}")
        ckpt.save_index(a, path)
        INJECTOR.arm("index.dispatch", times=1, hook=poison_states_hook)
        touches = []
        for what, fn in (
                ("update_access", lambda: a.update_access(["g1"], now=60.0)),
                ("search_fused_requests",
                 lambda: a.search_fused_requests(reqs(False), **kw)),
                ("search_batch", lambda: a.search_batch(emb[:2], "t", k=3)),
                ("add", lambda: a.add(["x"], emb[:1], [0.5], [0.0],
                                      ["semantic"], ["s"], "t"))):
            try:
                fn()
                touches.append((what, "no error"))
            except ArenaPoisoned:
                touches.append((what, "ArenaPoisoned"))
        if not a.poisoned or any(t != "ArenaPoisoned" for _, t in touches):
            raise AssertionError(f"poisoned index: {touches}")
        t0 = time.perf_counter()
        back = ckpt.load_index(path, device=device, int8_serving=True,
                               telemetry=Telemetry())
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        back_r = back.search_fused_requests(reqs(False), **kw)
        b_r = b.search_fused_requests(reqs(False), **kw)
        back._int8_shadow_for(back.state)
        recovered = equal(back, b) and all(
            x.ids == y.ids and x.scores == y.scores for x, y in zip(back_r, b_r))
        if not recovered:
            raise AssertionError("load_index did not recover the twin's state")
    finally:
        INJECTOR.clear()
        shutil.rmtree(path, ignore_errors=True)
    log(f"[guard] transient index.dispatch fault on a fused boosting dispatch: "
        f"fired once, retried once, results and every arena, edge and shadow "
        f"column bit-equal to the twin's; a mutation failing after its first "
        f"write raised ArenaPoisoned, and so did {[w for w, _ in touches[1:]]}; "
        f"load_index ({load_s:.2f} s) gave the twin's columns and reads")
    return {"transient_retries": retried, "poisoned_touches": touches,
            "recovered": recovered, "load_s": load_s}


DEFAULT_CONVS = 9                  # consolidates at conversations 3, 6 and 9
DEFAULT_WORDS = [f"{a}{b}" for a in ("ka", "zu", "rin", "tol", "vex", "mar",
                                     "qui", "dro", "pel", "sna")
                 for b in ("bo", "di", "fa", "gu", "ho", "ji", "ku", "lo",
                           "mi", "no")]


def default_turns(c: int):
    """Conversation c of the default-config run: three turns of two or
    three sentences of made-up words around a topic keyword (HeuristicLLM
    makes a fact of each sentence; with the chat turn a conversation ends
    with at most 16 facts, the batch size below which an f32 probe
    streams); every third sentence repeats one of conversation c - 1 with a
    word added, and every fourth repeats it as it was."""
    rng = np.random.default_rng([17, c])
    topics = ("project", "family", "course", "exercise", "travel")
    turns, prev = [], None if c == 0 else default_turns.cache.get(c - 1)
    sentences = []
    for t in range(3):
        parts = []
        for j in range(2 + (t % 2)):
            i = len(sentences)
            if prev and i % 4 == 3:
                text = prev[i % len(prev)]
            elif prev and i % 3 == 2:
                text = prev[i % len(prev)] + " " + str(rng.choice(DEFAULT_WORDS))
            else:
                words = rng.choice(DEFAULT_WORDS, size=int(rng.integers(6, 14)))
                text = (f"I {rng.choice(('like', 'plan', 'study', 'visit'))} "
                        f"the {topics[(c + t + j) % len(topics)]} "
                        + " ".join(words))
            sentences.append(text)
            parts.append(text + ".")
        turns.append(" ".join(parts))
    default_turns.cache[c] = sentences
    return turns


default_turns.cache = {}


def _strict_phase(ms, torch):
    """Run the conversation end's device work of ``ms`` under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    wait on the device: the fused ingest dispatch, the consolidation's merge
    scan and every save. Inside them only the designed device-to-host
    copies may wait, and each is recorded as (context, copy): the ingest's
    and the merge scan's packed readback, and the save's pull of the rows
    and of the edges it dirtied (``pull_numeric_rows``,
    ``edge_weights_for``). Each save also records what it was due to pull:
    the rows when a dirty node has a row, the edges when an edge is dirty.
    Returns (copies, saves)."""
    index = ms.index
    copies, saves, ctx = [], [], []

    def strict(name, fn):
        def run(*args, **kwargs):
            ctx.append(name)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                ctx.pop()
                torch.cuda.set_sync_debug_mode("error" if ctx else 0)
        return run

    def allowed(name, fn):
        def run(*args, **kwargs):
            if ctx:
                copies.append((ctx[-1], name))
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("error" if ctx else 0)
        return run

    save = strict("save", ms._save_to_persistence)

    def due_save():
        saves.append((
            any(ms._q(n) in index.id_to_row for n in ms._dirty_nodes),
            bool(ms._dirty_edges)))
        return save()

    index.ingest_batch_dedup = strict("ingest", index.ingest_batch_dedup)
    index.merge_candidates = strict("merge", index.merge_candidates)
    ms._save_to_persistence = due_save
    for name in ("_readback", "pull_numeric_rows", "edge_weights_for"):
        setattr(index, name, allowed(name, getattr(index, name)))
    return copies, saves


def _unstrict(ms):
    for name in ("ingest_batch_dedup", "merge_candidates", "_readback",
                 "pull_numeric_rows", "edge_weights_for"):
        vars(ms.index).pop(name, None)
    vars(ms).pop("_save_to_persistence", None)


def _ranked(ms, queries):
    """Each query's ranking over the tenant (k = 64) as (score, ids at that
    score) groups: a reload places rows in other arena rows, which may
    order exact ties differently."""
    out = []
    for q in queries:
        ids, scores = ms.index.search(np.asarray(ms.embedder.embed(q),
                                                 np.float32),
                                      ms.user_id, k=64, super_filter=-1)
        groups: dict = {}
        for i, sc in zip(ids, scores):
            groups.setdefault(sc, set()).add(i)
        out.append(sorted(groups.items(), reverse=True))
    return out


def _salience_bits(ms, torch):
    sal = ms.index.state.salience.view(torch.int32).cpu().numpy()
    return {q: int(sal[r]) for q, r in ms.index.id_to_row.items()}


def phase_default(launches_out: dict) -> dict:
    """The default configuration on the card: ``MemorySystem()`` with
    nothing overridden but ``enable_async=False`` (and ``verbose=False``,
    which is logging, not configuration) and its ``db_dir``: an f32 768-d
    arena, ``HashingEmbedder``, ``HeuristicLLM``, fused serving and the
    fused dedup ingest, ``auto_consolidate`` every 3 conversations, the
    ``ArrowStore`` saved at every conversation end and both journals. Nine
    conversations (a chat turn in each) consolidate at 3, 6 and 9, each
    through one K3 launch on the FMA route; under
    ``torch.cuda.set_sync_debug_mode("error")`` each ingest, merge scan and
    save waits on the card only in its designed copies
    (:func:`_strict_phase`). Then a restart: ``close()`` and a new
    ``MemorySystem(load_from_disk=True)`` on the same ``db_dir``, which must
    serve the same rankings and profile and hold the same salience bits in
    every row (rows stamped at early passes replay the passes they missed).
    Then a crash: turns added and a fact batch appended to the ingest
    journal, half of it facts that already landed, and the system dropped
    without ``end_conversation``; the next start recovers the turns and
    replays the batch through the fused ingest on the card (one dispatch:
    K1, the resolve kernel, one readback), merging the landed facts and
    ingesting the rest once. Then the f32 counterpart of phase 4b's
    comparison: the same dialogue with eviction out of the way
    (``max_buffer_size`` 10,000; at the default of 10 the two ingests evict
    among equal importances in their own row order) and the dedup gate at
    0.99, above the merge gate, so that the near-duplicates arrive as nodes
    and the consolidations merge them on the card; once on the fused ingest
    (its probe and link lists in one K1 launch on the streaming stage, no
    ``masked_topk`` launch) and once on the classic ingest
    (``ingest_fused=False, ingest_dedup_fused=False``: the probe in
    ``search_batch``, ``masked_topk`` on the streaming stage's additive
    mode, which scores every pair with K1's probe's bits): nodes must
    merge, and node ids and contents, edge keys and the profile must be
    equal. Every K1 launch of the phase streams and no ``masked_topk``
    launch happens in the default dialogue or the crash replay."""
    import torch

    from lazzaro_tpu_torch import MemoryConfig, MemorySystem
    from lazzaro_tpu_torch.core.index import MemoryIndex
    from lazzaro_tpu_torch.ops import dedup_resolve as dr
    from lazzaro_tpu_torch.ops import graphops as gops
    from lazzaro_tpu_torch.ops import ingest_topk as it
    from lazzaro_tpu_torch.ops import masked_topk as mt

    def drive(ms, mark=None):
        ends = []
        for c in range(DEFAULT_CONVS):
            ms.start_conversation()
            for turn in default_turns(c):
                ms.add_to_short_term(turn, "semantic", 0.6)
            ms.chat(f"What do I remember about the {('project', 'family')[c % 2]}?")
            torch.cuda.synchronize()
            if mark is not None:
                mark.append(c)
            t = time.perf_counter()
            ms.end_conversation()
            torch.cuda.synchronize()
            ends.append(time.perf_counter() - t)
        return ends

    def record(ms):
        def sid(nid):        # super-node ids carry their creation second
            return _stable_id(f"{ms.user_id}:{nid}")
        return ({sid(nid): n.content for nid, n in ms.buffer.nodes.items()},
                sorted((sid(a), sid(b)) for a, b in ms.buffer.edges),
                dict(ms.profile.data))

    db = store_dir("default")
    ms = MemorySystem(enable_async=False, verbose=False, db_dir=db)
    cfg = ms.config
    if not (cfg.dtype == "float32" and cfg.embed_dim == 768 and cfg.serve_fused
            and cfg.ingest_dedup_fused and cfg.auto_consolidate
            and cfg.consolidate_every == 3 and cfg.journal
            and cfg.ingest_journal and cfg.load_from_disk):
        raise AssertionError(f"unexpected default configuration: {cfg}")
    copies, saves = _strict_phase(ms, torch)
    gops.launches = gops.launches_wgmma = 0
    mt.launches = mt.launches_wgmma = mt.launches_stream = 0
    it.launches = it.launches_wgmma = it.launches_stream = dr.launches = 0
    dr.launches_card = 0
    try:
        ends = drive(ms)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        _unstrict(ms)
    path = {"pairwise_topk": gops.launches, "ingest_topk": it.launches,
            "dedup_resolve": dr.launches, "masked_topk": mt.launches}
    k3 = (gops.launches, gops.launches_wgmma)
    k1 = (it.launches, it.launches_stream, mt.launches)
    reads = {what: [c for c in copies if c[0] == what]
             for what in ("ingest", "merge", "save")}
    due = [["pull_numeric_rows"] * rows + ["edge_weights_for"] * edges
           for rows, edges in saves]
    pulled = [c[1] for c in reads["save"]]
    resolve = (dr.launches, dr.launches_card)
    if (k3 != (3, 0) or not k1[0] or k1[1] != k1[0] or k1[2]
            or resolve != (DEFAULT_CONVS, 2 * DEFAULT_CONVS)
            or len(reads["merge"]) != 3
            or len(reads["ingest"]) != DEFAULT_CONVS
            or pulled != [p for d in due for p in d]
            or not any(d == ["pull_numeric_rows", "edge_weights_for"]
                       for d in due)):
        raise AssertionError(f"default config: K3 launches {k3}; (K1, K1 "
                             f"streamed, masked_topk) launches {k1}; "
                             f"(resolve calls, launches_card) {resolve}; "
                             f"copies {copies}; saves due {due}")
    log(f"[default] MemorySystem() (f32 768-d, fused serving and ingest, "
        f"auto_consolidate every 3, ArrowStore, both journals): "
        f"{DEFAULT_CONVS} conversations, {len(ms.buffer.nodes)} nodes at "
        f"the buffer limit, {k3[0]} K3 launches (FMA route), {k1[0]} K1 "
        f"launches ({k1[1]} on the streaming stage: probe and link lists in "
        f"one pass), {k1[2]} masked_topk launches, {resolve[0]} "
        f"dedup_resolve calls (one an end; launches_card {resolve[1]}); "
        f"under sync debug mode "
        f"\"error\" the device-to-host "
        f"copies were {len(reads['ingest'])} ingest readbacks (one an end), "
        f"{len(reads['merge'])} merge-scan readbacks and, over "
        f"{len(saves)} saves (two an end), {pulled.count('pull_numeric_rows')} "
        f"row pulls and {pulled.count('edge_weights_for')} edge pulls, each "
        f"where the save had dirty rows or edges; end_conversation s "
        f"{[round(x, 3) for x in ends]}")

    # ---- restart: close, reload from the store, compare
    queries = [f"What do I remember about the {t}?"
               for t in ("project", "family", "course", "exercise", "travel")]
    want = (_ranked(ms, queries), dict(ms.profile.data),
            _salience_bits(ms, torch), ms.node_counter)
    rows = len(ms.index)
    ms.close()
    t = time.perf_counter()
    ms = MemorySystem(enable_async=False, verbose=False, db_dir=db)
    restart_s = time.perf_counter() - t
    stamps = ms.store.get_nodes_columns(ms.user_id)["decay_pass"]
    missed = int((stamps < ms._decay_pass).sum())
    got = (_ranked(ms, queries), dict(ms.profile.data),
           _salience_bits(ms, torch), ms.node_counter)
    if got != want or not missed:
        raise AssertionError(
            f"default config restart: rankings equal {got[0] == want[0]}, "
            f"profile equal {got[1] == want[1]}, salience bits differ in "
            f"{sum(got[2].get(q) != b for q, b in want[2].items())} of "
            f"{len(want[2])} rows, counter {got[3]} vs {want[3]}, "
            f"{missed} rows replayed missed passes")
    log(f"[default] restart: load_from_disk=True reloaded {len(ms.index)} "
        f"rows in {restart_s:.3f} s; {missed} rows stamped before the last "
        f"of {ms._decay_pass} decay passes replayed them; rankings of "
        f"{len(queries)} queries, the profile and the salience bits of all "
        f"{len(want[2])} rows equal to the system before the restart")

    # ---- crash: turns and an uncommitted fact batch, no end_conversation
    landed = [n for n in sorted(ms.buffer.nodes.values(), key=lambda n: n.id)
              if not n.is_super_node and " | " not in n.content][:5]
    if len(landed) < 5:
        raise AssertionError("default config: fewer than 5 plain nodes")
    facts = [{"content": n.content, "type": n.type, "salience": 0.5,
              "topic": n.shard_key} for n in landed]
    facts += [{"content": f"I {verb} the marina {w} every spring",
               "type": "episodic", "salience": 0.6, "topic": "travel"}
              for verb, w in zip(("visit", "paint", "sail", "clean", "map"),
                                 DEFAULT_WORDS[::20])]
    turns = [f"I moved to the lighthouse {w} last week." for w in
             DEFAULT_WORDS[5:8]]
    ms.start_conversation()
    for turn in turns:
        ms.add_to_short_term(turn, "episodic", 0.7)
    ms._ingest_journal.append(facts)
    access = {n.id: n.access_count for n in landed}
    nodes_before = len(ms.buffer.nodes)
    if ms.query_scheduler is not None:
        ms.query_scheduler.close()
    del ms                               # dropped: no end_conversation, no close
    gc.collect()
    readbacks = []
    inner = MemoryIndex._readback

    def counted(self, packed):
        readbacks.append(tuple(packed.shape))
        return inner(self, packed)

    before = (it.launches, it.launches_wgmma, dr.launches, it.launches_stream,
              mt.launches)
    MemoryIndex._readback = counted
    try:
        ms = MemorySystem(enable_async=False, verbose=False, db_dir=db)
    finally:
        MemoryIndex._readback = inner
    replay = (it.launches - before[0], it.launches_wgmma - before[1],
              dr.launches - before[2], it.launches_stream - before[3],
              mt.launches - before[4])
    recovered = [t["content"] for t in ms.short_term_memory]
    counts = [sum(n.content == f["content"] for n in ms.buffer.nodes.values())
              for f in facts]
    touched = [ms.buffer.get_node(i).access_count - a
               for i, a in access.items()]
    replayed = ms.telemetry.counter_total("reliability.journal_replayed")
    dispatches = ms.index.ingest_dispatch_count
    if (recovered != turns or not ms.conversation_active
            or counts != [1] * len(facts) or touched != [1] * len(landed)
            or len(ms.buffer.nodes) != nodes_before + len(facts) - len(landed)
            or replayed != len(facts) or ms._ingest_journal.pending_count
            or replay != (1, 0, 1, 1, 0) or dispatches != 1
            or len(readbacks) != 1):
        raise AssertionError(
            f"crash recovery: turns {recovered}, fact counts {counts}, landed "
            f"facts touched {touched}, nodes {len(ms.buffer.nodes)} from "
            f"{nodes_before}, replayed {replayed}, (K1, K1 tensor-core, "
            f"resolve, K1 streamed, masked_topk) launches {replay}, dispatches "
            f"{dispatches}, readbacks {readbacks}")
    ms.end_conversation()                # consolidates the recovered turns
    try:
        lifecycle = _lifecycle_default(ms, queries, torch)
    finally:
        ms.close()
    for name, n in (("ingest_topk", replay[0]), ("dedup_resolve", replay[2])):
        path[name] += n
    path["masked_topk"] += replay[4]
    log(f"[default] crash: {len(turns)} turns recovered from the turn "
        f"journal; the uncommitted batch of {len(facts)} facts ({len(landed)} "
        f"already landed) replayed through the fused ingest on the card: "
        f"{dispatches} dispatch, {replay[0]} K1 launch ({replay[1]} "
        f"tensor-core, {replay[3]} streamed), {replay[4]} masked_topk "
        f"launches, {replay[2]} resolve launch, {len(readbacks)} readback "
        f"{readbacks}; the landed "
        f"facts merged (access +1), the others ingested once: no fact lost, "
        f"none doubled")
    for name, n in path.items():
        launches_out["default_" + name] = n

    both, probes = [], []
    for i, flags in enumerate(({}, {"ingest_fused": False,
                                    "ingest_dedup_fused": False})):
        other = MemorySystem(enable_async=False, verbose=False,
                             max_buffer_size=10_000,
                             db_dir=store_dir(f"default_{i}"),
                             config=MemoryConfig(dedup_similarity=0.99, **flags))
        try:
            before = (mt.launches_stream, it.launches, it.launches_stream)
            drive(other)
            both.append(record(other))
            probes.append((mt.launches_stream - before[0],
                           it.launches - before[1],
                           it.launches_stream - before[2]))
        finally:
            other.close()
    # The fused ingest probes in K1 on the streaming stage (no masked_topk
    # launch), the classic one in masked_topk on that stage's additive mode.
    if not (probes[0][0] == 0 and probes[0][1] and probes[0][2] == probes[0][1]
            and probes[1][0]):
        raise AssertionError(f"(streaming masked_topk, K1, K1 streamed) "
                             f"launches: fused {probes[0]}, classic {probes[1]}")
    got, want = both
    if got != want:
        diff = set(got[0].items()) ^ set(want[0].items())
        raise AssertionError(f"default config: the fused and classic ingests "
                             f"differ on f32 ({len(diff)} nodes, edges equal: "
                             f"{got[1] == want[1]}, profile equal: "
                             f"{got[2] == want[2]})")
    merged = sum(" | " in v for v in got[0].values())
    if not merged:
        raise AssertionError("default config: the dialogue merged no node")
    out = {"conversations": DEFAULT_CONVS, "rows": rows,
           "nodes": len(got[0]), "edges": len(got[1]), "merged_nodes": merged,
           "profile_domains": sum(bool(v) for v in got[2].values()),
           "k3_launches": k3[0], "k1_launches": k1[0],
           "k1_streamed": k1[1], "masked_topk_launches": k1[2],
           "copies": copies, "stream_mt_k1_k1stream_fused_classic": probes,
           "end_conversation_s": ends, "restart_s": restart_s,
           "restart_missed_rows": missed, "crash_replay_launches": replay,
           "crash_replay_readbacks": len(readbacks), "lifecycle": lifecycle}
    log(f"[default] without eviction and at a 0.99 dedup gate, fused and "
        f"classic ingest equal: {len(got[0])} nodes ({merged} merged), "
        f"{len(got[1])} edges, {out['profile_domains']} profile domains; "
        f"(streaming masked_topk, K1, K1 streamed) launches fused "
        f"{probes[0]}, classic {probes[1]}")
    return out


# ---------------------------------------------------------------------------
# The row-sharded arena: the merge kernel, make_sharded_topk, and phase 4's
# path on a mesh
# ---------------------------------------------------------------------------


def phase_default_int8(launches_out: dict) -> dict:
    """Phase 4c once more with ``MemoryConfig(int8_serving=True)``, the
    rest default: the nine-conversation dialogue, every chat turn one K4
    keyed launch once the arena holds rows. After each conversation end the
    shadow, where no write since its last build left it stale, must equal
    ``quantize_rows`` of the arena bit for bit; an end whose fused ingest
    kept it fresh (the same tensors, no requantize) counts as maintained."""
    import torch

    from lazzaro_tpu_torch import MemoryConfig, MemorySystem
    from lazzaro_tpu_torch.ops import int8_topk as k4
    from lazzaro_tpu_torch.ops.quant import quantize_rows

    ms = MemorySystem(enable_async=False, verbose=False,
                      db_dir=store_dir("default_int8"),
                      config=MemoryConfig(int8_serving=True))
    k4.launches = k4.launches_keyed = k4.launches_wgmma = k4.launches_dp4a = 0
    checked = maintained = chats = 0
    try:
        for c in range(DEFAULT_CONVS):
            ms.start_conversation()
            for turn in default_turns(c):
                ms.add_to_short_term(turn, "semantic", 0.6)
            before = k4.launches_keyed
            had_rows = bool(ms.index.id_to_row)
            ms.chat(f"What do I remember about the {('project', 'family')[c % 2]}?")
            if had_rows:
                chats += 1
                if k4.launches_keyed - before != 1:
                    raise AssertionError("an int8 chat turn is not one K4 "
                                         "keyed launch")
            idx = ms.index
            fresh = not idx._int8_dirty and idx._int8_shadow is not None
            held = idx._int8_shadow[0] if fresh else None
            ms.end_conversation()
            torch.cuda.synchronize()
            idx = ms.index
            if idx._int8_dirty or idx._int8_shadow is None:
                continue
            q8, sc = quantize_rows(idx.state.emb)
            if not (torch.equal(idx._int8_shadow[0], q8)
                    and torch.equal(idx._int8_shadow[1], sc)):
                raise AssertionError(f"conversation {c}: the int8 shadow "
                                     f"differs from quantize_rows of the arena")
            checked += 1
            maintained += held is not None and idx._int8_shadow[0] is held
        if chats < DEFAULT_CONVS - 1 or maintained < 1:
            raise AssertionError(f"int8 dialogue: {chats} K4 chat turns, "
                                 f"{maintained} maintained shadows")
        hits = ms.search_memories("What do I remember about the project?")
    finally:
        ms.close()
    launches_out["default_int8_topk"] = k4.launches
    launches_out["int8_topk_wgmma"] += k4.launches_wgmma
    launches_out["int8_topk_dp4a"] += k4.launches_dp4a
    if k4.launches_wgmma != k4.launches:
        raise AssertionError(f"{k4.launches_dp4a} K4 launches of the 768-wide "
                             f"shadow left the tensor cores")
    log(f"[default-int8] MemorySystem(int8_serving=True): {DEFAULT_CONVS} "
        f"conversations, {chats} chat turns each one K4 keyed launch, "
        f"{k4.launches} K4 launches (all on the tensor cores); the shadow "
        f"equal to quantize_rows of the "
        f"arena at {checked} conversation ends, kept in place by the fused "
        f"ingest at {maintained}; search_memories found {len(hits)} nodes")
    return {"conversations": DEFAULT_CONVS, "k4_launches": k4.launches,
            "shadow_checked": checked, "shadow_maintained": maintained}


def _lifecycle_default(ms, queries, torch) -> dict:
    """The default system (``lifecycle_fused=True``, as in JAX) saved with
    ``save_snapshot`` and restored with ``load_snapshot`` into a second
    ``MemorySystem`` configured ``lifecycle_fused=False``: the restored one
    must serve the same rankings and fused reads and hold the same salience
    bits; then two ``lifecycle_tick(force=True)`` on each, one dispatch a
    tick against the classic loop, must leave the same salience, edge
    weight and alive bits, removed edges and verdicts."""
    from lazzaro_tpu_torch import MemoryConfig, MemorySystem

    snap = os.path.join(STORE_ROOT, "default_snapshot")
    t0 = time.perf_counter()
    ms.save_snapshot(snap)
    save_s = time.perf_counter() - t0
    classic = MemorySystem(enable_async=False, verbose=False,
                           load_from_disk=False,
                           db_dir=store_dir("default_classic"),
                           config=MemoryConfig(lifecycle_fused=False))
    try:
        t0 = time.perf_counter()
        msg = classic.load_snapshot(snap)
        load_s = time.perf_counter() - t0
        fused_reads = [[n.id for n in m.search_memories(q)]
                       for m in (ms, classic) for q in queries]
        half = len(queries)
        served = {"loaded": "loaded" in msg and classic.user_id == ms.user_id,
                  "rankings": _ranked(ms, queries) == _ranked(classic, queries),
                  "fused_reads": fused_reads[:half] == fused_reads[half:],
                  "salience": _salience_bits(ms, torch)
                  == _salience_bits(classic, torch)}
        ticks = []
        now = time.time()
        for i in range(2):
            d0 = ms.index.lifecycle_dispatch_count
            a = ms.lifecycle_tick(now=now + 3600.0 * i, force=True)
            b = classic.lifecycle_tick(now=now + 3600.0 * i, force=True)
            es_a, es_b = ms.index.edge_state, classic.index.edge_state
            ticks.append({
                "dispatches": (ms.index.lifecycle_dispatch_count - d0,
                               a["dispatches"], b["dispatches"]),
                "verdicts": a["verdicts"] == b["verdicts"],
                "removed_edges": sorted(a["removed_edges"])
                == sorted(b["removed_edges"]),
                "pruned_hosts": a["pruned_hosts"] == b["pruned_hosts"],
                "salience": _salience_bits(ms, torch)
                == _salience_bits(classic, torch),
                "edges": torch.equal(es_a.weight.view(torch.int32),
                                     es_b.weight.view(torch.int32))
                and torch.equal(es_a.alive, es_b.alive),
                "archived": (a["archived"], b["archived"]),
                "decayed_rows": a["decayed_rows"]})
    finally:
        classic.close()
        shutil.rmtree(snap, ignore_errors=True)
    ok = (all(served.values())
          and all(t["dispatches"][:2] == (1, 1) and t["archived"] == (0, 0)
                  and all(v for k, v in t.items()
                          if k not in ("dispatches", "archived", "decayed_rows"))
                  for t in ticks))
    if not ok or not ms.config.lifecycle_fused:
        raise AssertionError(f"default config lifecycle: served {served}, "
                             f"ticks {ticks}")
    log(f"[default] save_snapshot {save_s:.3f} s, load_snapshot into a "
        f"lifecycle_fused=False system {load_s:.3f} s: rankings, fused reads "
        f"and salience bits equal; two lifecycle_tick(force=True) each, one "
        f"dispatch a fused tick against {ticks[0]['dispatches'][2]} device "
        f"calls of the classic loop: salience, edge and verdict bits equal "
        f"({ticks[0]['decayed_rows']} rows decayed a tick, nothing archived: "
        f"no tiering)")
    return {"snapshot_save_s": save_s, "snapshot_load_s": load_s,
            "served": served, "ticks": ticks}


def mesh_devices(torch):
    """One shard per card when the cards divide ``MESH_SHARDS`` (and are
    more than one), else ``MESH_SHARDS`` shards on ``cuda:0``."""
    n = torch.cuda.device_count()
    if n > 1 and MESH_SHARDS % n == 0:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * MESH_SHARDS


# (label, n, Q, kl, k, rows per shard, ragged k_q, sentinel, masked share,
# all-masked shard) at the shapes the mesh path gives the merge: a classic
# search, the dedup probe and link scan of a fill conversation, the fused
# fleet (k_q 5/10/128) and gate; then corner cases.
MERGE_CASES = [
    ("search_q1_kl10_k10", 8, 1, 10, 10, 131_072, False, False, 0.0, None),
    ("dedup_q8192_kl1_k1", 8, 8192, 1, 1, 131_072, False, False, 0.1, None),
    ("link_q8192_kl3_k3", 8, 8192, 3, 3, 131_072, False, False, 0.1, None),
    ("fleet_q64_kl128_k128_kq5-10-128", 8, 64, 128, 128, 131_072, True, True,
     0.2, None),
    ("gate_q64_kl1_k1", 8, 64, 1, 1, 131_072, False, True, 0.3, None),
    ("dead_shard_q16_kl4_k24", 8, 16, 4, 24, 64, True, True, 0.1, 2),
    ("rows_below_k_q5_kl3_k10", 8, 5, 3, 10, 3, False, True, 0.0, None),
]


def merge_lists(gen, n, q, kl, local_n, device, masked, dead):
    """Per-shard lists in scan order (score descending, lower row first on
    ties): scores on the 1/256 grid, so ties cross shards; a ``masked``
    share at -1e30; shard ``dead`` all masked; i32 local rows."""
    import torch

    s = grid_values(gen, (n, q, kl), torch.float32, device) / 4
    s = torch.where(torch.rand((n, q, kl), generator=gen, device=device)
                    < masked, -1e30, s)
    if dead is not None:
        s[dead] = -1e30
    step = local_n // kl
    rows = (torch.arange(kl, device=device) * step
            + torch.randint(0, step, (n, q, 1), generator=gen, device=device))
    s, order = s.sort(dim=-1, descending=True, stable=True)
    return s, torch.gather(rows, -1, order).int()


def merge_bound(n, q, kl, k, ragged):
    """(bound_ms, bound_by) of a merge: the n lists (f32 score, i32 row)
    and ``k_q`` read once, ``[Q, k]`` scores and rows written once; the
    binary searches' comparisons (``n - 1`` searches of ``log2(kl + 1)``
    steps per candidate) at the f32 rate of the CUDA cores."""
    moved = n * q * kl * 8 + q * k * 8 + (4 * q if ragged else 0)
    ops = n * q * kl * (n - 1) * max(1, int(np.ceil(np.log2(kl + 1))))
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sharded_bound(emb, queries, k, n):
    """The row-sharded top-k: every shard's scan (:func:`bound`'s bytes and
    operations over the whole arena) plus the merge of ``n`` lists."""
    b_ms, b_by = bound(emb, queries, k)
    m_ms, _ = merge_bound(n, queries.shape[0], k, k, False)
    return b_ms + m_ms, b_by


def phase_sharded_kernel(device):
    """The merge kernel against its plain version at the mesh path's shapes,
    exact on grid inputs, then ``make_sharded_topk`` and the keyed grouped
    scan (the fused mesh chat's) over ``MESH_SHARDS`` shards of a
    1,048,576-row grid arena against their plain versions (each shard's
    plain scan and the plain merges), exact, with the kernel launches a
    call (a stage 1 and a stage 2 a pass when one card holds the shards)."""
    import torch

    from lazzaro_tpu_torch.core import state as S
    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import masked_topk as mt
    from lazzaro_tpu_torch.ops import sharded_merge as sm
    from lazzaro_tpu_torch.ops.topk import make_sharded_topk, shard_groups
    from lazzaro_tpu_torch.parallel import make_mesh

    gen = torch.Generator(device=device).manual_seed(4)
    rows_out = []
    for label, n, q, kl, k, local_n, ragged, sent, masked, dead in MERGE_CASES:
        s, r = merge_lists(gen, n, q, kl, local_n, device, masked, dead)
        s_l, r_l = list(s), list(r)
        k_q = None
        if ragged:
            k_q = torch.tensor([min((5, 10, 128)[i % 3], k) for i in range(q)],
                               dtype=torch.int32, device=device)
        sentinel = n * local_n - 1 if sent else None
        err = _check_equal(
            label, sm.sharded_merge(s_l, r_l, local_n, k, k_q, sentinel),
            sm.sharded_merge_reference(s_l, r_l, local_n, k, k_q, sentinel))

        def lib(s=s, r=r, k=k):
            # Yardstick only: torch.topk + gather over the concatenated lists.
            all_s = s.permute(1, 0, 2).reshape(s.shape[1], -1)
            top = torch.topk(all_s, k)
            return top.values, torch.gather(
                r.permute(1, 0, 2).reshape(r.shape[1], -1), 1, top.indices)

        rows_out.append(_case_row(
            "sharded_merge", "merge", label, None, n * local_n, q, k,
            lambda: sm.sharded_merge(s_l, r_l, local_n, k, k_q, sentinel),
            lambda: sm.sharded_merge_reference(s_l, r_l, local_n, k, k_q,
                                               sentinel),
            lib, merge_bound(n, q, kl, k, ragged), err, 50, 5))

    mesh = make_mesh(devices=mesh_devices(torch))
    n = mesh.size
    local_n = ARENA_ROWS // n
    big = grid_values(gen, (ARENA_ROWS, DIM), torch.bfloat16, device)
    big[local_n * 5 + 7] = big[11]               # an exact tie across shards
    alive = torch.rand(ARENA_ROWS, generator=gen, device=device) < 0.9
    alive[local_n:2 * local_n] = False           # an all-masked shard
    shards = [x.to(d) for x, d in zip(big.split(local_n), mesh.devices)]
    masks = [x.to(d) for x, d in zip(alive.split(local_n), mesh.devices)]
    madd_t = torch.where(alive, 0.0, -1e30).to(big.dtype)
    search = make_sharded_topk(mesh, k=10)

    def plain(q):
        parts = [mt.masked_topk_reference(e, m, q.to(e.device), 10)
                 for e, m in zip(shards, masks)]
        return sm.sharded_merge_reference([p[0] for p in parts],
                                          [p[1] for p in parts], local_n, 10)

    groups = len(shard_groups(mesh.devices))

    def per_call(fn, mod):
        """(grouped scans, kernel launches, merges) of one call of fn."""
        before = (mod.launches, mod.stage_launches, sm.launches)
        fn()
        torch.cuda.synchronize()
        return (mod.launches - before[0], mod.stage_launches - before[1],
                sm.launches - before[2])

    def note(row, made):
        """Check the launches of a call: those the scan's C entry point
        counted, and the scan kernels the profiler's trace shows."""
        want = (groups, 2 * groups, int(groups > 1))
        log(f"[kernels] {row['case']}: {made[1]} kernel launches a call "
            f"({made[0]} grouped scan(s) over {n} shards on {groups} card(s), "
            f"{made[2]} merges; route {row['route']}); the trace shows "
            f"{row['scan_kernels']} scan kernels a call")
        if made != want or row["scan_kernels"] != made[1]:
            raise AssertionError(f"{row['case']}: (scans, launches, merges) a call "
                                 f"{made}, not {want}; traced scan kernels "
                                 f"{row['scan_kernels']}")
        row["launches_per_call"] = made[1]
        rows_out.append(row)

    for nq in (1, 64):
        q = grid_values(gen, (nq, DIM), torch.bfloat16, device)
        q[0] = big[11]
        label = f"sharded_topk_q{nq}_k10_grid"
        err = _check_equal(label, search(shards, masks, q), plain(q))
        made = per_call(lambda: search(shards, masks, q), mt)
        note(_case_row(
            "sharded_topk", "whole", label, mt.route_for(big.dtype, nq, DIM),
            ARENA_ROWS, nq, 10,
            lambda: search(shards, masks, q), lambda: plain(q),
            lambda: torch.topk(torch.addmm(madd_t, q, big.t()), 10),
            sharded_bound(big, q, 10, n), err, 20, 3), made)

    # The keyed grouped scan of a fused mesh chat turn
    # (core.state._fused_scan_sharded at K = 128, k_live 10): two tenants,
    # super rows, an empty gate (tenant 2), k_q 10, masked pairs on the
    # global sentinel; against each shard's plain two-tier scan and the
    # plain ANN and gate merges. Its query is a grid vector of norm 1 (256
    # entries of +-1/16), which the scan's normalization leaves as it is.
    tenant = torch.where(alive, (torch.rand(ARENA_ROWS, generator=gen, device=device)
                                 < 0.5).int(), -1).int()
    sup = torch.rand(ARENA_ROWS, generator=gen, device=device) < 0.01
    arena = S.init_shards(ARENA_ROWS - 1, DIM, torch.bfloat16, mesh.devices)
    for st, cols in zip(arena, zip(big.split(local_n), alive.split(local_n),
                                   tenant.split(local_n), sup.split(local_n))):
        for name, col in zip(("emb", "alive", "tenant_id", "is_super"), cols):
            getattr(st, name).copy_(col)
    states = [(st.emb, st.alive, st.tenant_id, st.is_super) for st in arena]
    sent = ARENA_ROWS - 1
    q = torch.zeros((1, DIM), device=device)
    pick = torch.randperm(DIM, generator=gen, device=device)[:256]
    q[0, pick] = torch.where(torch.rand(256, generator=gen, device=device) < 0.5,
                             1 / 16, -1 / 16)
    if not torch.equal(S.normalize(q), q):
        raise AssertionError("the keyed case's query is not of norm 1")
    q_ten = torch.tensor([0], dtype=torch.int32, device=device)
    k_q = torch.tensor([10], dtype=torch.int32, device=device)

    def keyed():
        return S._fused_scan_sharded(arena, q, q_ten, 128, k_q, k_live=10)

    def keyed_plain():
        return ft.fused_topk_grouped_reference(states, q.to(big.dtype), q_ten, k_q, 128,
                                               sent, range(n))

    def keyed_lib():
        # Yardstick only: one product, the tier masks, two torch.topk.
        sc = torch.matmul(q.to(big.dtype), big.t()).float()
        ok = alive[None, :] & (tenant[None, :] == q_ten[:, None])
        torch.topk(torch.where(ok & sup[None, :], sc, -1e30), 1)
        return torch.topk(torch.where(ok & ~sup[None, :], sc, -1e30), 128)

    err = _check_equal("sharded_fused_q1_k128_kq10_grid", keyed(), keyed_plain())
    made = per_call(keyed, ft)
    note(_case_row(
        "sharded_topk", "two_tier", "sharded_fused_q1_k128_kq10_grid",
        mt.route_for(big.dtype, 1, DIM), ARENA_ROWS, 1, 128, keyed, keyed_plain,
        keyed_lib, fused_bound(big, q, 128), err, 20, 3), made)
    return rows_out


def sharded_topk_filled(ms, corpus, served, torch):
    """``make_sharded_topk`` on the filled meshed arena: equal, rows and
    scores, to one launch of the masked top-k kernel over the same rows
    made whole (every score is the same per-row arithmetic, so only the
    merge could differ), and within phase 4's rule of the plain version
    (real bf16 rows: f32 sums in another order than ``torch.matmul``'s,
    so scores within 1e-5 and rows wherever neighbours differ by more)."""
    from lazzaro_tpu_torch.core import state as S
    from lazzaro_tpu_torch.ops import masked_topk as mt
    from lazzaro_tpu_torch.ops import sharded_merge as sm

    idx = ms.index
    tid = idx._tenants[TENANTS[0]]
    embs = [st.emb for st in idx.shards]
    masks = [S.arena_mask(st, tid, -1) for st in idx.shards]
    whole = torch.cat([e.to(idx.device) for e in embs])
    whole_mask = torch.cat([m.to(idx.device) for m in masks])
    local_n = idx._local_n
    search = idx._mesh_searcher(10)

    def plain(q):
        parts = [mt.masked_topk_reference(e, m, q.to(e.device), 10)
                 for e, m in zip(embs, masks)]
        return sm.sharded_merge_reference([p[0] for p in parts],
                                          [p[1] for p in parts], local_n, 10)

    rows_out, worst = [], 0.0
    for nq in (1, 64):
        q = torch.from_numpy(corpus.vectors((served["targets"] * 4)[:nq]))
        q = S.normalize(q.to(idx.device)).to(whole.dtype)
        ks, kr = search(embs, masks, q)
        ws, wr = mt.masked_topk(whole, whole_mask, q, 10)
        if not (torch.equal(kr.long(), wr) and torch.equal(ks, ws)):
            raise AssertionError(f"filled mesh arena, Q={nq}: make_sharded_topk "
                                 f"differs from one scan of the whole arena")
        ps, pr = plain(q)
        torch.cuda.synchronize()
        err = float((ks - ps).abs().max())
        gaps = torch.diff(ps, dim=1).abs()
        clear = torch.ones_like(kr, dtype=torch.bool)
        clear[:, 1:] &= gaps > 1e-5
        clear[:, :-1] &= gaps > 1e-5
        if err > 1e-5 or not torch.equal(kr[clear], pr[clear]):
            raise AssertionError(f"filled mesh arena: kernel disagrees (max err {err})")
        worst = max(worst, err)
        madd_t = torch.where(whole_mask, 0.0, -1e30).to(whole.dtype)
        rows_out.append(_case_row(
            "sharded_topk", "whole", f"sharded_topk_q{nq}_k10_filled",
            mt.route_for(whole.dtype, nq, DIM), whole.shape[0], nq, 10,
            lambda: search(embs, masks, q),
            lambda: plain(q),
            lambda: torch.topk(torch.addmm(madd_t, q, whole.t()), 10),
            sharded_bound(whole, q, 10, len(embs)), err, 20, 3))
    log(f"[mesh] make_sharded_topk on the filled arena equals one scan of the "
        f"whole arena; vs plain max_abs_err {worst}")
    return rows_out


def phase_mesh(launches_out: dict, parity: dict, single: dict):
    """Phase 4's path on a ``MESH_SHARDS``-shard mesh: the same arena,
    corpus and tenants, filled through ``end_conversation`` for
    ``MESH_CONVS`` conversations, held equal to phase 4's snapshot, then
    classic and fused serving with their launches counted from 0."""
    import torch

    from lazzaro_tpu_torch import MemoryConfig, MemorySystem
    from lazzaro_tpu_torch.ops import masked_topk as mt
    from lazzaro_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=mesh_devices(torch))
    log(f"[mesh] {mesh.size} shards on "
        f"{', '.join(sorted({str(d) for d in mesh.devices}))}, "
        f"{ARENA_ROWS // mesh.size} rows each")
    fill = MESH_CONVS * PER_CONV
    corpus = Corpus(ARENA_ROWS)                   # phase 4's corpus
    llm = PayloadLLM()
    cfg = MemoryConfig(**SLICE, dtype="bfloat16", embed_dim=DIM,
                       initial_capacity=ARENA_ROWS - 1, max_edges=4 * FILL)
    torch.cuda.reset_peak_memory_stats()
    ms = MemorySystem(mesh=mesh, config=cfg, enable_async=False,
                      load_from_disk=False, max_buffer_size=2 * FILL,
                      db_dir=store_dir("mesh"),
                      user_id=TENANTS[0], verbose=False, llm_provider=llm,
                      embedding_provider=CorpusEmbedder(corpus))
    try:
        summary, served = _drive(ms, llm, corpus, MESH_CONVS, fill,
                                 launches_out, mt, torch, parity=parity)
        summary["fused"] = _drive_fused(ms, corpus, served, launches_out,
                                        torch)
        rows = sharded_topk_filled(ms, corpus, served, torch)
        summary["lifecycle"] = _lifecycle_mesh(ms, launches_out, torch)
    finally:
        ms.close()
    f, sf = summary["fused"], single["fused"]
    log("[mesh] p50 ms, mesh vs one device (phase 4): "
        f"classic chat {summary['chat_p50_ms']:.2f} vs {single['chat_p50_ms']:.2f}, "
        f"classic search {summary['search_p50_ms']:.2f} vs {single['search_p50_ms']:.2f}, "
        f"fused chat miss {f['chat_miss_p50_ms']:.2f} vs {sf['chat_miss_p50_ms']:.2f}, "
        f"hit {f['chat_hit_p50_ms']:.2f} vs {sf['chat_hit_p50_ms']:.2f}, "
        f"fused search {f['search_p50_ms']:.2f} vs {sf['search_p50_ms']:.2f}, "
        f"batch(64) {f['batch64_p50_ms']:.2f} vs {sf['batch64_p50_ms']:.2f}, "
        f"fleet(64) {f['fleet64_mixed_k_p50_ms']:.2f} vs "
        f"{sf['fleet64_mixed_k_p50_ms']:.2f}")
    log(f"[mesh] launches over the phase: classic path {launches_out['mesh_masked_topk']} "
        f"grouped masked_topk scans + {launches_out['mesh_sharded_merge']} merges "
        f"(the fill's link scans; per chat turn {summary['launches_per_chat_turn']}), "
        f"fused path {launches_out['mesh_fused_topk']} grouped two-tier scans + "
        f"{launches_out['mesh_sharded_merge_on_fused_path']} merges, "
        f"{f['readbacks']} readbacks; {launches_out['mesh_ingest_topk']} "
        f"ingest_topk link scans (one a shard a conversation end)")
    # Kernel B: the grouped scans of the mesh's searches (classic, the
    # fill's dedup probes included, and fused); the merge kernel: the link
    # scans' merges and, past one card, the searches'.
    launches_out["sharded_topk"] = (launches_out["mesh_masked_topk"]
                                    + launches_out["mesh_fused_topk"])
    launches_out["sharded_merge"] = (launches_out["mesh_sharded_merge"]
                                     + launches_out["mesh_sharded_merge_on_fused_path"]
                                     + launches_out["mesh_sharded_merge_on_lifecycle"])
    return summary, rows


def _lifecycle_mesh(ms, launches_out, torch) -> dict:
    """One lifecycle sweep of the mesh's index against a one-device sweep of
    the same rows: a one-device twin of the index (every shard's rows
    concatenated on the first card, the edge arena cloned, the edge
    bookkeeping copied). Both sweep both tenants at one pass: verdicts,
    removed edges, salience, edge weight and alive equal; the mesh sweep
    is one dispatch, one readback and exactly one launch of the merge
    kernel (counted from 0 over the sweep)."""
    import copy
    import dataclasses

    from lazzaro_tpu_torch.core import state as S
    from lazzaro_tpu_torch.core.index import _EdgeSlotMap
    from lazzaro_tpu_torch.ops import sharded_merge as sm

    index = ms.index
    _unstrict_index(index)
    one = copy.copy(index)
    one.mesh = None
    one.state = S.ArenaState(**{f: index._column(f) for f in S.ARENA_FIELDS})
    es = index.edge_state
    one.edge_state = dataclasses.replace(es, weight=es.weight.clone(),
                                         alive=es.alive.clone())
    one.edge_slots = _EdgeSlotMap(dict(index.edge_slots))
    one._free_edge_slots = list(index._free_edge_slots)
    kw = _lifecycle_kw(ms)
    passes = {t: 1 for t in TENANTS if t in index._tenants}
    now = time.time()
    reads = []
    inner = index._readback

    def counted(packed):
        reads.append(tuple(packed.shape))
        return inner(packed)

    index._readback = counted
    saved = sm.launches
    sm.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        meshed = index.lifecycle_sweep(passes, now=now, **kw)
        torch.cuda.synchronize()
        sweep_ms = (time.perf_counter() - t0) * 1e3
        merges = sm.launches
    finally:
        del index._readback
        sm.launches = saved
    single = one.lifecycle_sweep(passes, now=now, **kw)
    cap = one.capacity
    same = {
        "verdicts": meshed["verdicts"] == single["verdicts"],
        "removed_edges": sorted(meshed["removed_edges"])
        == sorted(single["removed_edges"]),
        "salience": torch.equal(index._column("salience")[:cap].view(torch.int32),
                                one.state.salience[:cap].view(torch.int32)),
        "edge_weight": torch.equal(index.edge_state.weight.view(torch.int32),
                                   one.edge_state.weight.view(torch.int32)),
        "edge_alive": torch.equal(index.edge_state.alive, one.edge_state.alive)}
    del one
    gc.collect()
    torch.cuda.empty_cache()
    if not all(same.values()) or merges != 1 or len(reads) != 1 \
            or meshed["dispatches"] != 1:
        raise AssertionError(f"mesh lifecycle sweep vs one device: {same}, "
                             f"merge launches {merges}, readbacks {reads}")
    launches_out["mesh_sharded_merge_on_lifecycle"] = merges
    log(f"[mesh] lifecycle sweep over {len(index.shards)} shards: "
        f"{meshed['decayed_rows']} rows and {meshed['decayed_edges']} edges "
        f"decayed, {meshed['pruned_edges']} pruned, verdicts, removed edges "
        f"and every bit equal to one device's sweep of the same rows; "
        f"{merges} merge launch, {len(reads)} readback, wall {sweep_ms:.2f} ms")
    return {"wall_ms": sweep_ms, "merge_launches": merges,
            "readbacks": len(reads), "decayed_rows": meshed["decayed_rows"],
            "pruned_edges": meshed["pruned_edges"]}


def _timed(spent: dict, key: str, fn, torch):
    """``fn`` with its wall time, device work included, added to
    ``spent[key]``; a timed call inside another counts to the outer one."""
    def wrapper(*args, **kwargs):
        if spent.get("_open"):
            return fn(*args, **kwargs)
        torch.cuda.synchronize()
        spent["_open"] = True
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            spent["_open"] = False
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
    return wrapper


# Stages of a fused conversation end timed during the fill (object, method,
# stage): the ingest scan, the resolve (the gram and the kernel), the arena
# and edge writes of the dispatch, its one readback, the host commit, the
# lifecycle writes after it, and the embedding.
FUSED_FILL_STAGES = (("state", "_ingest_scan_core", "scan"),
                     ("state", "_dedup_resolve", "resolve"),
                     ("state", "_arena_add", "writes"),
                     ("state", "_arena_merge_touch", "writes"),
                     ("state", "_edges_add", "writes"),
                     ("state", "_gated_link_insert", "writes"),
                     ("index", "_readback", "readback"),
                     ("index", "commit_ingest_dedup", "host_commit"),
                     ("index", "decay", "lifecycle"),
                     ("index", "prune_edges", "lifecycle"),
                     ("embedder", "batch_embed", "embed"),
                     ("ms", "_save_to_persistence", "store_save"),
                     ("store", "add_nodes_columns", "store_save"),
                     ("ms", "_load_from_persistence", "store_load"))
# The same for a classic conversation end (the mesh phase's).
FILL_STAGES = (("index", "search_batch", "dedup_probe"),
               ("index", "link_candidates_multi", "link_scan"),
               ("index", "add", "arena_writes"),
               ("index", "merge_touch", "arena_writes"),
               ("index", "add_edges", "arena_writes"),
               ("index", "decay", "arena_writes"),
               ("index", "prune_edges", "arena_writes"),
               ("embedder", "batch_embed", "embed"),
               ("ms", "_save_to_persistence", "store_save"),
               ("store", "add_nodes_columns", "store_save"),
               ("ms", "_load_from_persistence", "store_load"))


def _count_probes(index, mt):
    """Wrap ``index.search_batch`` (the fill's dedup probe) so that each call
    appends (padded Q, masked_topk launches, tensor-core launches) to the
    returned list; the wrapper is an instance attribute, removed with the
    fill's timers."""
    from lazzaro_tpu_torch.utils.batching import next_pow2

    probes = []
    inner = index.search_batch

    def probe(queries, *args, **kwargs):
        before = (mt.launches, mt.launches_wgmma)
        try:
            return inner(queries, *args, **kwargs)
        finally:
            nq = np.asarray(queries).reshape(-1, DIM).shape[0]
            probes.append((next_pow2(nq), mt.launches - before[0],
                           mt.launches_wgmma - before[1]))

    index.search_batch = probe
    return probes


def _strict_ingest(index, torch):
    """Run every fused ingest dispatch of ``index`` under
    ``torch.cuda.set_sync_debug_mode("error")``, except inside the one
    packed readback, which is counted. Returns the list of readbacks."""
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
    return readbacks


def _stable_id(qid: str) -> str:
    """A node id without the creation second a super-node id carries
    (``super_<topic>_<unix seconds>``), which two runs do not share."""
    head, _, tail = qid.rpartition("_")
    return head if ":super_" in qid and tail.isdigit() else qid


def parity_snapshot(ms, corpus):
    """What the meshed system must reproduce after ``MESH_CONVS``
    conversations, read at the index without boosting and without counting
    launches: node, edge and merge counts, ``search_batch`` (k = 10) ids and
    scores and the fused read twin's gate verdicts, gate ids and ANN ids for
    ``PARITY_FACTS`` facts of each tenant."""
    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import masked_topk as mt
    from lazzaro_tpu_torch.ops import sharded_merge as sm
    from lazzaro_tpu_torch.serve import RetrievalRequest

    counts = (mt.launches, mt.launches_wgmma, ft.launches, ft.launches_wgmma,
              sm.launches)
    idx, cfg = ms.index, ms.config
    rows = len(idx)
    supers = sum(":super_" in q for q in idx.id_to_row)
    snap = {"nodes": rows, "edges": len(idx.edge_slots),
            "merged": MESH_CONVS * PER_CONV - (rows - supers),
            "links": {(_stable_id(a), _stable_id(b)): wc
                      for (a, b), wc in idx.edge_weights().items()}}
    for t, tenant in enumerate(TENANTS):
        facts = [c * PER_CONV + (977 * j) % PER_CONV for j, c in enumerate(
            range(t, MESH_CONVS, len(TENANTS)))][:PARITY_FACTS]
        facts += [f + 3 for f in facts][:PARITY_FACTS - len(facts)]
        q = corpus.vectors(facts)
        snap[("search", tenant)] = [
            ([_stable_id(i) for i in ids], scores)
            for ids, scores in type(idx).search_batch(idx, q, tenant, k=10)]
        reqs = [RetrievalRequest(query=v, tenant=tenant, k=10,
                                 gate_enabled=True) for v in q]
        got = type(idx).search_fused_requests(
            idx, reqs, cap_take=cfg.retrieval_cap, max_nbr=cfg.serve_max_nbr,
            super_gate=cfg.super_node_gate,
            acc_boost=cfg.access_salience_boost,
            nbr_boost=cfg.neighbor_salience_boost)
        snap[("fused", tenant)] = [
            (r.fast, r.gate_id and _stable_id(r.gate_id),
             [_stable_id(i) for i in r.ids]) for r in got]
    (mt.launches, mt.launches_wgmma, ft.launches, ft.launches_wgmma,
     sm.launches) = counts
    return snap


def check_parity(want: dict, got: dict) -> dict:
    """The meshed system's snapshot against the single-device one: counts,
    ids, verdicts exact, scores within 1e-6. Raises with the count of what
    differs."""
    if want["edges"] == 0:
        raise AssertionError("the parity record holds no edge: the link "
                             "verdicts would go unchecked")
    for key in ("nodes", "edges", "merged"):
        if got[key] != want[key]:
            raise AssertionError(f"mesh parity: {key} {got[key]} != {want[key]}")
    gl, wl = got["links"], want["links"]
    if set(gl) != set(wl):
        raise AssertionError(f"mesh parity: {len(set(gl) ^ set(wl))} edge keys "
                             f"differ of {len(wl)}")
    worst_w = max((abs(gl[k][0] - wl[k][0]) for k in wl), default=0.0)
    if worst_w > 1e-6 or any(gl[k][1] != wl[k][1] for k in wl):
        raise AssertionError(f"mesh parity: edge weights differ by {worst_w} "
                             f"or co-occurrence counts differ")
    worst, queries = 0.0, 0
    for tenant in TENANTS:
        bad_ids = bad_fused = 0
        for (gi, gs), (wi, ws) in zip(got[("search", tenant)],
                                      want[("search", tenant)]):
            bad_ids += gi != wi
            if gi == wi and gs:
                worst = max(worst, float(np.abs(np.subtract(gs, ws)).max()))
            queries += 1
        for g, w in zip(got[("fused", tenant)], want[("fused", tenant)]):
            bad_fused += g != w
        if bad_ids or bad_fused:
            raise AssertionError(
                f"mesh parity, tenant {tenant}: {bad_ids} search id lists and "
                f"{bad_fused} fused (verdict, gate, ids) differ of "
                f"{len(want[('search', tenant)])}")
    if worst > 1e-6:
        raise AssertionError(f"mesh parity: scores differ by {worst}")
    return {"queries": queries, "max_score_diff": worst, "links": len(wl),
            "max_link_weight_diff": worst_w}


def _drive(ms, llm, corpus, convs, fill, launches_out, mt, torch,
           snapshot=None, parity=None):
    """The classic path: ``convs`` fill conversations, chat turns, one more
    conversation end, searches. ``snapshot`` (a dict) takes
    :func:`parity_snapshot` after conversation ``MESH_CONVS``, outside the
    fill's time; under a mesh ``parity`` is that snapshot of the
    single-device run, which the filled system must reproduce."""
    from lazzaro_tpu_torch.core import state as S
    from lazzaro_tpu_torch.ops import dedup_resolve as dr
    from lazzaro_tpu_torch.ops import ingest_topk as it
    from lazzaro_tpu_torch.ops import sharded_merge as sm
    from lazzaro_tpu_torch.ops.topk import shard_groups

    mesh = ms.index.mesh
    fused = ms.config.ingest_fused
    n_shards = mesh.size if mesh is not None else 1
    # A scan is one grouped launch per card holding shards; several cards
    # add one merge.
    scans = len(shard_groups(mesh.devices)) if mesh is not None else 1
    search_made = (scans, int(scans > 1))
    prefix = "mesh_" if mesh is not None else ""
    tag = "[mesh]" if mesh is not None else "[main]"
    # ---- fill: one conversation per 8,192 facts, tenants alternating
    spent: dict = {}
    owners = {"index": ms.index, "embedder": ms.embedder, "state": S,
              "ms": ms, "store": ms.store}
    patched = []
    for owner, method, stage in (FUSED_FILL_STAGES if fused else FILL_STAGES):
        obj = owners[owner]
        patched.append((obj, method, getattr(obj, method)))
        setattr(obj, method, _timed(spent, stage, getattr(obj, method), torch))
    probes = [] if fused else _count_probes(ms.index, mt)
    copies = []        # device-to-host copies inside the ingest dispatches
    if fused:
        timed_readback, ingest = ms.index._readback, ms.index.ingest_batch_dedup
        inside = []

        def count_copy(p):
            if inside:
                copies.append(p.shape)
            return timed_readback(p)

        def count_ingest(*args, **kwargs):
            inside.append(1)
            try:
                return ingest(*args, **kwargs)
            finally:
                inside.pop()

        ms.index._readback = count_copy
        ms.index.ingest_batch_dedup = count_ingest
    dispatches0 = ms.index.ingest_dispatch_count
    mt.launches = mt.launches_wgmma = mt.launches_stream = sm.launches = 0
    it.launches = it.launches_wgmma = dr.launches = dr.launches_card = 0
    switches = 0
    t0 = time.perf_counter()
    for k, c in enumerate(fill_order(convs)):
        tenant = TENANTS[c % len(TENANTS)]
        if ms.user_id != tenant:
            ms.switch_user(tenant)
            switches += 1
        llm.payloads.append(corpus.payload(range(c * PER_CONV, (c + 1) * PER_CONV)))
        ms.start_conversation()
        ms.add_to_short_term(f"conversation {c}", "episodic", 0.5)
        ms.end_conversation()
        if snapshot is not None and k + 1 == MESH_CONVS:
            torch.cuda.synchronize()
            t_snap = time.perf_counter()
            snapshot.update(parity_snapshot(ms, corpus))
            t0 += time.perf_counter() - t_snap     # not part of the fill
        if (k + 1) % 16 == 0 or k + 1 == convs:
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            log(f"{tag} filled {(k + 1) * PER_CONV} facts in {dt:.1f} s "
                f"(rows {len(ms.index)}, edges {len(ms.index.edge_slots)})")
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    fill_launches, fill_merges = mt.launches, sm.launches
    fill_wgmma, fill_stream = mt.launches_wgmma, mt.launches_stream
    fill_k1 = (it.launches, it.launches_wgmma, dr.launches, dr.launches_card)
    fill_dispatches = ms.index.ingest_dispatch_count - dispatches0
    for obj, method, orig in reversed(patched):
        if obj is S:
            setattr(obj, method, orig)
        else:
            vars(obj).pop(method, None)
    vars(ms.index).pop("ingest_batch_dedup", None)
    spent.pop("_open", None)
    spent["rest"] = fill_s - sum(spent.values())
    log(f"{tag} fill time by stage (s): "
        + ", ".join(f"{k} {v:.1f}" for k, v in spent.items())
        + f"; {convs + switches} saves (store_save), {switches} tenant "
        f"switches (store_load)")
    fill_disk = disk_bytes(ms.store.db_dir)
    log(f"{tag} store on disk after the fill: {fill_disk} bytes in "
        f"{sum(len(f) for _, _, f in os.walk(ms.store.db_dir))} files")
    if fused:
        # One dispatch, one ingest scan on the tensor cores (a bf16 arena),
        # one resolve and one device-to-host copy per mega-batch (a
        # conversation of PER_CONV facts); no classic probe.
        log(f"{tag} fill: {convs} mega-batches, {fill_dispatches} fused "
            f"dispatches, {len(copies)} device-to-host copies, {fill_k1[0]} "
            f"ingest_topk launches ({fill_k1[1]} tensor-core, "
            f"{fill_k1[0] - fill_k1[1]} FMA), {fill_k1[2]} dedup_resolve "
            f"calls (launches_card {fill_k1[3]}: the gram's arg-max and the "
            f"walk a call), {fill_launches} masked_topk launches")
        if not (fill_dispatches == len(copies) == fill_k1[0] == fill_k1[1]
                == fill_k1[2] == convs) or fill_launches \
                or fill_k1[3] != 2 * fill_k1[2]:
            raise AssertionError("the fused fill is not one dispatch, one "
                                 "tensor-core ingest scan, one resolve (two "
                                 "card launches) and one copy per mega-batch")
    else:
        # Every dedup probe (a power-of-two batch) scans the bf16 arena on
        # the tensor cores, one grouped scan per card. A probe of a tenant
        # with no row yet returns before any scan.
        wrong = [(q, n, w) for q, n, w in probes if n not in (0, scans) or w != n]
        scanned = sum(n > 0 for _, n, _ in probes)
        log(f"{tag} fill: {fill_launches} masked_topk launches, {fill_wgmma} on "
            f"the tensor-core route, {fill_stream} on the streaming route; "
            f"{len(probes)} dedup probes (Q {sorted({q for q, _, _ in probes})}), "
            f"{scanned} of them scanned; {fill_k1[0]} ingest_topk link scans "
            f"({fill_k1[1]} tensor-core)")
        if wrong or scanned == 0:
            raise AssertionError(f"dedup probes off their route (padded Q, "
                                 f"scans, tensor-core scans): {wrong[:5]}, "
                                 f"{scanned} scanned")
    rows = len(ms.index)
    # the full fill must reach MIN_ROWS; the mesh's shorter fill, less the
    # near-duplicates merged (1 in 101), 98% of its facts
    floor = MIN_ROWS if n_shards == 1 else int(0.98 * fill)
    if rows < floor:
        raise AssertionError(f"arena holds {rows} rows, fewer than {floor}")
    supers = sum(":super_" in q for q in ms.index.id_to_row)
    merged = fill - (rows - supers)
    if merged <= 0:
        raise AssertionError("no near-duplicate was merged during the fill")
    parity_out = None
    if parity is not None:
        parity_out = check_parity(parity, parity_snapshot(ms, corpus))
        log(f"[mesh] parity with the single-device system after {MESH_CONVS} "
            f"conversations: {rows} nodes, {len(ms.index.edge_slots)} edges, "
            f"{merged} merged, {parity_out['queries']} search_batch and fused "
            f"read results equal (max score diff {parity_out['max_score_diff']}), "
            f"{parity_out['links']} edge keys equal (max weight diff "
            f"{parity_out['max_link_weight_diff']})")

    # ---- reload: the switch to alice saves and reloads her from the store
    reload = _reload_tenant(ms, corpus, convs, tag, torch)
    reload["fill_disk_bytes"] = fill_disk

    # ---- serve: chat turns for facts whose answer is known
    rng = np.random.default_rng(7)
    own = [c for c in range(convs) if c % len(TENANTS) == 0]
    targets = []
    while len(targets) < 16:
        i = int(rng.choice(own)) * PER_CONV + int(rng.integers(PER_CONV))
        if not corpus.is_dup(i) and i not in targets:
            targets.append(i)
    new_ids = [i for i in range(fill, fill + 64) if not corpus.is_dup(i)]
    bob_fact = PER_CONV + 5
    prompts = [f"{corpus.text(i)}. What do you remember about it?"
               for i in targets]
    ms.embedder.warm(prompts + [corpus.text(i)
                                for i in targets + new_ids + [bob_fact]])
    chat_ms, chat_launches = [], []
    ms.start_conversation()
    for i, prompt in zip(targets, prompts):
        before = (mt.launches, sm.launches)
        t1 = time.perf_counter()
        ms.chat(prompt)
        chat_ms.append(1e3 * (time.perf_counter() - t1))
        chat_launches.append((mt.launches - before[0], sm.launches - before[1])
                             if n_shards > 1 else mt.launches - before[0])
        context = " ".join(m["content"] for m in llm.last_messages)
        if corpus.text(i) not in context:
            raise AssertionError(f"chat turn did not retrieve fact {i}")
    # The conversation end ingests new facts plus an exact repeat of a
    # target, which the dedup probe must merge into the stored fact.
    again = targets[0]
    node = ms.search_memories(corpus.text(again), limit=1)[0]
    acc_before = node.access_count
    rows_before = len(ms.index)
    llm.payloads.append(corpus.payload(new_ids + [again]))
    before = (mt.launches, sm.launches, it.launches)
    strict = _strict_ingest(ms.index, torch) if fused else None
    t1 = time.perf_counter()
    try:
        ms.end_conversation()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for method in ("ingest_batch_dedup", "_readback"):
            vars(ms.index).pop(method, None)
    end_s = time.perf_counter() - t1
    end_launches = mt.launches - before[0]
    end_merges = sm.launches - before[1]
    if fused:
        log(f"{tag} conversation end under sync debug mode \"error\": "
            f"{it.launches - before[2]} ingest_topk launch, {end_launches} "
            f"masked_topk launches, readbacks {strict}")
        if len(strict) != 1 or it.launches - before[2] != 1 or end_launches:
            raise AssertionError("a fused conversation end is not one ingest "
                                 "scan and one device-to-host copy")
    if node.access_count != acc_before + 1:
        raise AssertionError("the repeated fact was not merged")
    added = len(ms.index) - rows_before
    if added != len(new_ids):
        raise AssertionError(f"{added} rows added, expected {len(new_ids)}")

    search_ms = []
    for i in targets + new_ids[:16]:
        before = (mt.launches, sm.launches, mt.launches_wgmma)
        t1 = time.perf_counter()
        hits = ms.search_memories(corpus.text(i))
        search_ms.append(1e3 * (time.perf_counter() - t1))
        made = (mt.launches - before[0], sm.launches - before[1])
        if made != search_made or mt.launches_wgmma - before[2] != scans:
            raise AssertionError(f"search_memories made (scans, merges) = "
                                 f"{made}, not {search_made}, or left the "
                                 f"tensor-core route (a bf16 arena's)")
        if not hits or hits[0].content != corpus.text(i):
            raise AssertionError(f"search_memories missed fact {i}")

    # Tenant isolation: bob's searches (at the index: a switch to bob would
    # reload his half of the arena, as the switch above reloaded alice's)
    # see only bob's rows, and find his own.
    for text in (corpus.text(targets[0]), corpus.text(bob_fact)):
        ids, scores = ms.index.search(
            np.asarray(ms.embedder.embed(text), np.float32), TENANTS[1], k=10,
            super_filter=-1)
        if not ids or any(not q.startswith(TENANTS[1] + ":") for q in ids):
            raise AssertionError("a search of tenant bob returned another tenant's row")
    if scores[0] < 0.99:       # his own fact's row, scored against its text
        raise AssertionError("tenant bob missed his own fact")
    torch.cuda.synchronize()
    launches_out[prefix + "masked_topk"] = mt.launches
    launches_out[prefix + "sharded_merge"] = sm.launches
    launches_out[prefix + "ingest_topk"] = it.launches
    launches_out[prefix + "dedup_resolve"] = dr.launches
    log(f"{tag} ingest_topk launches over the path: {it.launches} "
        f"({it.launches_wgmma} tensor-core), dedup_resolve {dr.launches} "
        f"(launches_card {dr.launches_card})")
    log(f"{tag} classic path routes: {mt.launches_stream} streaming, "
        f"{mt.launches_wgmma} tensor-core, "
        f"{mt.launches - mt.launches_stream - mt.launches_wgmma} FMA of "
        f"{mt.launches} masked_topk launches")
    if mt.launches <= fill_launches:
        raise AssertionError("serving launched no masked_topk kernel")
    if scans > 1 and sm.launches <= fill_merges:
        raise AssertionError("serving launched no sharded_merge kernel")

    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    summary = {
        "rows": len(ms.index), "edges": len(ms.index.edge_slots),
        "fill_facts": fill, "fill_s": fill_s, "fill_facts_per_s": fill / fill_s,
        "merged_in_fill": merged, "fill_launches": fill_launches,
        "fill_launches_wgmma": fill_wgmma, "fill_dedup_probes": len(probes),
        "fill_dispatches": fill_dispatches, "fill_copies": len(copies),
        "fill_ingest_topk": fill_k1[0], "fill_ingest_topk_wgmma": fill_k1[1],
        "fill_dedup_resolve": fill_k1[2],
        "fill_dedup_resolve_launches_card": fill_k1[3], "fill_stage_s": spent,
        "chat_p50_ms": p50(chat_ms), "search_p50_ms": p50(search_ms),
        "launches_per_chat_turn": sorted(set(chat_launches)),
        "conversation_end_s": end_s,
        "launches_per_conversation_end": end_launches,
        "launches": mt.launches, "peak_gib": peak_gb, "reload": reload,
    }
    if n_shards > 1:
        summary.update(parity=parity_out, fill_merges=fill_merges,
                       merges_per_conversation_end=end_merges,
                       merges=sm.launches)
    log(f"{tag} fill {fill} facts in {fill_s:.1f} s = {fill / fill_s:.0f} facts/s; "
        f"{summary['rows']} rows, {summary['edges']} edges, {merged} merged; "
        f"chat p50 {summary['chat_p50_ms']:.2f} ms "
        f"({chat_launches[0]} launches/turn), search_memories p50 "
        f"{summary['search_p50_ms']:.2f} ms, conversation end {end_s:.2f} s "
        f"({end_launches} launches, {end_merges} merges), peak {peak_gb:.1f} GiB")
    if n_shards > 1:
        return summary, {"targets": targets, "new_ids": new_ids, "own": own}

    # ---- the kernel on the filled arena, against its plain version
    from lazzaro_tpu_torch.core import state as S

    st = ms.index.state
    q = torch.from_numpy(corpus.vectors(targets * 4)).to(st.emb.device)
    q = S.normalize(q).to(st.emb.dtype)
    mask = S.arena_mask(st, ms.index._tenants[TENANTS[0]], -1)
    ks, kr = mt.masked_topk(st.emb, mask, q, 10)
    ps, pr = mt.masked_topk_reference(st.emb, mask, q, 10)
    torch.cuda.synchronize()
    err = float((ks - ps).abs().max())
    # Real bf16 data: the f32 sums run in another order than torch.matmul's,
    # so scores agree within 1e-5 and rows wherever neighbours differ by more.
    gaps = torch.diff(ps, dim=1).abs()
    clear = torch.ones_like(kr, dtype=torch.bool)
    clear[:, 1:] &= gaps > 1e-5
    clear[:, :-1] &= gaps > 1e-5
    if err > 1e-5 or not torch.equal(kr[clear], pr[clear]):
        raise AssertionError(f"filled arena: kernel disagrees (max err {err})")
    log(f"[main] kernel vs plain on the filled arena: max_abs_err {err}")
    summary["filled_arena_max_abs_err"] = err
    return summary, {"targets": targets, "new_ids": new_ids, "own": own}


RELOAD_K = 10                      # top-k held across the reload


def _alice_topk(ms, corpus, convs):
    """Tenant alice's ``search_batch`` at k = ``RELOAD_K`` + 1 for
    ``PARITY_FACTS`` of her facts, read at the index without counting
    launches; and her rows' bf16 bits by node id."""
    import torch

    from lazzaro_tpu_torch.ops import masked_topk as mt
    from lazzaro_tpu_torch.ops import sharded_merge as sm

    counts = (mt.launches, mt.launches_wgmma, mt.launches_stream, sm.launches)
    idx = ms.index
    own = [c for c in range(convs) if c % len(TENANTS) == 0]
    facts = [c * PER_CONV + (977 * j) % PER_CONV
             for j, c in enumerate(own)][:PARITY_FACTS]
    res = type(idx).search_batch(idx, corpus.vectors(facts), TENANTS[0],
                                 k=RELOAD_K + 1)
    (mt.launches, mt.launches_wgmma, mt.launches_stream, sm.launches) = counts
    qids = sorted(q for q in idx.tenant_nodes.get(TENANTS[0], ()))
    rows = [idx.id_to_row[q] for q in qids]
    bits = torch.cat([idx._gather("emb", rows[i:i + 65536]).view(torch.int16)
                      if idx.mesh is not None else
                      idx.state.emb[torch.as_tensor(rows[i:i + 65536],
                                                    device=idx.device)]
                      .view(torch.int16)
                      for i in range(0, len(rows), 65536)]).cpu().numpy()
    return res, dict(zip(qids, bits))


# A reload normalizes each stored f32 vector again, on a batch of another
# size than the ingest's: the f32 norm may round the other way, which moves
# an element of the bf16 row by at most one bf16 step (2**-8 relative), and
# a score by at most the sum over such elements of |q_i| * 2**-8 * |x_i|:
# with the corpus rows' elements (|x_i| < 0.2) and a few such elements, well
# under RELOAD_TOL.
RELOAD_TOL = 2e-5


def _check_reload(before, after):
    """The served top-k after the reload against the one before. Rows by
    id: equal bits, or at most one bf16 step apart in any element. Scores
    rank by rank within ``RELOAD_TOL``; ids equal rank by rank, except
    among scores within ``RELOAD_TOL`` of each other, whose rows the reload
    may have placed in another arena order (compared as sets; a group that
    reaches past the k-th place is compared by its scores alone). Returns
    (queries, rows changed, largest step, largest score difference, tie
    slots)."""
    (res0, bits0), (res1, bits1) = before, after
    if bits0.keys() != bits1.keys():
        raise AssertionError(f"reload: {len(bits0.keys() ^ bits1.keys())} "
                             f"ids differ of {len(bits0)}")
    changed, step = 0, 0
    for q, b0 in bits0.items():
        d = np.abs(b0.astype(np.int32) - bits1[q].astype(np.int32))
        if d.any():
            changed += 1
            step = max(step, int(d.max()))
    if step > 1:
        raise AssertionError(f"reload: a row moved {step} bf16 steps")
    worst, ties = 0.0, 0
    for (i0, s0), (i1, s1) in zip(res0, res1):
        if len(s0) != len(s1):
            raise AssertionError("reload: a query found another number of rows")
        diff = float(np.abs(np.subtract(s0, s1)).max()) if s0 else 0.0
        worst = max(worst, diff)
        if diff > RELOAD_TOL:
            raise AssertionError(f"reload: scores differ by {diff}")
        for pos in range(min(RELOAD_K, len(s0))):
            group = [j for j, v in enumerate(s0) if abs(v - s0[pos]) <= RELOAD_TOL]
            if len(group) == 1:
                if i0[pos] != i1[pos]:
                    raise AssertionError(f"reload: id {i1[pos]} where "
                                         f"{i0[pos]} was at {pos}")
                continue
            ties += 1
            if max(group) < RELOAD_K and (
                    {i0[j] for j in group} != {i1[j] for j in group}):
                raise AssertionError(f"reload: tied ids differ at {pos}")
    return len(res0), changed, step, worst, ties


def _timed_switch(ms, tenant, tag, torch):
    """``ms.switch_user(tenant)`` with its seconds: the save of the tenant
    it leaves, then each part of the reload from the system's own
    ``store.load_ms`` spans (``drop`` the tenant's old rows, ``read`` the
    store, ``host_graph``, ``arena`` upload, ``edges``); logged."""
    tel = ms.telemetry
    marks = {k: len(v) for k, v in tel.timers.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms.switch_user(tenant)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    parts = _store_seconds(tel, "load", marks)
    out = {"seconds": total, "load_s": parts,
           "save_s": total - sum(parts.values()),
           "rows": len(ms.index.tenant_nodes.get(tenant, ())),
           "edges": len(ms.buffer.edges)}
    log(f"{tag} switch_user({tenant}) reloaded {out['rows']} rows and "
        f"{out['edges']} edges from the store in {total:.2f} s: save "
        f"{out['save_s']:.2f}, "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    return out


def _reload_tenant(ms, corpus, convs, tag, torch):
    """``switch_user(alice)`` after the fill: a save of the tenant the fill
    ended on, then alice's rows and edges back from the store, the rows onto
    the card in one upload. Seconds of the save and of each part of the
    reload (the system's own ``store.load_ms`` spans: ``drop`` her old rows,
    ``read`` the store, ``host_graph``, ``arena`` upload and ``edges``), the
    device memory at its peak over what was held, and the served top-k held
    against the one before (:func:`_check_reload`)."""
    before = _alice_topk(ms, corpus, convs)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = _timed_switch(ms, TENANTS[0], tag, torch)
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    queries, changed, step, worst, ties = _check_reload(
        before, _alice_topk(ms, corpus, convs))
    out.update(peak_gib_over_held=peak_gib, held_gib=held / 2 ** 30,
               topk_queries=queries, rows_changed=changed, max_bf16_step=step,
               max_score_diff=worst, tie_slots=ties)
    log(f"{tag} that reload's device memory at its peak: {peak_gib:.2f} GiB "
        f"over the {held / 2 ** 30:.2f} GiB held; rows by id: "
        f"{len(before[1]) - changed} bit-equal, {changed} at most {step} bf16 "
        f"step apart; the top-{RELOAD_K} of {queries} queries equal, scores "
        f"within {worst} (tolerance {RELOAD_TOL}; {ties} slots in near ties "
        f"compared as sets)")
    return out


def _strict_dispatch(index, torch):
    """Run every fused dispatch of ``index`` under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    wait on the device, except inside the one packed readback, which is
    counted. Returns the list the readbacks are counted in."""
    serve, readback = index.search_fused_requests, index._readback
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
            return serve(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    index.search_fused_requests, index._readback = strict, read_once
    return readbacks


def _drive_fused(ms, corpus, served, launches_out, torch):
    """The fused path on the filled system: ``serve_fused=True``, chat turns
    that miss and that hit the super-node gate (their ids held against the
    classic retrieval of the same query), ``search_memories``, a 64-query
    ``search_memories_batch`` and a 64-request mixed-k, two-tenant fleet."""
    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import masked_topk as mt
    from lazzaro_tpu_torch.ops import sharded_merge as sm
    from lazzaro_tpu_torch.serve import RetrievalRequest

    from lazzaro_tpu_torch.ops.topk import shard_groups

    # A dispatch is one two-tier launch, under a mesh one grouped launch per
    # card and, past one card, two merges (the ANN and the gate); one
    # device-to-host copy either way.
    mesh = ms.index.mesh
    scans = len(shard_groups(mesh.devices)) if mesh is not None else 1
    merges = 2 if scans > 1 else 0
    tag = "[mesh]" if ms.index.mesh is not None else "[fused]"
    prefix = "mesh_" if ms.index.mesh is not None else ""
    targets, new_ids = served["targets"], served["new_ids"]
    if ms.user_id != TENANTS[0]:
        raise AssertionError(f"the fused path starts on {ms.user_id}, not alice")
    rng = np.random.default_rng(11)
    own = served["own"]
    misses = []
    while len(misses) < 16:
        i = int(rng.choice(own)) * PER_CONV + int(rng.integers(PER_CONV))
        if not corpus.is_dup(i) and i not in misses and i not in targets:
            misses.append(i)
    prompts = [f"{corpus.text(i)}. Anything new about it?" for i in misses]
    supers = sorted(ms.super_nodes.values(), key=lambda n: n.id)[:4]
    if not supers:
        raise AssertionError("tenant alice has no super node to hit")
    hit_prompts = [f"what do I know about {sn.shard_key}? ({j})"
                   for j, sn in enumerate(supers)]
    ms.embedder.warm(prompts + [corpus.text(i) for i in misses])
    for p, sn in zip(hit_prompts, supers):
        # a reloaded node holds no vector on the host: the arena's row
        ms.embedder._memo[p] = ms.index.get_embedding(ms._q(sn.id))
    everything = prompts + hit_prompts
    # The classic retrieval of the same queries, for the id check (it is
    # not part of the fused path and is run before its counts start).
    ms.config.serve_fused = False
    expected = {p: ms._retrieve_for_chat(ms._get_embedding(p), p)[0]
                for p in everything}
    ms.query_cache.invalidate_results()
    ms.config.serve_fused = True

    # Set-up: the first dispatch builds the CSR of the filled graph.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = ms.warmup_serving((1, 64))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    csr_s = ms.index.csr_build_s
    log(f"{tag} warmup {warm_s:.2f} s ({ {str(k): round(v, 1) for k, v in warm.items()} } ms), "
        f"CSR of {len(ms.index.edge_slots)} edges built in {csr_s:.3f} s")

    readbacks = _strict_dispatch(ms.index, torch)
    got = {}
    inner = ms._retrieve_for_chat

    def spy(query_emb, query_text):
        ids, mode = inner(query_emb, query_text)
        got[query_text] = (list(ids), mode)
        return ids, mode

    ms._retrieve_for_chat = spy
    ft.launches = ft.launches_wgmma = ft.launches_stream = 0
    mt.launches = sm.launches = ft.stage_launches = 0
    want = (scans, 0, merges, 1)
    try:
        ms.start_conversation()
        chat_ms = {"miss": [], "hit": []}
        for p in everything:
            before = (ft.launches, mt.launches, sm.launches, len(readbacks))
            t1 = time.perf_counter()
            ms.chat(p)
            dt = 1e3 * (time.perf_counter() - t1)
            after = (ft.launches, mt.launches, sm.launches, len(readbacks))
            if tuple(a - b for a, b in zip(after, before)) != want:
                raise AssertionError(
                    f"fused chat turn made (fused, classic, merges, readbacks)"
                    f" = {tuple(a - b for a, b in zip(after, before))}, "
                    f"not {want}")
            ids, mode = got[p]
            if ids != expected[p]:
                raise AssertionError(f"fused chat ids {ids} != classic "
                                     f"{expected[p]} for {p!r}")
            kind = "hit" if p in hit_prompts else "miss"
            if mode != ("classic" if kind == "hit" else "device"):
                raise AssertionError(f"{kind} turn took boost mode {mode}")
            chat_ms[kind].append(dt)
        for i, p in zip(misses, prompts):
            nodes = [ms.buffer.get_node(n) for n in got[p][0]]
            if not any(n is not None and n.content == corpus.text(i)
                       for n in nodes):
                raise AssertionError(f"fused chat turn missed fact {i}")

        search_ms = []
        for i in misses + new_ids[:8]:
            before = (ft.launches, sm.launches, len(readbacks))
            t1 = time.perf_counter()
            hits = ms.search_memories(corpus.text(i))
            search_ms.append(1e3 * (time.perf_counter() - t1))
            if (ft.launches - before[0], sm.launches - before[1],
                    len(readbacks) - before[2]) != (scans, merges, 1):
                raise AssertionError("search_memories is not one fused dispatch")
            if not hits or hits[0].content != corpus.text(i):
                raise AssertionError(f"fused search_memories missed fact {i}")

        batch_facts = (targets + misses + new_ids)[:64]
        texts = [corpus.text(i) for i in batch_facts]
        ms.embedder.warm(texts)
        def one_launch_p50(fn, what):
            """p50 ms of 5 calls of ``fn``, each one dispatch: one two-tier
            launch per shard."""
            runs = []
            for _ in range(5):
                before = (ft.launches, sm.launches)
                t1 = time.perf_counter()
                out = fn()
                runs.append(1e3 * (time.perf_counter() - t1))
                if (ft.launches - before[0],
                        sm.launches - before[1]) != (scans, merges):
                    raise AssertionError(f"{what} is not one dispatch")
            return p50(runs), out

        # Each 64-query shape through the user entry point and, to split
        # off the scheduler and the host graph, through the index directly.
        batch_ms, res = one_launch_p50(
            lambda: ms.search_memories_batch(texts, limit=10),
            "search_memories_batch(64)")
        for text, hits in zip(texts, res):
            if not hits or hits[0].content != text:
                raise AssertionError(f"batch search missed {text!r}")
        batch_reqs = [RetrievalRequest(query=v, tenant=TENANTS[0], k=10)
                      for v in corpus.vectors(batch_facts)]
        batch_index_ms, _ = one_launch_p50(
            lambda: ms._serve_requests(batch_reqs), "the index's batch")

        # A fleet of both tenants with mixed k, as one scheduler group.
        bob_facts = [PER_CONV + 5 + 7 * j for j in range(32)]
        fleet = []
        for j in range(64):
            tenant = TENANTS[j % 2]
            fact = batch_facts[j // 2] if tenant == TENANTS[0] else bob_facts[j // 2]
            fleet.append(RetrievalRequest(
                query=corpus.vectors([fact])[0], tenant=tenant,
                k=(5, 10, 128)[j % 3]))
        sched = ms._ensure_scheduler()
        fleet_ms, out = one_launch_p50(
            lambda: [f.result() for f in sched.submit_many(fleet)],
            "the 64-request fleet")
        fleet_index_ms, _ = one_launch_p50(
            lambda: ms._serve_requests(fleet), "the index's fleet")
        for req, r in zip(fleet, out):
            if len(r.ids) != req.k or any(
                    not q.startswith(req.tenant + ":") for q in r.ids):
                raise AssertionError(f"fleet request of {req.tenant} k={req.k} "
                                     f"got {len(r.ids)} ids or another tenant's")
        for j in range(0, 64, 2):
            node = ms.buffer.get_node(out[j].ids[0].partition(":")[2])
            if node is None or node.content != corpus.text(batch_facts[j // 2]):
                raise AssertionError("fleet request missed its own fact")
        torch.cuda.synchronize()
    finally:
        vars(ms).pop("_retrieve_for_chat", None)
        vars(ms.index).pop("search_fused_requests", None)
        vars(ms.index).pop("_readback", None)
        torch.cuda.set_sync_debug_mode(0)
    launches_out[prefix + "fused_topk"] = ft.launches
    launches_out[prefix + "masked_topk_on_fused_path"] = mt.launches
    launches_out[prefix + "sharded_merge_on_fused_path"] = sm.launches
    log(f"{tag} fused path routes: {ft.launches_stream} streaming, "
        f"{ft.launches_wgmma} tensor-core of {ft.launches} two-tier launches; "
        f"{ft.stage_launches} kernels (a stage 1 and a stage 2 a pass)")
    if ft.launches == 0 or mt.launches != 0:
        raise AssertionError("the fused path did not run on the two-tier kernel alone")
    if merges and sm.launches == 0:
        raise AssertionError("the fused path under a mesh launched no merge")
    # Where a fused dispatch's time goes, from the serving telemetry: queue
    # wait (submit to the worker's pickup), dispatch (host set-up, launches
    # and the readback wait), decode (ids from the readback).
    tel = ms.telemetry
    spans = {name: p50(tel.timer_values(name)) for name in (
        "serve.queue_wait_ms", "serve.dispatch_ms", "serve.decode_ms")}
    log(f"{tag} fused p50 spans (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    fused = {
        "spans_p50_ms": spans,
        "chat_miss_p50_ms": p50(chat_ms["miss"]),
        "chat_hit_p50_ms": p50(chat_ms["hit"]),
        "search_p50_ms": p50(search_ms), "batch64_p50_ms": batch_ms,
        "batch64_index_p50_ms": batch_index_ms,
        "fleet64_mixed_k_p50_ms": fleet_ms,
        "fleet64_mixed_k_index_p50_ms": fleet_index_ms,
        "launches_per_chat_turn": scans, "merges_per_chat_turn": merges,
        "readbacks_per_dispatch": 1, "launches": ft.launches,
        "merges": sm.launches,
        "readbacks": len(readbacks), "csr_build_s": csr_s,
        "csr_builds": ms.index.csr_builds, "warmup_s": warm_s,
    }
    log(f"{tag} fused chat p50 {fused['chat_miss_p50_ms']:.2f} ms (gate miss), "
        f"{fused['chat_hit_p50_ms']:.2f} ms (gate hit); search_memories p50 "
        f"{fused['search_p50_ms']:.2f} ms; search_memories_batch(64) p50 "
        f"{batch_ms:.2f} ms (index {batch_index_ms:.2f}); mixed-k fleet(64) "
        f"p50 {fleet_ms:.2f} ms (index {fleet_index_ms:.2f}); "
        f"{ft.launches} two-tier launches, {sm.launches} merges, "
        f"{len(readbacks)} readbacks, 0 classic launches; CSR build "
        f"{csr_s:.3f} s")
    return fused


# ---------------------------------------------------------------------------
# Phase 3, flash attention
# ---------------------------------------------------------------------------


def causal_ops(B, T, S, H, D):
    """Operations of one causal product over the end-aligned window:
    2*B*H*D*sum_i(S-T+i+1)."""
    return 2.0 * B * H * D * (T * (S - T) + T * (T + 1) / 2)


def flash_bound(B, T, S, H, Hkv, D, item):
    """(bound_ms, bound_by) of the causal forward: 4*B*H*D*sum_i(S-T+i+1)
    operations at the type's peak, against q, k, v read once and O and the
    f32 LSE written once."""
    ops = 2 * causal_ops(B, T, S, H, D)
    moved = (2 * B * T * H * D + 2 * B * S * Hkv * D) * item + 4 * B * H * T
    peak = PEAK_OPS["bfloat16" if item == 2 else "float32"]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_flash(device):
    """The flash kernel against its plain version on every case, O and
    LSE; device times (:func:`device_ms`) of the kernel, the plain version
    and, as the yardstick the port never calls,
    ``scaled_dot_product_attention``, the kernel's achieved TFLOP/s and its
    share of the bound; event times of back-to-back calls beside them."""
    import torch
    import torch.nn.functional as F

    from lazzaro_tpu_torch.ops import flash_attention as fa

    rows_out = []
    for label, B, T, S, H, Hkv, D, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=device).manual_seed(T + S + D)
        q = torch.randn((B, T, H, D), generator=gen, device=device).to(dt)
        k = torch.randn((B, S, Hkv, D), generator=gen, device=device).to(dt)
        v = torch.randn((B, S, Hkv, D), generator=gen, device=device).to(dt)
        out, lse = fa.flash_attention_fwd(q, k, v)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref_out.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        out_tol, lse_tol = FLASH_TOL[dtype]
        if not (err <= out_tol and lse_err <= lse_tol):
            raise AssertionError(f"flash {label}: kernel disagrees with the plain "
                                 f"version (O {err}, LSE {lse_err})")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if S != T:
            mask = (torch.arange(S, device=device)[None, :]
                    <= (S - T) + torch.arange(T, device=device)[:, None])

        def lib(qt=qt, kt=kt, vt=vt, mask=mask, causal=S == T):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=causal,
                                                  enable_gqa=True)

        lib_err = float((lib().transpose(1, 2).float() - ref_out.float()).abs().max())
        big = B * T * S > 8e6
        ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v), 50)
        plain = device_ms(lambda: fa.flash_attention_reference(q, k, v),
                          4 if big else 10)
        lib_ms = device_ms(lib, 50)
        event_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), 20, WINDOWS)
        lib_event_ms = cuda_ms(lib, 20, WINDOWS)
        b_ms, b_by = flash_bound(B, T, S, H, Hkv, D, q.element_size())
        tflops = 2 * causal_ops(B, T, S, H, D) / ms / 1e9
        log(f"[flash] {label}: max_abs_err O {err} (tol {out_tol}), LSE {lse_err} "
            f"(tol {lse_tol}), library vs plain {lib_err}; device ms {ms:.4f} "
            f"({tflops:.1f} TFLOP/s, {b_ms / ms:.3f} of the bound), plain_ms "
            f"{plain:.4f}, library_ms {lib_ms:.4f}, bound_ms {b_ms:.4f} ({b_by}); "
            f"events of back-to-back calls: kernel {event_ms:.4f}, library "
            f"{lib_event_ms:.4f}")
        rows_out.append({"kernel": "flash_attention", "form": "causal_gqa_fwd",
                         "case": label, "shape": [B, T, S, H, Hkv, D],
                         "dtype": dtype, "ms": ms, "plain_ms": plain,
                         "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "tflops": tflops,
                         "bound_share": b_ms / ms, "event_ms": event_ms,
                         "library_event_ms": lib_event_ms, "max_abs_err": err,
                         "lse_max_abs_err": lse_err,
                         "library_vs_plain_max_abs_err": lib_err})
        del q, k, v, out, lse, ref_out, ref_lse, qt, kt, vt
        torch.cuda.empty_cache()
    return rows_out


def flash_bwd_bounds(B, T, S, H, Hkv, D, item):
    """{"dq": ..., "dkv": ...} (bound_ms, bound_by) of the two backward
    kernels: three causal products for dQ (s, dP, dQ) and four for dK/dV
    (s, dP, dV, dK) at the type's peak, against each kernel's inputs read
    once (q, k, v, dO, the f32 lse; dQ also reads O, dK/dV the f32 delta
    that dQ writes) and its outputs written once."""
    peak = PEAK_OPS["bfloat16" if item == 2 else "float32"]
    rows_q, rows_kv, stats = B * T * H * D * item, B * S * Hkv * D * item, 4 * B * H * T
    out = {}
    for name, products, moved in (
            ("dq", 3, 4 * rows_q + 2 * rows_kv + 2 * stats),
            ("dkv", 4, 2 * rows_q + 4 * rows_kv + 2 * stats)):
        t_ops = products * causal_ops(B, T, S, H, D) / peak
        t_bytes = moved / HBM_BYTES_PER_S
        out[name] = (1e3 * max(t_ops, t_bytes),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def phase_flash_bwd(device):
    """The dQ and dK/dV kernels against the plain backward on every case
    (dq, dk and dv, error relative to the plain result's largest
    magnitude); device times (:func:`device_ms`) of each kernel, the plain
    backward and, as the yardstick the port never calls, the backward of
    ``scaled_dot_product_attention`` (``torch.autograd.grad`` of one retained
    forward), each kernel's achieved TFLOP/s and share of the bound, event
    times of back-to-back calls beside them. On every case, the backward's
    peak device memory beyond its inputs and outputs. Returns one row per
    (kernel, case)."""
    import torch
    import torch.nn.functional as F

    from lazzaro_tpu_torch.ops import flash_attention as fa

    rows_out = []
    for label, B, T, S, H, Hkv, D, dtype in FLASH_BWD_CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=device).manual_seed(T + S + D + 1)
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(dt)
                   for shape in ((B, T, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        do = torch.randn((B, T, H, D), generator=gen, device=device).to(dt)
        out, lse = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fa.flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base
                 - sum(g.numel() * g.element_size() for g in got))
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = float((g.float() - w.float()).abs().max())
            errs[name] = (err, err / max(float(w.float().abs().max()), 1e-30))
        tol = FLASH_BWD_TOL[dtype]
        bad = {n: e for n, e in errs.items() if not e[1] <= tol}
        if bad:
            raise AssertionError(f"flash bwd {label}: kernels disagree with the "
                                 f"plain backward (abs, relative): {bad}")
        ts_f32 = T * S * 4
        if extra >= ts_f32:
            raise AssertionError(f"flash bwd {label}: {extra} bytes beyond inputs "
                                 f"and outputs, a [T, S] f32 tensor is {ts_f32}")
        del got, want
        # Timing: each kernel alone on prepared inputs (dK/dV reads the
        # delta that the last dQ launch wrote), by device time under
        # torch.profiler: at ~0.1-0.2 ms a call, CUDA events over
        # back-to-back calls also time the wrapper's host work. Event times
        # are kept beside them.
        g_do, g_lse = fa._prepare_bwd(q, k, v, out, lse, do)
        delta = torch.empty((B, H, T), dtype=torch.float32, device=device)
        big = B * T * S > 8e6

        def run_dq():
            return fa.launch_bwd_dq(q, k, v, out, g_do, g_lse, delta)

        def run_dkv():
            return fa.launch_bwd_dkv(q, k, v, out, g_do, g_lse, delta)

        dq_ms, dkv_ms = device_ms(run_dq, 20), device_ms(run_dkv, 20)
        dq_event, dkv_event = cuda_ms(run_dq, 10, WINDOWS), cuda_ms(run_dkv, 10, WINDOWS)
        plain = device_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do),
                          1 if big else 3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        mask = None
        if S != T:
            mask = (torch.arange(S, device=device)[None, :]
                    <= (S - T) + torch.arange(T, device=device)[:, None])
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 is_causal=S == T, enable_gqa=True)
        dot = do.transpose(1, 2)

        def lib(lib_out=lib_out, qt=qt, kt=kt, vt=vt, dot=dot):
            return torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)

        lib_ms = device_ms(lib, 20)
        lib_event = cuda_ms(lib, 10, WINDOWS)
        bounds = flash_bwd_bounds(B, T, S, H, Hkv, D, q.element_size())
        ops = causal_ops(B, T, S, H, D)
        tflops = {"dq": 3 * ops / dq_ms / 1e9, "dkv": 4 * ops / dkv_ms / 1e9}
        log(f"[flash-bwd] {label}: dq/dk/dv max_abs_err "
            f"{errs['dq'][0]:.3e}/{errs['dk'][0]:.3e}/{errs['dv'][0]:.3e}, relative "
            f"{errs['dq'][1]:.3e}/{errs['dk'][1]:.3e}/{errs['dv'][1]:.3e} (tol {tol}); "
            f"device ms: dq {dq_ms:.4f} ({tflops['dq']:.1f} TFLOP/s, "
            f"{bounds['dq'][0] / dq_ms:.3f} of the bound {bounds['dq'][0]:.4f} "
            f"{bounds['dq'][1]}), dkv {dkv_ms:.4f} ({tflops['dkv']:.1f} TFLOP/s, "
            f"{bounds['dkv'][0] / dkv_ms:.3f} of the bound {bounds['dkv'][0]:.4f} "
            f"{bounds['dkv'][1]}), pair {dq_ms + dkv_ms:.4f}, plain_ms {plain:.4f}, "
            f"library_ms {lib_ms:.4f}; events of back-to-back calls: dq {dq_event:.4f}, "
            f"dkv {dkv_event:.4f}, library {lib_event:.4f}; extra device memory "
            f"{extra} bytes")
        for kernel, key, ms, event, err in (
                ("flash_attention_bwd_dq", "dq", dq_ms, dq_event, errs["dq"]),
                ("flash_attention_bwd_dkv", "dkv", dkv_ms, dkv_event,
                 max(errs["dk"], errs["dv"]))):
            b_ms, b_by = bounds[key]
            rows_out.append({
                "kernel": kernel, "form": "causal_gqa_bwd", "case": label,
                "shape": [B, T, S, H, Hkv, D], "dtype": dtype, "ms": ms,
                "plain_ms": plain, "library_ms": lib_ms, "bound_ms": b_ms,
                "bound_by": b_by, "tflops": tflops[key], "bound_share": b_ms / ms,
                "event_ms": event, "library_event_ms": lib_event,
                "max_abs_err": err[0], "max_rel_err": err[1],
                "extra_device_bytes": extra})
        del q, k, v, do, out, lse, qt, kt, vt, lib_out, dot, delta, g_do, g_lse
        torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# Phase 5: the decoder LM at full width
# ---------------------------------------------------------------------------


class RecordingLLM:
    """Passes completions through and keeps (response_format, reply)."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def completion(self, messages, response_format=None):
        out = self.inner.completion(messages, response_format)
        self.calls.append((response_format, out))
        return out


def _strict_json_loop(lm, torch):
    """Run ``lm``'s on-device JSON loop under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    wait, except inside its counted readbacks."""
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


def phase_lm(launches_out: dict):
    import tempfile

    import torch

    from lazzaro_tpu_torch import MemorySystem
    from lazzaro_tpu_torch.core.providers import OnDeviceLLM
    from lazzaro_tpu_torch.models.llm import LanguageModel, LMConfig
    from lazzaro_tpu_torch.ops import flash_attention as fa

    cfg = LMConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LanguageModel(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.model.parameters())
    if lm.cfg.attn_impl != "flash":
        raise AssertionError(f"attn_impl resolved to {lm.cfg.attn_impl} on the card")
    words = ("the user keeps notes about work family travel and health "
             "and asks the assistant to remember them ").split()
    text = " ".join(words[i % len(words)] for i in range(600))[:LM_TOKENS - 1]
    if len(lm.tokenizer.encode(text)) != LM_TOKENS:
        raise AssertionError("the logits_for text is not 2,047 tokens long")

    fa.launches = 0                            # the LM path's count starts here
    flash_ms, per_call = [], []
    for _ in range(6):
        before = fa.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = lm.logits_for(text)
        flash_ms.append(1e3 * (time.perf_counter() - t1))
        per_call.append(fa.launches - before)
    if set(per_call) != {cfg.layers}:
        raise AssertionError(f"logits_for launched the kernel {per_call} times per "
                             f"call, not {cfg.layers}")
    plain_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain = lm.logits_for(text, attn_impl="xla")
        plain_ms.append(1e3 * (time.perf_counter() - t1))
    if fa.launches != 6 * cfg.layers:
        raise AssertionError("the materialized-scores path launched the kernel")
    if logits.shape != (LM_TOKENS, cfg.vocab_size) or not np.isfinite(logits).all():
        raise AssertionError(f"logits_for gave {logits.shape} or non-finite values")
    logit_err = float(np.abs(logits - plain).max())
    top1 = float((logits.argmax(-1) == plain.argmax(-1)).mean())
    if logit_err > LM_LOGIT_TOL:
        raise AssertionError(f"flash logits differ from the plain path by {logit_err}")
    fwd_p50 = p50(flash_ms[1:])
    log(f"[lm] {n_params / 1e9:.3f} B parameters, init {init_s:.1f} s; logits_for "
        f"({LM_TOKENS} tokens) p50 {fwd_p50:.2f} ms = {LM_TOKENS / fwd_p50 * 1e3:.0f} "
        f"tokens/s through flash ({cfg.layers} launches/call), plain path p50 "
        f"{p50(plain_ms[1:]):.2f} ms; max |logit diff| {logit_err} (tol "
        f"{LM_LOGIT_TOL}), top-1 agreement {top1:.4f}")

    # Decode: greedy tokens after a prefill, and generate == generate_stream.
    prompt = "User: " + LM_CHAT[0] + "\nAssistant:"
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lm._prep_prompt(prompt, 64)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t1)
    t1 = time.perf_counter()
    ids = list(lm._token_stream(prompt, 64, 0.0, 0))
    gen_ms = 1e3 * (time.perf_counter() - t1)
    decode_ms = (gen_ms - prefill_ms) / max(len(ids), 1)
    full = lm.generate(prompt, max_new_tokens=64)
    if "".join(lm.generate_stream(prompt, max_new_tokens=64)) != full:
        raise AssertionError("generate_stream does not concatenate to generate")

    # The memory system with the LM as its provider; its extraction is
    # scaffolded, so random weights still extract one fact.
    rec = RecordingLLM(OnDeviceLLM(lm, max_new_tokens=64,
                                   json_scaffold=EXTRACTION_SCAFFOLD))
    _strict_json_loop(lm, torch)
    ms = MemorySystem(device="cuda", llm_provider=rec, enable_async=False,
                      load_from_disk=False, db_dir=store_dir("lm"),
                      verbose=False)
    try:
        ms.start_conversation()
        chat_ms = []
        for msg in LM_CHAT:
            before = fa.launches
            t1 = time.perf_counter()
            reply = ms.chat(msg)
            chat_ms.append(1e3 * (time.perf_counter() - t1))
            if not isinstance(reply, str) or fa.launches != before:
                raise AssertionError("a chat turn did not decode through the cache path")
        reads0 = lm.readbacks
        t1 = time.perf_counter()
        out = ms.end_conversation()
        end_s = time.perf_counter() - t1
        copies = lm.readbacks - reads0
        if "Consolidation complete" not in out:
            raise AssertionError(f"end_conversation did not consolidate: {out!r}")
        docs = [r for fmt, r in rec.calls if fmt == {"type": "json_object"}]
        if len(docs) != 1:
            raise AssertionError(f"{len(docs)} constrained generations, expected 1")
        extracted = json.loads(docs[0])
        if not (docs[0].startswith(EXTRACTION_SCAFFOLD)
                and len(extracted["memories"]) >= 1):
            raise AssertionError(f"the extraction holds no fact: {docs[0]!r}")
        rows = len(ms.index)
        hits = ms.search_memories("what did the user say?")
        if not hits or hits[0].content != extracted["memories"][0]["content"]:
            raise AssertionError(f"search_memories missed the extracted fact "
                                 f"({rows} rows, {len(hits)} hits, extraction "
                                 f"{docs[0][:120]!r})")
    finally:
        ms.close()
        vars(lm).pop("_json_device_loop", None)
        vars(lm).pop("_readback", None)
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches_out["flash_attention"] = fa.launches
    summary = {
        "params": n_params, "init_s": init_s, "logits_for_tokens": LM_TOKENS,
        "logits_for_p50_ms": fwd_p50,
        "logits_for_tokens_per_s": LM_TOKENS / fwd_p50 * 1e3,
        "logits_for_plain_p50_ms": p50(plain_ms[1:]),
        "flash_launches_per_logits_for": cfg.layers,
        "logits_max_abs_diff_vs_plain": logit_err, "top1_agreement": top1,
        "prefill_ms": prefill_ms, "decode_tokens": len(ids),
        "decode_ms_per_token": decode_ms, "chat_turn_p50_ms": p50(chat_ms),
        "chat_turn_ms": chat_ms, "end_conversation_s": end_s,
        "copies_per_constrained_generation": copies,
        "extraction_chars": len(docs[0]),
        "extracted_facts": len(extracted["memories"]),
        "rows_after_end": rows, "search_hits": len(hits),
        "flash_launches": fa.launches,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    log(f"[lm] prefill {prefill_ms:.1f} ms, decode {decode_ms:.2f} ms/token "
        f"({len(ids)} tokens); chat turn p50 {summary['chat_turn_p50_ms']:.1f} ms; "
        f"end_conversation {end_s:.2f} s with {copies} device-to-host copies in its "
        f"constrained generation ({len(docs[0])} chars, parsed); {rows} rows, "
        f"search {len(hits)} hits; {fa.launches} flash launches; peak "
        f"{summary['peak_gib']:.1f} GiB")
    return summary


# ---------------------------------------------------------------------------
# Phase 6: training the decoder LM at full width
# ---------------------------------------------------------------------------


def train_batch(device):
    """TRAIN_B rows of TRAIN_T byte tokens (BOS + text) from seeded words."""
    import torch

    from lazzaro_tpu_torch.models.tokenizer import ByteTokenizer

    words = ("memory user agent fact work family travel health note remember "
             "conversation search extract merge link cluster tenant").split()
    rs = np.random.RandomState(7)
    tok = ByteTokenizer()
    rows = []
    for _ in range(TRAIN_B):
        text = " ".join(words[i] for i in rs.randint(0, len(words), TRAIN_T))
        rows.append(tok.encode(text)[:TRAIN_T])
    tokens = torch.tensor(rows, dtype=torch.long, device=device)
    return tokens, torch.ones_like(tokens)


def _gradients(dec, tokens, mask, impl, torch):
    from lazzaro_tpu_torch.models.llm import next_token_loss

    with torch.enable_grad():
        loss = next_token_loss(dec, tokens, mask, impl)
        loss.backward()
    grads = {}
    for name, p in dec.named_parameters():
        grads[name], p.grad = p.grad, None
    return float(loss.detach()), grads


def phase_train(device, launches_out: dict):
    import dataclasses

    import torch

    from lazzaro_tpu_torch.models.llm import (Decoder, LanguageModel, LMConfig,
                                              make_train_step)
    from lazzaro_tpu_torch.ops import flash_attention as fa

    cfg = LMConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = Decoder(cfg, device=device).init_weights(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in dec.parameters())
    tokens, mask = train_batch(device)

    # One step's gradients from the same weights, flash against plain.
    loss_f, g_f = _gradients(dec, tokens, mask, "flash", torch)
    loss_x, g_x = _gradients(dec, tokens, mask, "xla", torch)
    missing = [n for n, g in g_f.items() if g is None or g_x[n] is None]
    if missing:
        raise AssertionError(f"no gradient reached {missing}")
    worst_cos, worst_rel = (2.0, ""), (0.0, "")
    for name, g in g_f.items():
        w = g_x[name]
        cos = float(torch.nn.functional.cosine_similarity(
            g.flatten().double(), w.flatten().double(), dim=0))
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        worst_cos = min(worst_cos, (cos, name))
        worst_rel = max(worst_rel, (rel, name))
    zero = [n for n, g in g_f.items() if not bool((g != 0).any())]
    log(f"[train] {n_params / 1e9:.3f} B parameters, init {init_s:.1f} s; one step "
        f"flash vs plain: loss {loss_f:.6f} vs {loss_x:.6f} (|diff| "
        f"{abs(loss_f - loss_x):.2e}, tol {TRAIN_LOSS_TOL}), worst gradient cosine "
        f"{worst_cos[0]:.6f} ({worst_cos[1]}, tol > {TRAIN_GRAD_COS}), worst "
        f"relative norm error {worst_rel[0]:.4f} ({worst_rel[1]}); {len(g_f)} "
        f"tensors got a gradient, {len(zero)} all zero")
    if zero:
        raise AssertionError(f"all-zero gradients: {zero}")
    if abs(loss_f - loss_x) > TRAIN_LOSS_TOL or worst_cos[0] <= TRAIN_GRAD_COS:
        raise AssertionError("flash and plain gradients disagree")
    del g_f, g_x

    # The served copies before training: logits_for caches bf16 weights.
    lm = LanguageModel(cfg, device=device, decoder=dec)
    text = "The user keeps notes about work, family, travel and health." * 8
    before = lm.logits_for(text)

    opt = torch.optim.AdamW(dec.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    step = make_train_step(dataclasses.replace(cfg, attn_impl="flash"), opt)
    marks = {}

    def mark(key):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[key] = ev

    hooks = [dec.register_forward_pre_hook(lambda *a: mark("fwd0")),
             dec.register_forward_hook(lambda *a: mark("fwd1")),
             opt.register_step_pre_hook(lambda *a: mark("opt0")),
             opt.register_step_post_hook(lambda *a: mark("opt1"))]
    losses, step_ms, split, per_step, clocks = [], [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0   # the path's counts
    try:
        for _ in range(TRAIN_STEPS):
            before_n = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = step(dec, tokens, mask)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t1))
            losses.append(float(loss))
            split.append((marks["fwd0"].elapsed_time(marks["fwd1"]),
                          marks["fwd1"].elapsed_time(marks["opt0"]),
                          marks["opt0"].elapsed_time(end)))
            per_step.append(tuple(a - b for a, b in zip(
                (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches), before_n)))
            if len(losses) in (1, TRAIN_STEPS):   # the card's state, untimed
                clocks.append(nvidia_smi("clocks.sm,power.draw,temperature.gpu"))
    finally:
        for h in hooks:
            h.remove()
    counts = {"flash_attention": fa.launches,
              "flash_attention_bwd_dq": fa.bwd_dq_launches,
              "flash_attention_bwd_dkv": fa.bwd_dkv_launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = (cfg.layers, cfg.layers, cfg.layers)
    if set(per_step) != {want}:
        raise AssertionError(f"launches per step (fwd, dq, dkv) {per_step}, not {want}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    launches_out["flash_attention_bwd_dq"] = counts["flash_attention_bwd_dq"]
    launches_out["flash_attention_bwd_dkv"] = counts["flash_attention_bwd_dkv"]

    # logits_for on the trained weights: equal to freshly cast copies.
    after = lm.logits_for(text)
    for m in dec.modules():
        m.__dict__.pop("_compute_copies", None)
    fresh = lm.logits_for(text)
    if not np.array_equal(after, fresh) or np.array_equal(after, before):
        raise AssertionError("logits_for after training does not serve the "
                             "trained weights")
    p50_ms = p50(step_ms[1:])
    fwd, bwd, opt_ms = (p50([s[i] for s in split[1:]]) for i in range(3))
    summary = {
        "params": n_params, "batch": [TRAIN_B, TRAIN_T], "steps": TRAIN_STEPS,
        "lr": TRAIN_LR, "losses": losses, "step_ms": step_ms,
        "step_p50_ms": p50_ms, "tokens_per_s": TRAIN_B * TRAIN_T / p50_ms * 1e3,
        "split_ms": split, "clocks_power_temp_after_first_and_last": clocks,
        "forward_p50_ms": fwd, "backward_p50_ms": bwd, "optimizer_p50_ms": opt_ms,
        "launches_per_step": {"fwd": want[0], "bwd": want[1] + want[2]},
        "launches": counts, "peak_gib": peak_gib,
        "parity_loss_flash": loss_f, "parity_loss_plain": loss_x,
        "parity_worst_grad_cos": worst_cos[0],
        "parity_worst_grad_cos_tensor": worst_cos[1],
        "parity_worst_rel_norm_err": worst_rel[0],
        "parity_worst_rel_norm_err_tensor": worst_rel[1],
    }
    log(f"[train] {TRAIN_STEPS} AdamW steps on B={TRAIN_B} T={TRAIN_T}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; step p50 {p50_ms:.2f} ms = "
        f"{summary['tokens_per_s']:.0f} tokens/s (forward {fwd:.2f}, loss + backward "
        f"{bwd:.2f}, optimizer {opt_ms:.2f} ms, CUDA events); launches per step "
        f"{want[0]} forward + {want[1] + want[2]} backward; peak {peak_gib:.2f} GiB; "
        f"SM clock, power, temperature after the first and last step {clocks}; "
        f"logits_for after training equals freshly cast weights")
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import lazzaro_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch: {name} | count {torch.cuda.device_count()} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    global STORE_ROOT
    STORE_ROOT = tempfile.mkdtemp(prefix="lazzaro_smoke_store_")
    try:
        return _run(smi, name, device, torch)
    finally:
        shutil.rmtree(STORE_ROOT, ignore_errors=True)


def _run(smi, name, device, torch) -> int:
    log(f"[store] every MemorySystem's store and journals under {STORE_ROOT} "
        f"(free {shutil.disk_usage(STORE_ROOT).free} bytes), removed at the end")
    t_start = time.perf_counter()
    phase_s: dict = {}             # seconds by phase, for the closing line
    marks = [t_start]

    def lap(phase):
        now = time.perf_counter()
        phase_s[phase] = round(now - marks[0], 1)
        marks[0] = now

    phase_build()
    lap("build")
    cases = phase_kernels(device) + ragged_cases(device)
    torch.cuda.empty_cache()
    fused_rows = phase_fused_kernel(device)
    torch.cuda.empty_cache()
    int8_rows = phase_int8_kernel(device)
    gc.collect()
    torch.cuda.empty_cache()
    t_ivf = time.perf_counter()
    ivf_rows = phase_ivf_kernel(device)
    log(f"[kernels] ivf_topk (K5) cases took {time.perf_counter() - t_ivf:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    guard_summary = phase_guard(device)
    torch.cuda.empty_cache()
    ingest_rows, resolve_rows = phase_ingest_kernel(device)
    gc.collect()
    torch.cuda.empty_cache()
    pairwise_rows = phase_pairwise_kernel(device)
    gc.collect()
    torch.cuda.empty_cache()
    sharded_rows = phase_sharded_kernel(device)
    gc.collect()
    torch.cuda.empty_cache()
    flash_rows = phase_flash(device)
    bwd_rows = phase_flash_bwd(device)
    lap("kernels")
    launches: dict = {}
    parity: dict = {}
    summary = phase_main(launches, parity)
    log(f"[main] summary {json.dumps(summary)}")
    gc.collect()                       # the phase-4 arena goes before the mesh's
    torch.cuda.empty_cache()
    lap("main")
    default_summary = phase_default(launches)
    log(f"[default] summary {json.dumps(default_summary)}")
    default_int8 = phase_default_int8(launches)
    log(f"[default-int8] summary {json.dumps(default_int8)}")
    log(f"[guard] summary {json.dumps(guard_summary)}")
    lap("default")
    mesh_summary, filled_rows = phase_mesh(launches, parity, summary)
    log(f"[mesh] summary {json.dumps(mesh_summary)}")
    gc.collect()                       # and the mesh's before the LM
    torch.cuda.empty_cache()
    lap("mesh")
    lm_summary = phase_lm(launches)
    log(f"[lm] summary {json.dumps(lm_summary)}")
    gc.collect()                       # the LM phase's model goes before training
    torch.cuda.empty_cache()
    lap("lm")
    train_summary = phase_train(device, launches)
    log(f"[train] summary {json.dumps(train_summary)}")
    lap("train")
    log(f"[smoke] {time.perf_counter() - t_start:.1f} s after the device "
        f"phase; seconds by phase {json.dumps(phase_s)}")
    # K1 launches on every path: phase 4's fused ingest, phase 4c's default
    # configuration (its dialogue and the crash replay), phase 4b's link
    # scans; K3 on phase 4 and 4c; masked_topk on phase 4 and 4c.
    for kernel in ("ingest_topk", "dedup_resolve"):
        launches[kernel] += launches["mesh_" + kernel]
    for kernel in ("ingest_topk", "dedup_resolve", "pairwise_topk",
                   "masked_topk", "int8_topk"):
        launches[kernel] += launches["default_" + kernel]

    def entry(name, source, replaces, rows, head_case, extra_err=0.0, **extra):
        head = next(c for c in rows if c["case"] == head_case)
        return extra | {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max([c["max_abs_err"] for c in rows] + [extra_err]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["case"],
            "stage1_routes": sorted({c["route"] for c in rows if "route" in c}),
            "forms": sorted({c["form"] for c in rows}), "cases": rows}

    kernels = [
        entry("masked_topk", "lazzaro_tpu_torch/csrc/masked_topk.cu",
              "lazzaro_tpu/ops/pallas_topk.py:53", cases,
              "chat_ann_q1_k10_bf16", summary["filled_arena_max_abs_err"]),
        entry("fused_topk", "lazzaro_tpu_torch/csrc/fused_topk.cu",
              "lazzaro_tpu/ops/pallas_topk.py:101", fused_rows,
              "chat_q1_k128_kq10"),
        entry("ingest_topk", "lazzaro_tpu_torch/csrc/ingest_topk.cu",
              "lazzaro_tpu/core/state.py:1475", ingest_rows,
              "ingest_q8192_k3_bf16"),
        entry("dedup_resolve", "lazzaro_tpu_torch/csrc/dedup_resolve.cu",
              "lazzaro_tpu/core/state.py:1532", resolve_rows,
              "dedup_resolve_gram_b8192"),
        entry("int8_topk", "lazzaro_tpu_torch/csrc/int8_topk.cu",
              "lazzaro_tpu/core/state.py:2701",
              int8_rows, "chat_keyed_q1_k136_g9",
              launches_by_route={r: launches[f"int8_topk_{r}"]
                                 for r in ("wgmma", "dp4a")}),
        entry("ivf_topk", "lazzaro_tpu_torch/csrc/ivf_topk.cu",
              "lazzaro_tpu/core/state.py:3340", ivf_rows, "chat_q1_np8_bf16",
              launches_by_route=launches["ivf_topk_by_route"]),
        entry("pairwise_topk", "lazzaro_tpu_torch/csrc/pairwise_topk.cu",
              "lazzaro_tpu/ops/graphops.py:82", pairwise_rows,
              f"pairwise_{PAIR_ROWS}_bf16",
              summary["consolidation"]["k3_check"][str(LOW_SIM)]["max_abs_err"]),
        entry("sharded_topk", "lazzaro_tpu_torch/csrc/masked_topk.cu",
              "lazzaro_tpu/ops/topk.py:115",
              [c for c in sharded_rows if c["kernel"] == "sharded_topk"] + filled_rows,
              "sharded_topk_q1_k10_grid"),
        entry("sharded_merge", "lazzaro_tpu_torch/csrc/sharded_merge.cu",
              "lazzaro_tpu/ops/topk.py:47",
              [c for c in sharded_rows if c["kernel"] == "sharded_merge"],
              "search_q1_kl10_k10"),
        entry("flash_attention", "lazzaro_tpu_torch/csrc/flash_attention.cu",
              "lazzaro_tpu/ops/flash_attention.py:109", flash_rows,
              FLASH_CASES[0][0]),
        entry("flash_attention_bwd_dq",
              "lazzaro_tpu_torch/csrc/flash_attention_bwd.cu",
              "lazzaro_tpu/ops/flash_attention.py:279",
              [c for c in bwd_rows if c["kernel"] == "flash_attention_bwd_dq"],
              FLASH_BWD_CASES[0][0]),
        entry("flash_attention_bwd_dkv",
              "lazzaro_tpu_torch/csrc/flash_attention_bwd.cu",
              "lazzaro_tpu/ops/flash_attention.py:310",
              [c for c in bwd_rows if c["kernel"] == "flash_attention_bwd_dkv"],
              FLASH_BWD_CASES[0][0]),
    ]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
