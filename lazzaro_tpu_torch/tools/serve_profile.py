"""Latency and a profiler trace of one fused serving dispatch, at the index.

Fills a ``MemoryIndex`` directly on the device (random unit bf16 rows, two
tenants in blocks of 8,192 rows, one super row in 1,024, a chain of edges
inside each block), then serves four request shapes through
``MemoryIndex.search_fused_requests``, the entry point the scheduler calls:

    search  1 request,  k=5,  read only      (``search_memories``)
    chat    1 request,  k=10, boost and gate (a chat turn)
    batch   64 requests, k=10, read only     (``search_memories_batch``)
    fleet   64 requests of both tenants, k in {5, 10, 128}, read only

For each it prints the host-clock p50 of ``--reps`` calls (each call ends in
the dispatch's one readback, so it covers the whole dispatch) and of as
many calls through a ``QueryScheduler`` in front of the index (submit to
result: the worker thread's hand-off included), checks that every request
finds the row its query was made from, and writes
``torch.profiler`` tables of ``--trace`` calls of each shape (sorted by self
CPU and by self CUDA time) to ``--out`` (default ``serve_profile_out/``). The last line of its output is one
JSON object with the p50s.

Run it on a GPU from the root of a checkout:

    python3 lazzaro_tpu_torch/tools/serve_profile.py

``--root DIR`` serves with the ``lazzaro_tpu_torch`` package found under
``DIR`` instead (an older checkout, for an A/B in one process layout);
``--shards N`` row-shards the same arena over N shards of the one device
(``MemoryIndex(mesh=make_mesh(devices=[device] * N))``, the smoke's mesh
phase layout); ``--device cpu --rows 20000 --dim 64`` runs it on the CPU
at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


BLOCK = 8192            # rows per tenant block; tenants alternate by block


def build_index(torch, np, S, MemoryIndex, rows, dim, device, seed, shards=0):
    """An index of ``rows`` live rows filled in place on ``device``, one
    arena or ``shards`` shards of it."""
    block, super_every = BLOCK, 1024
    cap = -(-(rows + 1) // S.TOPK_BLOCK) * S.TOPK_BLOCK - 1
    mesh = None
    if shards:
        from lazzaro_tpu_torch.parallel import make_mesh
        mesh = make_mesh(devices=[device] * shards)
    idx = MemoryIndex(dim, capacity=cap, edge_capacity=8,
                      dtype="bfloat16" if device.type == "cuda" else "float32",
                      **({"mesh": mesh} if mesh is not None else {"device": device}))
    parts = [idx.state] if mesh is None else idx.shards
    local_n = parts[0].salience.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    for r0 in range(0, rows, 65536):
        r1 = min(rows, r0 + 65536)
        x = torch.randn((r1 - r0, dim), generator=gen, device=device)
        x = (x / x.norm(dim=1, keepdim=True)).to(parts[0].emb.dtype)
        for p, st in enumerate(parts):
            lo, hi = max(r0, p * local_n), min(r1, (p + 1) * local_n)
            if lo < hi:
                st.emb[lo - p * local_n:hi - p * local_n] = x[lo - r0:hi - r0]
    for p, st in enumerate(parts):
        r = torch.arange(p * local_n, (p + 1) * local_n, device=device)
        live = r < rows
        st.alive.copy_(live)
        st.tenant_id.copy_(torch.where(live, (r // block) % 2, -1).int())
        st.is_super.copy_(live & (r % super_every == 0))
        st.salience.copy_(torch.where(live, 0.5, 0.0))
    idx._tenants = {"alice": 0, "bob": 1}
    names = ("alice", "bob")
    idx.id_to_row = {f"{names[(i // block) % 2]}:{i}": i for i in range(rows)}
    idx.row_to_id = {i: q for q, i in idx.id_to_row.items()}
    idx.tenant_nodes = {n: set() for n in names}
    for q, i in idx.id_to_row.items():
        idx.tenant_nodes[names[(i // block) % 2]].add(q)
    ids = [idx.row_to_id[i] for i in range(rows)]
    idx.edge_slots.update(((ids[i], ids[i + 1]), i) for i in range(rows - 1)
                          if (i + 1) % block)
    idx._free_rows = list(range(cap - 1, rows - 1, -1))
    idx._csr_dirty = True
    return idx


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="change")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1_040_384)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--trace", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--out", default="serve_profile_out")
    args = ap.parse_args()
    if args.rows <= BLOCK:
        ap.error(f"--rows must exceed {BLOCK} so that both tenants own rows")
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from lazzaro_tpu_torch.core import state as S
    from lazzaro_tpu_torch.core.index import MemoryIndex
    from lazzaro_tpu_torch.serve import QueryScheduler, RetrievalRequest

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 2
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    idx = build_index(torch, np, S, MemoryIndex, args.rows, args.dim, device,
                      args.seed, args.shards)
    sync()
    build_s = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    emb = idx.state.emb if not args.shards else torch.cat([st.emb for st in idx.shards])

    def requests(n, tenants, ks, boost=False):
        rows = []
        for j in range(n):
            t = tenants[j % len(tenants)]
            while True:
                r = int(rng.integers(args.rows))
                if (r // BLOCK) % 2 == t and r % 1024:
                    break
            rows.append(r)
        vecs = emb[torch.tensor(rows, device=device)].float().cpu().numpy()
        vecs = vecs + 1e-3 * rng.standard_normal(vecs.shape).astype(np.float32)
        reqs = [RetrievalRequest(query=v, tenant=("alice", "bob")[tenants[
            j % len(tenants)]], k=ks[j % len(ks)], gate_enabled=boost,
            boost=boost) for j, v in enumerate(vecs)]
        return reqs, rows

    shapes = {
        "search": requests(1, (0,), (5,)),
        "chat": requests(1, (0,), (10,), boost=True),
        "batch": requests(64, (0,), (10,)),
        "fleet": requests(64, (0, 1), (5, 10, 128)),
    }
    kw = dict(cap_take=5, max_nbr=32, super_gate=0.4, acc_boost=0.05,
              nbr_boost=0.02)

    def serve(name):
        return idx.search_fused_requests(shapes[name][0], **kw)

    t0 = time.perf_counter()
    serve("search")                 # builds the kernel and the CSR
    sync()
    first_s = time.perf_counter() - t0
    out = {"label": args.label, "card": card, "rows": args.rows, "shards": args.shards,
           "dim": args.dim, "build_s": build_s, "first_call_s": first_s,
           "csr_build_s": idx.csr_build_s, "edges": len(idx.edge_slots)}
    os.makedirs(args.out, exist_ok=True)
    for name, (reqs, rows) in shapes.items():
        for _ in range(3):
            res = serve(name)
        for req, row, r in zip(reqs, rows, res):
            if not r.ids or r.ids[0] != idx.row_to_id[row] \
                    or len(r.ids) != req.k:
                raise AssertionError(f"{name}: request for row {row} got "
                                     f"{r.ids[:3]} ({len(r.ids)} ids)")
        times = []
        for _ in range(args.reps):
            t1 = time.perf_counter()
            serve(name)
            times.append(1e3 * (time.perf_counter() - t1))
        out[f"{name}_p50_ms"] = p50(times)
        out[f"{name}_min_ms"] = min(times)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.trace):
                serve(name)
            sync()
        ka = prof.key_averages()
        path = os.path.join(args.out, f"serve_profile_{args.label}_{name}.txt")
        with open(path, "w") as f:
            f.write(f"{card} | {args.label} | {name} | {args.trace} calls\n")
            f.write(ka.table(sort_by="self_cpu_time_total", row_limit=30))
            f.write("\n")
            if device.type == "cuda":
                f.write(ka.table(sort_by="self_device_time_total",
                                 row_limit=15))
        top = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:6]
        out[f"{name}_top_self_cpu_us_per_call"] = {
            e.key: round(e.self_cpu_time_total / args.trace, 1) for e in top}
        if device.type == "cuda":
            # device time as the profiler totals it: device events, not
            # the user annotations mirrored onto the device timeline
            dev_ms = sum(e.self_device_time_total for e in ka
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not e.is_user_annotation) / 1e3 / args.trace
            out[f"{name}_device_ms_per_call"] = dev_ms
            out[f"{name}_device_idle_share"] = 1 - dev_ms / out[f"{name}_p50_ms"]
        print(f"[{args.label}] {name}: p50 {out[f'{name}_p50_ms']:.3f} ms, "
              f"min {out[f'{name}_min_ms']:.3f} ms", flush=True)
    sched = QueryScheduler(lambda reqs: idx.search_fused_requests(reqs, **kw),
                           device=device)
    try:
        for name, (reqs, _) in shapes.items():
            times = []
            for i in range(args.reps + 3):
                t1 = time.perf_counter()
                [f.result() for f in sched.submit_many(reqs)]
                if i >= 3:
                    times.append(1e3 * (time.perf_counter() - t1))
            out[f"{name}_scheduler_p50_ms"] = p50(times)
            print(f"[{args.label}] {name} through the scheduler: p50 "
                  f"{p50(times):.3f} ms", flush=True)
    finally:
        sched.close()
    stage = getattr(idx, "_stage", None)
    out["pinned_buffers"] = getattr(stage, "allocations", None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
