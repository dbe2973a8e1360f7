"""Checks and times of K5, the IVF candidate scan (``ops.ivf_topk``), and a
trace of one fused IVF chat turn beside an exact one, on one card, for an
A/B of two checkouts.

Two parts:

1. The K5 phase of a checkout's ``chip_smoke.py`` (``phase_ivf_kernel``):
   tables of the smoke's IVF build geometry over its 1,048,576 x 768 bf16
   and f32 arenas, each case held bit for bit against the plain version,
   device times under ``torch.profiler`` with stage 1 and stage 2 apart,
   the plain version, the library form, the bound, and CUDA-event times of
   back-to-back calls.
2. A chat turn at the index: ``--rows`` random unit bf16 rows filled in
   place (``serve_profile.build_index``: two tenants in blocks, a super row
   in 1,024), an IVF build over them (``ivf_maintenance``, nprobe 8), then
   ``--turns`` chat turns (one request, k 10, gate and boost) through
   ``MemoryIndex.search_fused_requests`` in the ``ivf`` mode and with the
   build set aside in the ``exact`` mode. For each: the host-clock p50 of a
   turn; the host ms a turn by part (the coarse stage, K5, ``_dedup_topk``,
   the two-tier scan of the exact mode: a turn's device is mostly idle, so
   its time is the host's); and under ``torch.profiler`` the device ms by
   kernel (K5's and the top-k scan's apart) and the device's idle share.

The last line of the output is one JSON object with the rows.

Run it on a GPU from the root of a checkout:

    python3 lazzaro_tpu_torch/tools/ivf_profile.py [--root DIR] [--label L]

``--root DIR`` runs the ``chip_smoke.py`` and the ``lazzaro_tpu_torch``
package found under ``DIR`` instead (an older checkout unpacked with ``git
archive``, whose K5 phase has its own cases); run parent, change, change,
parent in one call and compare within it. ``--no-kernels`` runs part 2
alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

# The parts of a turn, by the function of core/state.py that runs them
# (wrapped in a host timer while the trace runs).
PARTS = {"coarse": "coarse_clusters", "k5": "ivf_topk",
         "dedup": "_dedup_topk", "two_tier": "fused_topk"}


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def turn_trace(idx, reqs, kw, turns: int, label: str) -> dict:
    """Part 2 for one mode: the p50 of a turn; over ``turns`` traced turns
    the host ms a turn in each part (its function's call, launches
    included: a turn's device is mostly idle, so the host's time is the
    turn's), the device ms by kernel, K5's and the top-k scan's kernels
    apart, and the device's idle share."""
    import torch

    from lazzaro_tpu_torch.core import state as S

    for _ in range(3):
        idx.search_fused_requests(reqs, **kw)
    torch.cuda.synchronize()
    times = []
    for _ in range(turns):
        t0 = time.perf_counter()
        idx.search_fused_requests(reqs, **kw)
        times.append(1e3 * (time.perf_counter() - t0))
    real = {name: getattr(S, fn) for name, fn in PARTS.items() if hasattr(S, fn)}
    host = dict.fromkeys(real, 0.0)

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[name] += 1e3 * (time.perf_counter() - t0)
        return call

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        for name, fn in real.items():
            setattr(S, PARTS[name], timed(name, fn))
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(turns):
                idx.search_fused_requests(reqs, **kw)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    finally:
        for name, fn in real.items():
            setattr(S, PARTS[name], fn)
    cuda = torch.autograd.DeviceType.CUDA
    # Profiler ranges (``lz.*``) also show on the device's timeline; they
    # are not kernels.
    kernels = {e.key: e.self_device_time_total / 1e3 / turns
               for e in prof.key_averages()
               if e.device_type == cuda and not e.key.startswith("lz.")}
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    return {"mode": label, "p50_ms": _p50(times), "wall_ms_per_turn": wall / turns,
            "device_ms": busy, "idle_share": max(0.0, 1.0 - busy * turns / wall),
            # K5's kernels (stage 2 was i8_select, K4's, before PR 21)
            "k5_device_ms": sum(v for n, v in kernels.items()
                                if "gv_" in n or "i8_select" in n),
            "topk_scan_device_ms": sum(v for n, v in kernels.items()
                                       if "scan_stage1" in n or "scan_merge" in n),
            "host_ms_by_part": {n: v / turns for n, v in host.items() if v},
            "kernels_ms": top, "turns": turns}


def chat_turns(device, rows: int, turns: int) -> list:
    """Part 2 (see the module note)."""
    import numpy as np
    import torch

    from lazzaro_tpu_torch.core import state as S
    from lazzaro_tpu_torch.core.index import MemoryIndex
    from lazzaro_tpu_torch.serve import RetrievalRequest
    from lazzaro_tpu_torch.tools.serve_profile import build_index

    idx = build_index(torch, np, S, MemoryIndex, rows, 768, device, 0)
    idx.ivf_nprobe, idx.ivf_online = 8, True
    t0 = time.perf_counter()
    if not idx.ivf_maintenance():
        raise AssertionError("ivf_profile: the IVF build did not run")
    build_s = time.perf_counter() - t0
    q = idx.state.emb[12_345].float().cpu().numpy()
    reqs = [RetrievalRequest(query=q, tenant="bob", k=10, boost=True,
                             gate_enabled=True)]
    kw = dict(cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
              nbr_boost=0.02)
    out = [turn_trace(idx, reqs, kw, turns, "ivf")]
    built = idx.ivf_nprobe
    idx.ivf_nprobe = 0                      # no build: the exact program
    out.append(turn_trace(idx, reqs, kw, turns, "exact"))
    idx.ivf_nprobe = built
    for row in out:
        row.update(rows=rows, clusters=int(idx._ivf.n_clusters),
                   slots=int(idx._ivf.members.shape[1]), build_s=build_s)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose chip_smoke.py and package run")
    ap.add_argument("--label", default="", help="name printed with the rows")
    ap.add_argument("--rows", type=int, default=393_216,
                    help="live rows of the chat turn's index (the smoke's fill)")
    ap.add_argument("--turns", type=int, default=20,
                    help="turns timed and traced a mode")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip part 1 (the K5 phase)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("ivf_profile: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    chip_smoke.phase_build()
    rows = [] if args.no_kernels else chip_smoke.phase_ivf_kernel(device)
    torch.cuda.empty_cache()
    turns = chat_turns(device, args.rows, args.turns)
    for row in turns:
        print(f"[ivf_profile {args.label}] {json.dumps(row)}", flush=True)
    print(json.dumps({"label": args.label, "root": args.root,
                      "device": torch.cuda.get_device_name(0),
                      "rows": rows, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
