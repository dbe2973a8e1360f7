"""Checks and times of the masked top-k scans (``ops.masked_topk``, additive
mode, and ``ops.fused_topk``, keyed mode) on one card, for the bring-up of a
stage 1 and an A/B of two checkouts.

It builds the two libraries with ``-Xptxas -v`` and prints each kernel's
registers, spills and any ptxas warning. ``--check`` holds the kernel
against its plain version, bit for bit, on grid inputs (multiples of 1/256,
whose products and sums are exact in f32) over small shapes and one shape
at the full width (1,048,576 x 768 bf16), in bf16 and f32, on every
route the tree has for the dtype and shape (the FMA route forced too), and
stops at the first disagreement. Without ``--check`` it times the main path's shapes on that
arena (bf16, then f32) and the row-sharded search over 8 shards of it: for
each case the device time per call under ``torch.profiler``, split into
stage 1 (``scan_stage1``), the merge (``scan_merge``) and the rest, and the
median of ``--reps`` rounds of CUDA-event times, on the wrapper's route
and, at Q <= 16, on the FMA route forced (every small-Q scan's route
before the streaming and tensor-core routes took them), beside the library
call (``addmm`` + ``topk``). The last line of its output is one
JSON object with the times.

Run it on a GPU from the root of a checkout:

    python3 lazzaro_tpu_torch/tools/topk_profile.py [--check]

``--root DIR`` times the ``lazzaro_tpu_torch`` package found under ``DIR``
instead (an older checkout unpacked with ``git archive``); run parent,
change, change, parent in one call and compare within it. ``--cases``
(comma-separated substrings of ``label/route``) times only the matching
cases; ``--dim`` sets the timed arenas' width (768 by default); ``--timeout`` ends the process (status 3) if it runs longer.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading

N, DIM = 1_048_576, 768
# (label, Q, k, arena dtype) of the additive mode on the full arena.
MASKED_CASES = [
    ("dedup_q8192_k1_bf16", 8192, 1, "bfloat16"),
    ("dedup_q64_k1_bf16", 64, 1, "bfloat16"),
    ("search_batch_q64_k10_bf16", 64, 10, "bfloat16"),
    ("q17_k10_bf16", 17, 10, "bfloat16"),
    ("q1024_k10_bf16", 1024, 10, "bfloat16"),
    ("q64_k300_bf16", 64, 300, "bfloat16"),
    ("chat_gate_q1_k1_bf16", 1, 1, "bfloat16"),
    ("chat_ann_q1_k10_bf16", 1, 10, "bfloat16"),
    ("q4_k10_bf16", 4, 10, "bfloat16"),
    ("q8_k1_bf16", 8, 1, "bfloat16"),
    ("q8_k10_bf16", 8, 10, "bfloat16"),
    ("q16_k10_bf16", 16, 10, "bfloat16"),
    ("q16_k128_bf16", 16, 128, "bfloat16"),
    ("chat_ann_q1_k10_f32", 1, 10, "float32"),
    ("q4_k10_f32", 4, 10, "float32"),
    ("q8_k1_f32", 8, 1, "float32"),
    ("q8_k10_f32", 8, 10, "float32"),
    ("q16_k10_f32", 16, 10, "float32"),
]
# (label, Q, k_q pattern, k_live) of the keyed mode, K = 128.
FUSED_CASES = [
    ("fleet_q64_k128_kq5-10-128", 64, (5, 10, 128), 128),
    ("batch_q64_k128_kq10", 64, (10,), 10),
    ("chat_q1_k128_kq10", 1, (10,), 10),
    ("chat_q8_k128_kq10", 8, (10,), 10),
]
# Shards of the row-sharded cases (one card holds them all) and their Q.
SHARDS = 8
SHARDED_Q = (1, 64)
# (n, Q, k, d) of the bit-exact checks on small arenas.
CHECK_SHAPES = [
    (777, 17, 1, 64), (777, 70, 16, 64), (5003, 64, 10, 32), (5003, 65, 1, 72),
    (5003, 200, 128, 64), (20000, 64, 300, 64), (300, 1100, 3, 64),
    (4096, 1, 10, 64), (4096, 8, 1, 768), (20000, 129, 129, 64),
    (6007, 3, 300, 256), (6007, 16, 128, 768), (777, 5, 5, 32),
]


def grid(gen, shape, device, dtype):
    import torch

    x = torch.randn(shape, generator=gen, device=device)
    return (torch.round(x * 16) / 256).to(dtype)


def watchdog(seconds: float) -> None:
    """Exit the process (status 3) if it runs longer than ``seconds``: a
    kernel that never finishes must not hold the card."""
    def fire():
        print(f"topk_profile: no end after {seconds} s, exiting", file=sys.stderr,
              flush=True)
        os._exit(3)
    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()


def build(names) -> None:
    from lazzaro_tpu_torch.utils import cuda_build

    started = [(n, *cuda_build.start_build(n, verbose=True)) for n in names]
    for name, proc, out in started:
        for line in cuda_build.finish_build(proc, out).splitlines():
            if "Compiling entry function" in line:
                print(f"  ptxas {name}: {line.split(chr(39))[1]}", flush=True)
            elif "registers" in line or "spill" in line or "arning" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)


def device_split(fn, calls: int) -> dict:
    """Device ms per call of ``fn`` under ``torch.profiler``: every kernel,
    stage 1, the merge and the rest."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    def total(pred):
        return sum(e.self_device_time_total for e in kernels if pred(e.key)) / 1e3 / calls
    out = {"all": total(lambda k: True), "stage1": total(lambda k: "scan_stage1" in k),
           "merge": total(lambda k: "scan_merge" in k)}
    out["rest"] = out["all"] - out["stage1"] - out["merge"]
    return out


def event_ms(fn, reps: int, calls: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        rounds.append(start.elapsed_time(end) / calls)
    return statistics.median(rounds)


def takes(mt, route, dtype, nq, d) -> bool:
    """Whether ``route`` takes this scan: the tensor cores a bf16 arena
    only, the streaming route an f32 one where ``stream_fits``."""
    import torch

    if route == "wgmma":
        return dtype == torch.bfloat16
    if route == "stream":
        return dtype == torch.float32 and mt.stream_fits(d, nq)
    return True


def route_of(mt, dtype, nq, d):
    """The wrapper's route (a tree whose rule reads no d takes two
    arguments)."""
    try:
        return mt.route_for(dtype, nq, d)
    except TypeError:
        return mt.route_for(dtype, nq)


def check(mt, ft, device) -> int:
    """Bit-exact checks of every route; returns the number of cases."""
    import torch

    routes = list(getattr(mt, "ROUTES", {None: 0}))
    done = 0
    for (n, nq, k, d), dtype in [
            (shape, dt) for shape in CHECK_SHAPES + [(N, 64, 10, DIM), (N, 1, 10, DIM)]
            for dt in (torch.bfloat16, torch.float32)]:
        gen = torch.Generator(device=device).manual_seed(n + nq + k + d)
        emb = grid(gen, (n, d), device, dtype)
        emb[n // 2:n // 2 + 40] = emb[:40]
        mask = torch.rand(n, generator=gen, device=device) < 0.7
        q = grid(gen, (nq, d), device, dtype)
        want = mt.masked_topk_reference(emb, mask, q, k)
        ten = torch.where(mask, (torch.rand(n, generator=gen, device=device) < 0.5).int(), -1).int()
        sup = torch.rand(n, generator=gen, device=device) < 0.05
        q_ten = torch.randint(0, 2, (nq,), generator=gen, device=device).int()
        kq = torch.randint(1, k + 1, (nq,), generator=gen, device=device).int()
        kf = min(k, 300)
        fwant = ft.fused_topk_reference(emb, mask, ten, sup, q, q_ten, kq, kf)
        for route in routes:
            if route is not None and not takes(mt, route, dtype, nq, d):
                continue
            extra = {} if route is None else {"route": route}
            got = mt._launch(emb, torch.where(mask, 0.0, -1e30).float(), q, k, **extra)
            fgot = ft._launch(emb, mask, ten, sup, q, q_ten, kq, kf, n - 1, None, **extra)
            torch.cuda.synchronize()
            for name, g, w in (("masked", got, want), ("fused", fgot, fwant)):
                for x, y in zip(g, w):
                    if not torch.equal(x, y):
                        bad = (x != y).nonzero()[:5].tolist()
                        print(f"[check] FAIL {name} route {route} {dtype} n={n} "
                              f"Q={nq} k={k} d={d}: {int((x != y).sum())} entries differ, first "
                              f"{bad}: got {x[tuple(zip(*bad))].tolist()} want "
                              f"{y[tuple(zip(*bad))].tolist()}", flush=True)
                        return -1
            done += 1
            print(f"[check] ok route {route} {dtype} n={n} Q={nq} k={k} d={d}",
                  flush=True)
        del emb, mask, q, want, fwant
        torch.cuda.empty_cache()
    return done


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--dim", type=int, default=DIM,
                    help="arena width of the timed cases (N rows whatever it is)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--cases", default="",
                    help="comma-separated substrings: time only matching cases")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    watchdog(args.timeout)

    import torch

    if not torch.cuda.is_available():
        print("topk_profile: no CUDA device", file=sys.stderr)
        return 2
    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import masked_topk as mt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[{args.label}] {card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build(["masked_topk", "fused_topk"])
    device = torch.device("cuda", 0)
    if args.check:
        done = check(mt, ft, device)
        print(json.dumps({"label": args.label, "card": card, "checks": done}))
        return 0 if done > 0 else 1

    routed = hasattr(mt, "route_for")

    def routes_for(dtype, nq):
        """The wrapper's route, then the record beside it at Q <= 16: the
        FMA route, forced."""
        if not routed:
            return [None]
        out = [route_of(mt, dtype, nq, args.dim)]
        return out + ["fma"] if nq <= 16 and out[0] != "fma" else out

    gen = torch.Generator(device=device).manual_seed(0)
    result = {"label": args.label, "root": args.root, "card": card, "cases": {}}
    wanted = [c for c in args.cases.split(",") if c]

    def report(key, fn, calls):
        if wanted and not any(c in key for c in wanted):
            return
        split = device_split(fn, calls)
        ev = event_ms(fn, args.reps, calls)
        result["cases"][key] = dict(split, event_ms=ev)
        print(f"[{args.label}] {key}: device {split['all']:.4f} ms (stage 1 "
              f"{split['stage1']:.4f}, merge {split['merge']:.4f}, rest "
              f"{split['rest']:.4f}), events {ev:.4f} ms", flush=True)

    for dtype_name in ("bfloat16", "float32"):
        cases = [c for c in MASKED_CASES if c[3] == dtype_name]
        if wanted and not any(w in c[0] for c in cases for w in wanted):
            continue
        dtype = getattr(torch, dtype_name)
        emb = grid(gen, (N, args.dim), device, dtype)
        alive = torch.rand(N, generator=gen, device=device) < 0.9
        madd = torch.where(alive, 0.0, -1e30).float()
        madd_t = madd.to(dtype)
        for label, nq, k, _ in cases:
            q = grid(gen, (nq, args.dim), device, dtype)
            calls = 2 if nq > 1024 else 10
            for route in routes_for(dtype, nq):
                extra = {} if route is None else {"route": route}
                report(f"{label}/{route or 'fma'}",
                       lambda: mt._launch(emb, madd, q, k, **extra), calls)
            # Yardstick only: one product with the mask folded in, torch.topk.
            report(f"{label}/library",
                   lambda: torch.topk(torch.addmm(madd_t, q, emb.t()), k), calls)
        if dtype_name == "float32":
            del emb
            torch.cuda.empty_cache()
            continue
        tenant = torch.where(alive, (torch.rand(N, generator=gen, device=device) < 0.5)
                             .int(), -1).int()
        sup = torch.rand(N, generator=gen, device=device) < 0.01
        for label, nq, kqs, k_live in FUSED_CASES:
            q = grid(gen, (nq, args.dim), device, dtype)
            q_ten = torch.tensor([i % 2 for i in range(nq)], dtype=torch.int32,
                                 device=device)
            k_q = torch.tensor([kqs[i % len(kqs)] for i in range(nq)],
                               dtype=torch.int32, device=device)
            for route in routes_for(dtype, nq):
                extra = {} if route is None else {"route": route}
                report(f"{label}/{route or 'fma'}",
                       lambda: ft._launch(emb, alive, tenant, sup, q, q_ten, k_q, 128,
                                          N - 1, k_live, **extra), 10)
        # The row-sharded search on one card: make_sharded_topk over SHARDS
        # shards of the same arena (a grouped launch where the tree has one).
        from lazzaro_tpu_torch.ops.topk import make_sharded_topk
        from lazzaro_tpu_torch.parallel import make_mesh

        mesh = make_mesh(devices=["cuda:0"] * SHARDS)
        shards = list(emb.split(N // SHARDS))
        masks = list(alive.split(N // SHARDS))
        search = make_sharded_topk(mesh, k=10)
        for nq in SHARDED_Q:
            q = grid(gen, (nq, args.dim), device, dtype)
            report(f"sharded_topk_q{nq}_k10/{route_of(mt, dtype, nq, args.dim) if routed else 'fma'}",
                   lambda: search(shards, masks, q), 10)
        del emb
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
