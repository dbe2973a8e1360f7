"""Times of the flash-attention kernels (the forward, the dQ and the dK/dV
backward) and of the decoder's ``logits_for`` and train step through them,
for an A/B of two checkouts on one card.

For each forward case (B, T, S, H, Hkv, D, bf16; the decoder's shapes) it
prints the kernel's median time over ``--reps`` rounds of 20 calls timed
with CUDA events and its device time per call under ``torch.profiler``
(the events also count the gaps in which the card waits for the host,
which for a call of ~0.05 ms are as long as the call), and for each
backward case the dQ and the dK/dV kernels' medians over ``--reps`` rounds
of 10 calls and their device times. It then builds
``LanguageModel(LMConfig())`` (1.1 B parameters, random weights from
``--seed``) and prints the host-clock p50 of ``--reps`` ``logits_for`` calls
on a 2,047-token text, each through 18 launches of the forward kernel, and
the host-clock p50 of ``--reps`` AdamW train steps of that decoder on one
B=2, T=2,048 batch (18 forward and 36 backward launches each), and the
device time per step under ``torch.profiler``: all kernels, the three
flash kernels, the ten largest. A tree without the backward kernels skips
their cases and the train step. The last line of its output is one JSON
object with the times.

Run it on a GPU from the root of a checkout:

    python3 lazzaro_tpu_torch/tools/flash_profile.py

``--root DIR`` times the ``lazzaro_tpu_torch`` package found under ``DIR``
instead (an older checkout unpacked with ``git archive``); run parent,
change, change, parent in one call and compare within it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CASES = [
    ("logits_for_b1_t2047_h8_kv2_d256", 1, 2047, 2047, 8, 2, 256),
    ("b4_t2048_h8_kv2_d256", 4, 2048, 2048, 8, 2, 256),
    ("small_b8_t1024_h8_kv2_d64", 8, 1024, 1024, 8, 2, 64),
    ("chunked_b1_t13_s2048_h8_kv2_d256", 1, 13, 2048, 8, 2, 256),
]
BWD_CASES = [
    ("train_b2_t2048_h8_kv2_d256", 2, 2048, 2048, 8, 2, 256),
    ("small_b8_t1024_h8_kv2_d64", 8, 1024, 1024, 8, 2, 64),
    ("chunked_b1_t64_s2048_h8_kv2_d256", 1, 64, 2048, 8, 2, 256),
]
TEXT_TOKENS = 2047
TRAIN_B, TRAIN_T = 2, 2048


def median_ms(fn, reps: int, calls: int) -> list:
    """ms per call of ``fn`` in each of ``reps`` rounds of ``calls`` calls,
    timed with CUDA events after one warm-up call."""
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
    return rounds


def device_ms(fn, calls: int) -> float:
    """Device time per call of ``fn`` under ``torch.profiler`` (the sum of
    its CUDA kernels over ``calls`` calls, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


# Kernel groups of a train step, by a substring of the kernel's name (bf16
# runs flash_fwd_wgmma, flash_bwd_dq_wgmma and flash_bwd_dkv_wgmma; older
# trees' kernels end in _kernel).
GROUPS = (("flash_fwd", "flash_fwd_"), ("flash_bwd_dq", "flash_bwd_dq_"),
          ("flash_bwd_dkv", "flash_bwd_dkv_"))


def step_device_ms(run, steps: int, label: str) -> dict:
    """Device time per call of ``run`` under ``torch.profiler`` over
    ``steps`` calls: all device kernels ("all"), the flash kernels by
    group, and the ten largest kernels printed."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    out = {"all": sum(e.self_device_time_total for e in kernels) / 1e3 / steps}
    for group, needle in GROUPS:
        out[group] = sum(e.self_device_time_total for e in kernels
                         if needle in e.key) / 1e3 / steps
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[{label}]   {e.self_device_time_total / 1e3 / steps:9.3f} ms/step "
              f"x{e.count // steps:4d} {e.key[:110]}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from lazzaro_tpu_torch.models.llm import LanguageModel, LMConfig
    from lazzaro_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    result = {"label": args.label, "root": args.root, "card": card, "kernel_ms": {},
              "kernel_device_ms": {}}

    def inputs(seed, B, T, S, H, Hkv, D):
        gen = torch.Generator(device=device).manual_seed(seed)
        return [torch.randn(shape, generator=gen, device=device).bfloat16()
                for shape in ((B, T, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                              (B, T, H, D))]

    def report(key, fn, calls):
        rounds = median_ms(fn, args.reps, calls)
        dev = device_ms(fn, 2 * calls)
        result["kernel_ms"][key] = statistics.median(rounds)
        result["kernel_device_ms"][key] = dev
        print(f"[{args.label}] {key}: kernel median {statistics.median(rounds):.4f} "
              f"ms (rounds {min(rounds):.4f}-{max(rounds):.4f}), device {dev:.4f} "
              f"ms", flush=True)

    for label, B, T, S, H, Hkv, D in CASES:
        q, k, v, _ = inputs(args.seed + T + S + D, B, T, S, H, Hkv, D)
        report(label, lambda: fa.flash_attention_fwd(q, k, v), 20)
    has_bwd = hasattr(fa, "launch_bwd_dq")
    for label, B, T, S, H, Hkv, D in BWD_CASES if has_bwd else ():
        q, k, v, do = inputs(args.seed + T + S + D + 1, B, T, S, H, Hkv, D)
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = torch.empty((B, H, T), dtype=torch.float32, device=device)
        report(f"bwd_dq_{label}",
               lambda: fa.launch_bwd_dq(q, k, v, out, do, lse, delta), 10)
        report(f"bwd_dkv_{label}",
               lambda: fa.launch_bwd_dkv(q, k, v, out, do, lse, delta), 10)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()

    lm = LanguageModel(LMConfig(), seed=args.seed)
    text = ("the user keeps notes about work family travel and health " * 40)
    text = text[:TEXT_TOKENS - 1]
    lm.logits_for(text)
    times = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.logits_for(text)
        times.append(1e3 * (time.perf_counter() - t0))
    result["logits_for_p50_ms"] = statistics.median(times)
    result["logits_for_ms"] = times
    print(f"[{args.label}] logits_for ({TEXT_TOKENS} tokens) p50 "
          f"{statistics.median(times):.2f} ms on {card}", flush=True)
    if has_bwd:
        from lazzaro_tpu_torch.models.llm import make_train_step

        dec = lm.model
        del lm
        opt = torch.optim.AdamW(dec.parameters(), lr=3e-4, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4)
        step = make_train_step(dec.cfg, opt)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        tokens = torch.randint(0, 256, (TRAIN_B, TRAIN_T), generator=gen,
                               device=device)
        mask = torch.ones_like(tokens)
        step(dec, tokens, mask)
        times = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(dec, tokens, mask)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        result["train_step_p50_ms"] = statistics.median(times)
        result["train_step_ms"] = times
        print(f"[{args.label}] train step (B={TRAIN_B}, T={TRAIN_T}, AdamW) p50 "
              f"{statistics.median(times):.2f} ms on {card}", flush=True)
        result["train_step_device_ms"] = step_device_ms(
            lambda: step(dec, tokens, mask), args.reps, args.label)
        dev = result["train_step_device_ms"]
        print(f"[{args.label}] train step device ms (profiler): "
              + ", ".join(f"{k} {v:.2f}" for k, v in dev.items())
              + f"; busy share of the p50 {dev['all'] / result['train_step_p50_ms']:.3f}",
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
