"""Times of the flash-attention forward kernel and of the decoder's
``logits_for`` through it, for an A/B of two checkouts on one card.

For each case (B, T, S, H, Hkv, D, bf16; the decoder's shapes) it prints the
kernel's median time over ``--reps`` rounds of 20 calls timed with CUDA
events, then builds ``LanguageModel(LMConfig())`` (1.1 B parameters, random
weights from ``--seed``) and prints the host-clock p50 of ``--reps``
``logits_for`` calls on a 2,047-token text, each through 18 launches of the
kernel. The last line of its output is one JSON object with the times.

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
TEXT_TOKENS = 2047


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
    result = {"label": args.label, "root": args.root, "card": card, "kernel_ms": {}}

    for label, B, T, S, H, Hkv, D in CASES:
        gen = torch.Generator(device=device).manual_seed(args.seed + T + S + D)
        q, k, v = (torch.randn(shape, generator=gen, device=device).bfloat16()
                   for shape in ((B, T, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        rounds = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fa.flash_attention_fwd(q, k, v)
            end.record()
            torch.cuda.synchronize()
            rounds.append(start.elapsed_time(end) / 20)
        result["kernel_ms"][label] = statistics.median(rounds)
        print(f"[{args.label}] {label}: kernel median {statistics.median(rounds):.4f} "
              f"ms (rounds {min(rounds):.4f}-{max(rounds):.4f})", flush=True)

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
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
