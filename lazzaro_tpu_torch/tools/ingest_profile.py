"""Device times of the ingest scan (K1, ``ops.ingest_topk``) by its parts, on
one card: the probe alone, one link mode, two, and the probe with two (the
fused dedup ingest's scan), beside ``masked_topk`` at k = 1 and k = 3 on the
same queries (the additive mode's kc = 1 and list epilogues), at Q = 8,192
(the fill's mega-batch) and Q = 1,024 over a 1,048,576 x 768 bf16 grid arena
of two tenants and 12 shards; with ``--dtype float32`` over the same arena
in f32 (the default ``MemoryConfig.dtype``), where the small batches of a
conversation end (``--q 1,8,16``) stream, each part also timed on the FMA
stage forced. Each case prints two times per call: the
device time under ``torch.profiler`` (the sum of the CUDA kernels over
``--calls`` calls after one warm-up call) and the CUDA-event time of the
same number of back-to-back calls (which also holds the wrapper's host
work, a small share at these sizes; a profiler window now and then misses
a call's kernels, and the event time shows it).

Run it on a GPU from the root of a checkout:

    python3 lazzaro_tpu_torch/tools/ingest_profile.py [--calls N] [--q 8192,1024]
        [--dtype bfloat16|float32]

A/B of two trees: unpack the other with ``git archive`` into a git-ignored
directory and run its copy of this file in the same call.
"""

from __future__ import annotations

import argparse
import os
import sys

N, DIM = 1_048_576, 768
# The checkout this file lies in, so that it runs by its path.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def times_ms(fn, calls: int):
    """(device ms, event ms) per call of ``fn`` over ``calls`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == cuda) / 1e3 / calls
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device, start.elapsed_time(end) / calls


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    from lazzaro_tpu_torch.ops import ingest_topk as it
    from lazzaro_tpu_torch.ops import masked_topk as mt

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--q", default="8192,1024")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)

    def grid(shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return (torch.round(x * 16) / 256).to(dtype)

    emb = grid((N, DIM))
    alive = torch.rand(N, generator=gen, device=dev) < 0.9
    ten = torch.where(alive, (torch.rand(N, generator=gen, device=dev) < 0.5).int(),
                      -1).int()
    sup = (torch.rand(N, generator=gen, device=dev) < 0.01) & alive
    shard = torch.randint(0, 12, (N,), generator=gen, device=dev).int()
    excl = torch.arange(N, device=dev) == N - 1
    madd = torch.where(alive & (ten == 0) & ~sup, 0.0, -1e30)
    print(f"{torch.cuda.get_device_name(0)}, {args.dtype} arena", flush=True)
    for nq in (int(x) for x in args.q.split(",")):
        batch = torch.randperm(N - 1, generator=gen, device=dev)[:nq]
        q = torch.cat([emb[batch[:nq // 2]], grid((nq - nq // 2, DIM))])
        qs = torch.randint(0, 12, (nq,), generator=gen, device=dev).int()
        lex = excl.index_fill(0, batch, True)
        for label, modes, probe in (("probe only", (), True),
                                    ("one mode", (0,), False),
                                    ("two modes", (1, 0), False),
                                    ("probe + two modes", (1, 0), True)):
            cols = (emb, alive, ten, sup, shard, excl, lex, q, qs, 0, 3, modes,
                    probe)
            route = it.route_for(dtype, nq, DIM)
            for forced in ([None, "fma"] if route == "stream" else [None]):
                ms = times_ms(lambda: it._launch(*cols, route=forced), args.calls)
                print(f"Q={nq} ingest_topk {label} ({forced or route}): device "
                      f"{ms[0]:.3f} ms, events {ms[1]:.3f} ms", flush=True)
        for k in (1, 3):
            ms = times_ms(lambda: mt.masked_topk(emb, madd, q, k), args.calls)
            print(f"Q={nq} masked_topk k={k} ({mt.route_for(dtype, nq, DIM)}): "
                  f"device {ms[0]:.3f} ms, events {ms[1]:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
