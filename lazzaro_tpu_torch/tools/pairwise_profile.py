"""Checks and times of K3, the all-pairs merge scan of ``run_consolidation``
(``ops.graphops.pairwise_merge_candidates``), on one card, for an A/B of
two checkouts.

Two parts:

1. The K3 phase of a checkout's ``chip_smoke.py`` (``phase_pairwise_kernel``):
   131,072 x 768 grid arenas of two tenants in bf16 and f32, rows and
   scores equal to the plain version, device times under ``torch.profiler``
   beside the plain version, the library form and the bound; then the same
   arenas timed by CUDA events over back-to-back calls (a profiler window
   now and then misses a launch, and reads low).
2. The shape of the smoke's filled arena: 1,048,576 x 768 bf16 unit rows
   from a seed, the tenant's rows in the fill's two blocks (rows 0 ..
   139,263 and 335,872 .. 393,215) less 1,882 dead ones, 194,726 live, with
   4,096 planted identical pairs among them. K3 at the merge gate (0.95) by
   CUDA events on the arena as ``run_consolidation`` calls it (the mask over
   every row) and on the live rows alone (gathered beforehand, an all-true
   mask), each beside its bound; the two calls' lists are held equal.

The last line of the output is one JSON object with the rows.

Run it on a GPU from the root of a checkout:

    python3 lazzaro_tpu_torch/tools/pairwise_profile.py [--root DIR] [--label L]

``--root DIR`` runs the ``chip_smoke.py`` and the ``lazzaro_tpu_torch``
package found under ``DIR`` instead (an older checkout unpacked with ``git
archive``); run parent, change, change, parent in one call and compare
within it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

N, DIM, LIVE = 1_048_576, 768, 194_726
BLOCKS = ((0, 139_264), (335_872, 393_216))   # the tenant's rows in the fill
PAIRS = 4_096
GATE = 0.95                                    # MemoryConfig.merge_similarity


def filled_shape(device, reps: int) -> dict:
    """Part 2 (see the module note)."""
    import torch

    import chip_smoke
    from lazzaro_tpu_torch.ops import graphops as gops

    gen = torch.Generator(device=device).manual_seed(12)
    emb = torch.empty((N, DIM), dtype=torch.bfloat16, device=device)
    for r in range(0, N, 131_072):
        x = torch.randn((min(131_072, N - r), DIM), generator=gen, device=device)
        emb[r:r + x.shape[0]] = (x / x.norm(dim=1, keepdim=True)).bfloat16()
    mask = torch.zeros(N, dtype=torch.bool, device=device)
    for lo, hi in BLOCKS:
        mask[lo:hi] = True
    held = mask.nonzero().view(-1)
    dead = torch.randperm(held.shape[0], generator=gen, device=device)
    mask[held[dead[:held.shape[0] - LIVE]]] = False
    live = mask.nonzero().view(-1)
    pick = live[torch.randperm(LIVE, generator=gen, device=device)[:2 * PAIRS]]
    emb[pick[PAIRS:]] = emb[pick[:PAIRS]]
    emb_live = emb[live].contiguous()
    all_live = torch.ones(LIVE, dtype=torch.bool, device=device)

    s_a, r_a = gops.pairwise_merge_candidates(emb, mask, GATE)
    s_c, r_c = gops.pairwise_merge_candidates(emb_live, all_live, GATE)
    want_r = torch.where(r_c >= 0, live[r_c.clamp(min=0).long()].int(), -1)
    if not (torch.equal(r_a[live], want_r) and torch.equal(s_a[live], s_c)
            and bool((r_a[~mask] == -1).all())):
        raise AssertionError("K3 on the arena and on its live rows disagree")
    pairs = int((r_c >= 0).sum())
    if pairs < PAIRS:
        raise AssertionError(f"K3 found {pairs} pairs of the {PAIRS} planted")
    arena_ms = chip_smoke.cuda_ms(
        lambda: gops.pairwise_merge_candidates(emb, mask, GATE), reps)
    live_ms = chip_smoke.cuda_ms(
        lambda: gops.pairwise_merge_candidates(emb_live, all_live, GATE), reps)
    b_arena, by = chip_smoke.pairwise_bound(LIVE, N, DIM, 2)
    b_live, _ = chip_smoke.pairwise_bound(LIVE, LIVE, DIM, 2)
    return {"case": f"filled_shape_{N}_{LIVE}_live_bf16", "pairs": pairs,
            "arena_event_ms": arena_ms, "arena_bound_ms": b_arena,
            "live_rows_event_ms": live_ms, "live_rows_bound_ms": b_live,
            "bound_by": by, "reps": reps}


def grid_events(device, reps: int) -> list:
    """Part 1's arenas (the phase's generator and order) by CUDA events."""
    import torch

    import chip_smoke
    from lazzaro_tpu_torch.ops import graphops as gops

    gen = torch.Generator(device=device).manual_seed(11)
    out = []
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        emb, mask = chip_smoke.pairwise_arena(gen, chip_smoke.PAIR_ROWS, dtype, device)
        ms = chip_smoke.cuda_ms(
            lambda: gops.pairwise_merge_candidates(emb, mask, GATE), reps)
        out.append({"case": f"pairwise_{chip_smoke.PAIR_ROWS}_{name}", "event_ms": ms,
                     "reps": reps})
        del emb, mask
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose chip_smoke.py and package run")
    ap.add_argument("--label", default="", help="name printed with the rows")
    ap.add_argument("--reps", type=int, default=3,
                    help="calls a CUDA-event window")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("pairwise_profile: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    rows = chip_smoke.phase_pairwise_kernel(device)
    events = grid_events(device, args.reps)
    torch.cuda.empty_cache()
    filled = filled_shape(device, args.reps)
    for row in events + [filled]:
        print(f"[pairwise_profile {args.label}] {json.dumps(row)}", flush=True)
    print(json.dumps({"label": args.label, "root": args.root,
                      "device": torch.cuda.get_device_name(0),
                      "rows": rows + events + [filled]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
