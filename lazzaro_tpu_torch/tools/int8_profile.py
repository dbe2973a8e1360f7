"""Checks and times of K4, the int8 coarse scan (``ops.int8_topk``), on one
card, for an A/B of two checkouts.

It runs the K4 phase of a checkout's ``chip_smoke.py``
(``phase_int8_kernel``): on the int8 shadow of the smoke's 1,048,576 x 768
bf16 two-tier arena, each case held bit for bit against the plain
version, then its device time per call under ``torch.profiler`` with
stage 1 and stage 2 apart, the plain version, the library call
(``torch._int_mm`` + ``topk``), CUDA-event times of back-to-back calls and
the bound, each row naming the route the launch took. The last line of the
output is one JSON object with the rows.

Run it on a GPU from the root of a checkout:

    python3 lazzaro_tpu_torch/tools/int8_profile.py [--root DIR] [--label L]

``--root DIR`` runs the ``chip_smoke.py`` and the ``lazzaro_tpu_torch``
package found under ``DIR`` instead (an older checkout unpacked with ``git
archive``, whose K4 phase has its own cases); run parent, change, change,
parent in one call and compare within it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose chip_smoke.py and package run")
    ap.add_argument("--label", default="", help="name printed with the rows")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("int8_profile: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    rows = chip_smoke.phase_int8_kernel(device)
    print(json.dumps({"label": args.label, "root": args.root,
                      "device": torch.cuda.get_device_name(0), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
