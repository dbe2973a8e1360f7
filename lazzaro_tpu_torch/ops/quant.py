"""The int8 serving shadow's quantizer, counterpart of
``lazzaro_tpu/ops/quant.py:quantize_rows``.

Rows are L2-normalized, so symmetric per-row int8 (``x ≈ scale_r · q_r``,
``q`` in [-127, 127]) costs about 0.4% of a cosine while halving the bytes
a scan of a bf16 arena reads. The quantized copy is a serving shadow: the
arena stays the master, the fused ingest quantizes exactly the rows it
writes (``core.state._shadow_scatter``) and ``core.index`` rebuilds the
whole shadow lazily only where nothing maintained it. The scans over the
shadow are ``ops.int8_topk`` (K4).

This is plain torch, as the JAX function is XLA outside Pallas: one
elementwise pass over the rows it is given.
"""

from __future__ import annotations

from typing import Tuple

import torch

# f32(1 / 127): XLA's CPU backend compiles the JAX ``amax / 127.0`` as a
# product with this reciprocal, which rounds differently from the division
# for some rows; the shadow keeps JAX's bits.
RECIP_127 = float.fromhex("0x1.0204080000000p-7")


def quantize_rows(emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: ``(q [N, d] i8, scale [N] f32)`` with ``x ≈
    scale[r] · q[r]``, bit-equal to the JAX function. ``amax = max |x|`` in
    f32, ``scale = amax · f32(1/127)`` where ``amax > 0`` else 0, ``inv = 1 /
    scale`` where ``scale > 0`` else 0, ``q = clip(round_half_even(x · inv),
    -127, 127)``. Zero rows quantize to zeros with scale 0."""
    x = emb.float()
    amax = x.abs().amax(dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    recip = torch.full((), RECIP_127, dtype=torch.float32, device=x.device)
    scale = torch.where(amax > 0, amax * recip, zero)
    inv = torch.where(scale > 0, 1.0 / scale, zero)
    q = torch.clamp(torch.round(x * inv[:, None]), -127, 127).to(torch.int8)
    return q, scale
