"""Causal grouped-query flash attention: the Hopper kernel, its plain version
and the materialized-scores reference of the decoder LM.

Replaces the TPU kernel ``lazzaro_tpu/ops/flash_attention.py:_flash_fwd_bhtd``
(body ``_flash_kernel``) and the forward half of its ``flash_attention``
custom VJP. The kernel is CUDA C++ in ``csrc/flash_attention.cu`` (its note
says what bounds it and how it is laid out), built with ``nvcc`` for
``sm_90a`` on first use and bound through ``ctypes``.

Layouts are the JAX package's at every public function: q ``[B, T, H, D]``,
k/v ``[B, S, Hkv, D]`` with ``H % Hkv == 0`` and ``S >= T``; the causal
diagonal is end-aligned (query row i attends keys ``0 .. (S - T) + i``).

- :func:`flash_attention_fwd` returns ``(out [B, T, H, D] in q's type,
  lse [B, H, T] f32)``. A CUDA tensor launches the kernel (which reads q, k
  and v in place through their strides); a CPU tensor runs
  :func:`flash_attention_reference`, the kernel's arithmetic written plainly.
- :func:`flash_attention` is the ``torch.autograd.Function`` around it; its
  backward (TPU kernels ``_flash_bwd_bhtd`` and the VJP) is not ported yet.
- :func:`reference_attention` is the decoder's ``"xla"`` path, with JAX's
  rounding: the score product runs in q's type and is then cast to f32, P is
  cast to q's type before the P.V product, masked scores are ``NEG``.

``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from lazzaro_tpu_torch.utils import cuda_build

NEG = -1e30
MAX_HEAD_DIM = 256

launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q [B, T, H, D], k/v [B, S, Hkv, D]")
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("flash_attention: q and k/v differ in batch or head_dim")
    if H % k.shape[2]:
        raise ValueError(f"heads {H} not a multiple of kv heads {k.shape[2]}")
    if k.shape[1] < T:
        raise ValueError(f"kv length {k.shape[1]} shorter than query length {T}")


def _repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """``jnp.repeat(x, rep, axis=2)``: each kv head ``rep`` times in a row."""
    B, S, Hkv, D = x.shape
    return x[:, :, :, None, :].expand(B, S, Hkv, rep, D).reshape(B, S, Hkv * rep, D)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic, written plainly with the scores
    materialized: f32 scores of the exact products, ``NEG`` above the
    end-aligned diagonal, softmax statistics in f32, P cast to V's type
    before an f32-accumulated P.V, ``l`` clamped at 1e-30. Returns
    ``(out in q's type, lse [B, H, T] f32)``."""
    _check(q, k, v)
    T, H, D = q.shape[1], q.shape[2], q.shape[3]
    S, rep = k.shape[1], q.shape[2] // k.shape[2]
    kf = _repeat_heads(k.float(), rep)
    vr = _repeat_heads(v, rep)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * (1.0 / math.sqrt(D))
    row = (S - T) + torch.arange(T, device=q.device)[:, None]
    col = torch.arange(S, device=q.device)[None, :]
    s = s.masked_fill(col > row, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), vr.float())
    out = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    _check(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes f32 or bf16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must be on one device")
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} is not a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    if T < 1 or -(-T // 64) * H * B >= 2 ** 31:
        raise ValueError("flash_attention: needs T >= 1 and at most 2**31 - 1 "
                         "blocks of 64 query rows")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} needs a unit last "
                             f"stride and 16-byte aligned rows")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), B, T, S, H, Hkv, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal GQA attention forward: ``(out [B, T, H, D], lse [B, H, T]
    f32)``. Raises ``ValueError`` for S < T. A CUDA tensor launches the
    kernel; a CPU tensor runs :func:`flash_attention_reference`."""
    if q.device.type == "cuda":
        return _launch(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        return flash_attention_fwd(q, k, v)[0]

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention backward (TPU kernel _flash_bwd_bhtd) is not "
            "ported yet (ROADMAP Queue 2 item 4)")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal GQA flash attention: q ``[B, T, H, D]``, k/v ``[B, S, Hkv, D]``
    → ``[B, T, H, D]`` in q's type (see :func:`flash_attention_fwd`)."""
    return _FlashAttention.apply(q, k, v)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        attn_mask: torch.Tensor, scale: float = 0.0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Materialized-scores GQA attention, the JAX package's one einsum
    formulation: q ``[B, T, H, D]``, k/v ``[B, S, Hkv, D]``, ``attn_mask``
    ``[B, T, S]`` bool (or broadcastable) → ``[B, T, H, D]`` in q's type.
    ``scale`` 0 means 1/sqrt(head_dim); ``softcap`` > 0 applies Gemma-2's
    ``cap * tanh(s / cap)`` before masking."""
    H, D = q.shape[2], q.shape[3]
    rep = H // k.shape[2]
    k, v = _repeat_heads(k, rep), _repeat_heads(v, rep)
    s = torch.einsum("bthd,bshd->bhts", q, k).float()
    s = s * (scale if scale > 0 else 1.0 / math.sqrt(D))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~attn_mask[:, None], NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", p, v)


def reference_gqa(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """End-aligned causal :func:`reference_attention` (JAX
    ``_reference_gqa``)."""
    T, S = q.shape[1], k.shape[1]
    row = (S - T) + torch.arange(T, device=q.device)[:, None]
    col = torch.arange(S, device=q.device)[None, :]
    return reference_attention(q, k, v, (col <= row)[None])
