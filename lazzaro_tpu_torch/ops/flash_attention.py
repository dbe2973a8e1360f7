"""Causal grouped-query flash attention: the Hopper kernels, their plain
versions and the materialized-scores reference of the decoder LM.

Replaces the TPU kernels of ``lazzaro_tpu/ops/flash_attention.py``:
``_flash_fwd_bhtd`` (body ``_flash_kernel``), the two ``pallas_call``s of
``_flash_bwd_bhtd`` (bodies ``_flash_dq_kernel`` and ``_flash_dkv_kernel``)
and their ``flash_attention`` custom VJP. The kernels are CUDA C++ in
``csrc/flash_attention.cu`` (forward: wgmma with register accumulators, K
and V through a TMA ring, from the Hopper building blocks of
``csrc/flash_hopper.cuh``) and ``csrc/flash_attention_bwd.cu`` (dQ and
dK/dV, bf16 on the same blocks: wgmma, register accumulators, TMA rings;
their notes say what bounds them and how they are laid out), built
with ``nvcc`` for ``sm_90a`` on first use and bound through ``ctypes``.

Layouts are the JAX package's at every public function: q ``[B, T, H, D]``,
k/v ``[B, S, Hkv, D]`` with ``H % Hkv == 0`` and ``S >= T``; the causal
diagonal is end-aligned (query row i attends keys ``0 .. (S - T) + i``).

- :func:`flash_attention_fwd` returns ``(out [B, T, H, D] in q's type,
  lse [B, H, T] f32)``. A CUDA tensor launches the kernel (which reads q, k
  and v in place through their strides); a CPU tensor runs
  :func:`flash_attention_reference`, the kernel's arithmetic written plainly.
- :func:`flash_attention_bwd` returns ``(dq, dk, dv)`` from q, k, v, the
  forward's out and lse and the upstream gradient; a CUDA tensor launches
  the dQ and the dK/dV kernels, a CPU tensor runs
  :func:`flash_attention_bwd_reference`.
- :func:`flash_attention` is the ``torch.autograd.Function`` around both: the
  forward keeps q, k, v, out and lse for the backward.
- :func:`reference_attention` is the decoder's ``"xla"`` path, with JAX's
  rounding: the score product runs in q's type and is then cast to f32, P is
  cast to q's type before the P.V product, masked scores are ``NEG``.

``launches`` counts the forward kernel's launches, ``bwd_dq_launches`` and
``bwd_dkv_launches`` the backward kernels'.
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
bwd_dq_launches = 0
bwd_dkv_launches = 0

_lib = None
_bwd_lib = None


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


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        lib = cuda_build.load("flash_attention_bwd")
        for fn, outs in ((lib.flash_attention_bwd_dq, 1),
                         (lib.flash_attention_bwd_dkv, 2)):
            fn.argtypes = ([ctypes.c_void_p] * (7 + outs) + [ctypes.c_int] * 7
                           + [ctypes.c_longlong] * 15
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


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


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, /, **rows) -> None:
    """What the kernels take: f32 or bf16 throughout, one device, head_dim a
    multiple of 8 up to 256, T >= 1, at most 2**31 - 1 blocks of 32 rows,
    and every row tensor (``rows``: name -> tensor) with a unit last stride
    and 16-byte aligned rows. Raises ``TypeError``/``ValueError``."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes f32 or bf16, not {q.dtype}")
    if any(t.dtype != q.dtype for t in rows.values()):
        raise TypeError(f"flash_attention: {', '.join(rows)} must share one dtype")
    if any(t.device != q.device for t in rows.values()):
        raise ValueError(f"flash_attention: {', '.join(rows)} must be on one device")
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} is not a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    if T < 1 or max(-(-T // 32) * H, -(-S // 32) * Hkv) * B >= 2 ** 31:
        raise ValueError("flash_attention: needs T >= 1 and at most 2**31 - 1 "
                         "blocks of 32 rows")
    for name, t in rows.items():
        if not _rows_aligned(t):
            raise ValueError(f"flash_attention: {name} needs a unit last "
                             f"stride and 16-byte aligned rows")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Unit last stride, 16-byte aligned start and row strides: what the
    kernels' 16-byte row loads need."""
    vec = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3]))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    _check(q, k, v)
    _check_kernel_inputs(q, k, q=q, k=k, v=v)
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
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


def _check_bwd(q, k, v, out, lse, do) -> None:
    _check(q, k, v)
    B, T, H, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: out and the gradient must be "
                         "shaped as q [B, T, H, D]")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: lse must be [B, H, T] f32")


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The backward kernels' arithmetic, written plainly with the scores
    materialized: f32 scores ``s = (q . k) * scale`` with ``NEG`` above the
    end-aligned diagonal, ``p = exp(s - lse)``, ``dp = dO . v`` and
    ``delta = rowsum(dO * out)`` in f32, ``dS = p * (dp - delta) * scale``;
    ``dV = cast(p, dO's type)^T . dO``, ``dK = cast(dS, q's type)^T . Q``,
    ``dQ = cast(dS, k's type) . K``, every product accumulated in f32 and
    dK/dV summed over the ``rep`` query heads of each kv head. Returns
    ``(dq [B, T, H, D], dk, dv [B, S, Hkv, D])`` in the inputs' types."""
    _check_bwd(q, k, v, out, lse, do)
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    kf = _repeat_heads(k.float(), rep)
    vf = _repeat_heads(v.float(), rep)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    row = (S - T) + torch.arange(T, device=q.device)[:, None]
    col = torch.arange(S, device=q.device)[None, :]
    s = s.masked_fill(col > row, NEG)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    delta = torch.einsum("bthd,bthd->bht", dof, out.float())
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("bhts,bthd->bshd", p.to(do.dtype).float(), dof)
    dk = torch.einsum("bhts,bthd->bshd", ds.to(q.dtype).float(), qf)
    dq = torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).float(), kf)
    dk = dk.reshape(B, S, Hkv, rep, D).sum(dim=3)
    dv = dv.reshape(B, S, Hkv, rep, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _prepare_bwd(q, k, v, out, lse, do):
    """Checks what the backward kernels take; returns the gradient (a dense
    copy when its rows are not 16-byte aligned, e.g. the stride-0 gradient
    of a sum) and the lse made contiguous."""
    _check_bwd(q, k, v, out, lse, do)
    if do.dtype == q.dtype and not _rows_aligned(do):
        do = do.contiguous()
    _check_kernel_inputs(q, k, q=q, k=k, v=v, out=out, grad=do)
    if lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must be on q's device")
    return do, lse.contiguous()


def _bwd_args(q, k, v, out, do, lse, delta):
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (int(q.dtype == torch.bfloat16), B, T, S, H, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], *out.stride()[:3], 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    return head, tail


def launch_bwd_dq(q, k, v, out, do, lse, delta) -> torch.Tensor:
    """One launch of the dQ kernel on checked inputs (see
    :func:`flash_attention_bwd`): returns dq and writes
    ``delta = rowsum(dO * out)`` ``[B, H, T]`` f32 into ``delta``."""
    global bwd_dq_launches
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        head, tail = _bwd_args(q, k, v, out, do, lse, delta)
        rc = _bwd_library().flash_attention_bwd_dq(*head, dq.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"flash_attention dQ kernel launch failed: CUDA error {rc}")
    bwd_dq_launches += 1
    return dq


def launch_bwd_dkv(q, k, v, out, do, lse, delta
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the dK/dV kernel on checked inputs, reading the
    ``delta`` that :func:`launch_bwd_dq` wrote: returns ``(dk, dv)``."""
    global bwd_dkv_launches
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        head, tail = _bwd_args(q, k, v, out, do, lse, delta)
        rc = _bwd_library().flash_attention_bwd_dkv(*head, dk.data_ptr(),
                                                    dv.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"flash_attention dK/dV kernel launch failed: CUDA "
                           f"error {rc}")
    bwd_dkv_launches += 1
    return dk, dv


def _launch_bwd(q, k, v, out, lse, do):
    do, lse = _prepare_bwd(q, k, v, out, lse, do)
    B, T, H, _ = q.shape
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq = launch_bwd_dq(q, k, v, out, do, lse, delta)
    dk, dv = launch_bwd_dkv(q, k, v, out, do, lse, delta)
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal GQA attention backward: ``(dq [B, T, H, D], dk, dv
    [B, S, Hkv, D])`` in the inputs' types from q, k, v, the forward's
    ``out`` and ``lse [B, H, T]`` and the upstream gradient ``do`` (read
    through its strides). A CUDA tensor launches the dQ kernel (which also
    computes ``delta = rowsum(dO * out)``, the one ``[B, H, T]`` f32
    scratch) and then the dK/dV kernel; a CPU tensor runs
    :func:`flash_attention_bwd_reference`."""
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        return flash_attention_bwd(*ctx.saved_tensors, grad_out)


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
