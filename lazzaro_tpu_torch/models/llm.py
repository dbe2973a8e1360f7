"""The in-tree decoder LM (Gemma-class), a port of
``lazzaro_tpu/models/llm.py``: RoPE, grouped-query attention, RMSNorm,
GeGLU, tied embeddings, the byte tokenizer, KV-cache greedy/temperature
decoding and grammar-constrained JSON generation.

Numerics follow the flax modules: f32 master weights with the matmuls in
the config's compute dtype (as ``DenseGeneral(dtype=...)`` casts its
kernel), RMSNorm in f32 with an f32 scale, the residual stream in f32 (the
JAX embedding scale ``np.sqrt(hidden)`` promotes it), tied logits in f32.

Attention has the JAX module's three branches: cache-less with
``attn_impl="flash"`` through ``ops.flash_attention`` (the hand-written
Hopper kernel on a CUDA tensor), the KV cache (prefill and decode; the
cache is updated in place), and the plain causal path with Gemma-2's
sliding window, softcap and query scale (``"xla"``: materialized scores).
Layers with softcap, a sliding window or a query scale take the plain path,
as in JAX. ``"auto"`` resolves to ``"flash"`` on a CUDA device and to
``"xla"`` on the CPU.

Training: :func:`make_train_step` is the next-token cross-entropy step of
``_make_ce_train_step`` on a ``torch.optim`` optimizer; through flash its
backward runs the hand-written dQ and dK/dV kernels.

Not ported yet (ROADMAP Queue 1 items 20-21): ``make_seq_parallel_train_step``
and ``param_specs``/``shard_params`` (multi-device), ``from_hf``/
``gemma_params_from_hf``/``HFLMTokenizerAdapter``, ``save_params``/
``load_params`` and the encoder.
"""

from __future__ import annotations

import codecs
import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lazzaro_tpu_torch.models import json_device as JD
from lazzaro_tpu_torch.models.json_constrain import JsonState, constrain_mask
from lazzaro_tpu_torch.models.tokenizer import ByteTokenizer
from lazzaro_tpu_torch.ops.flash_attention import (flash_attention,
                                                   reference_attention)
from lazzaro_tpu_torch.utils.device import resolve_device

_IMPLS = ("xla", "flash", "auto")


@dataclass(frozen=True)
class LMConfig:
    # Byte tokenizer needs 259 ids; padded to 512 as in the JAX package.
    vocab_size: int = 512
    hidden: int = 2048
    layers: int = 18
    heads: int = 8
    kv_heads: int = 2
    head_dim: int = 256
    mlp_dim: int = 8192
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    # Cache-less attention: "xla" = materialized scores, "flash" = the
    # flash-attention kernel, "auto" = flash on a CUDA device, xla on the
    # CPU. The KV-cache path (generate) always uses materialized scores.
    attn_impl: str = "auto"
    # --- Gemma-2 family features (all off by default = Gemma-1 numerics) ---
    attn_softcap: float = 0.0     # cap·tanh(scores/cap) on attention logits
    final_softcap: float = 0.0    # cap·tanh(logits/cap) on the LM head
    sliding_window: int = 0       # >0: EVEN layers attend locally (HF layout)
    query_scale: float = 0.0      # 0 → 1/sqrt(head_dim)
    post_norms: bool = False      # pre+post RMSNorm around attn AND mlp

    @staticmethod
    def tiny() -> "LMConfig":
        return LMConfig(hidden=64, layers=2, heads=4, kv_heads=2, head_dim=16,
                        mlp_dim=128, max_seq=128, dtype="float32")

    @staticmethod
    def small() -> "LMConfig":
        return LMConfig(hidden=512, layers=6, heads=8, kv_heads=2, head_dim=64,
                        mlp_dim=2048, max_seq=1024)

    @staticmethod
    def base2b() -> "LMConfig":
        """Gemma-2-2B geometry and numerics (byte vocab): softcapping,
        pre+post norms, alternating local/global attention."""
        return LMConfig(hidden=2304, layers=26, heads=8, kv_heads=4,
                        head_dim=256, mlp_dim=9216, max_seq=4096,
                        attn_softcap=50.0, final_softcap=30.0,
                        sliding_window=4096, post_norms=True)


def compute_dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _weight(module: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Parameter ``name`` of ``module`` in ``dtype``: the f32 master itself;
    under autograd a differentiable cast of it (as flax's ``DenseGeneral``
    casts its kernel inside the differentiated function), so the gradient
    reaches the master; otherwise a cached copy rebuilt whenever the master
    changes (load, move, an optimizer's in-place step)."""
    p = getattr(module, name)
    if p.dtype == dtype:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    key = (p.data_ptr(), p._version, p.device, dtype)
    cache = module.__dict__.setdefault("_compute_copies", {})
    got = cache.get(name)
    if got is None or got[0] != key:
        got = (key, p.detach().to(dtype))
        cache[name] = got
    return got[1]


def _dense(x: torch.Tensor, module: nn.Module, name: str,
           dtype: torch.dtype, in_dims: int = 1) -> torch.Tensor:
    """flax ``DenseGeneral`` over the last ``in_dims`` axes of ``x``: both
    operands cast to ``dtype``, the kernel's output axes kept."""
    w = _weight(module, name, dtype)
    k_in = int(np.prod(w.shape[:in_dims]))
    lead = x.shape[:x.ndim - in_dims]
    y = torch.matmul(x.to(dtype).reshape(*lead, k_in), w.reshape(k_in, -1))
    return y.reshape(*lead, *w.shape[in_dims:])


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T]. Split in halves, not interleaved."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device),
                     exps)
    angles = positions[..., None].float() * freq             # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def resolve_impl(impl: str, device: torch.device) -> str:
    """``attn_impl`` with ``"auto"`` resolved: ``"flash"`` on a CUDA device,
    ``"xla"`` on the CPU."""
    if impl not in _IMPLS:
        raise ValueError(f"attn_impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "auto":
        return "flash" if device.type == "cuda" else "xla"
    return impl


def use_flash(cfg: LMConfig, impl: str, local: bool,
              device: torch.device) -> bool:
    """Whether a cache-less layer takes the flash kernel: ``impl`` resolves
    to "flash" and the layer has none of softcap, query scale or a sliding
    window, which the kernel does not compute."""
    return (resolve_impl(impl, device) == "flash" and cfg.attn_softcap == 0
            and cfg.query_scale == 0 and not local)


class Attention(nn.Module):
    def __init__(self, cfg: LMConfig, local: bool = False, device=None):
        super().__init__()
        self.cfg, self.local = cfg, local
        hid, H, Hkv, D = cfg.hidden, cfg.heads, cfg.kv_heads, cfg.head_dim
        # flax DenseGeneral kernel layouts: (hidden, heads, head_dim) for
        # q/k/v, (heads, head_dim, hidden) for o.
        self.q = nn.Parameter(torch.empty(hid, H, D, device=device))
        self.k = nn.Parameter(torch.empty(hid, Hkv, D, device=device))
        self.v = nn.Parameter(torch.empty(hid, Hkv, D, device=device))
        self.o = nn.Parameter(torch.empty(H, D, hid, device=device))

    def forward(self, x, positions, cache: Optional[Dict] = None,
                impl: str = "auto"):
        cfg = self.cfg
        dt = compute_dtype(cfg)
        B, T = x.shape[:2]
        q = rope(_dense(x, self, "q", dt), positions, cfg.rope_theta)
        k = rope(_dense(x, self, "k", dt), positions, cfg.rope_theta)
        v = _dense(x, self, "v", dt)
        if cache is None and use_flash(cfg, impl, self.local, x.device):
            out = flash_attention(q, k, v).to(dt)     # [B,T,H,D], GQA inside
        elif cache is not None:
            # Prefill/decode: write this call's K/V rows into the cache at
            # their positions (in place), then attend over the whole cache
            # with a causal-vs-position mask.
            pos = positions.long()
            batch_idx = torch.arange(B, device=x.device)[:, None]
            cache["k"][batch_idx, pos] = k.to(dt)
            cache["v"][batch_idx, pos] = v.to(dt)
            kv_pos = torch.arange(cache["k"].shape[1], device=x.device)
            kv_pos = kv_pos[None, None, :]                   # [1, 1, S]
            attn_mask = kv_pos <= pos[:, :, None]            # [B, T, S]
            if self.local:
                attn_mask &= kv_pos > pos[:, :, None] - cfg.sliding_window
            out = self._plain(q, cache["k"], cache["v"], attn_mask)
        else:
            causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                           device=x.device))
            if self.local:
                row = torch.arange(T, device=x.device)[:, None]
                col = torch.arange(T, device=x.device)[None, :]
                causal &= col > row - cfg.sliding_window
            out = self._plain(q, k, v, causal[None])
        return _dense(out, self, "o", dt, in_dims=2), cache

    def _plain(self, q, k_all, v_all, attn_mask):
        """Materialized-scores path: [B,T,H,D] × [B,S,Hkv,D] → [B,T,H,D]."""
        return reference_attention(q, k_all, v_all, attn_mask,
                                   scale=self.cfg.query_scale,
                                   softcap=self.cfg.attn_softcap)


class MLP(nn.Module):
    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.gate = nn.Parameter(torch.empty(cfg.hidden, cfg.mlp_dim, device=device))
        self.up = nn.Parameter(torch.empty(cfg.hidden, cfg.mlp_dim, device=device))
        self.down = nn.Parameter(torch.empty(cfg.mlp_dim, cfg.hidden, device=device))

    def forward(self, x):
        dt = compute_dtype(self.cfg)
        # flax nn.gelu is the tanh approximation
        h = F.gelu(_dense(x, self, "gate", dt), approximate="tanh")
        return _dense(h * _dense(x, self, "up", dt), self, "down", dt)


class Block(nn.Module):
    def __init__(self, cfg: LMConfig, local: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.hidden, device=device)
        self.attn = Attention(cfg, local=local, device=device)
        self.ln2 = RMSNorm(cfg.hidden, device=device)
        self.mlp = MLP(cfg, device=device)
        if cfg.post_norms:
            # Gemma-2 sandwich norms around each sublayer's output.
            self.post_attn = RMSNorm(cfg.hidden, device=device)
            self.post_ffw = RMSNorm(cfg.hidden, device=device)

    def forward(self, x, positions, cache=None, impl: str = "auto"):
        h, new_cache = self.attn(self.ln1(x), positions, cache, impl)
        if self.cfg.post_norms:
            x = x + self.post_attn(h)
            x = x + self.post_ffw(self.mlp(self.ln2(x)))
        else:
            x = x + h
            x = x + self.mlp(self.ln2(x))
        return x, new_cache


class Decoder(nn.Module):
    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden,
                                              device=device))
        # Gemma-2 alternation: EVEN layers slide, odd attend globally.
        self.blocks = nn.ModuleList(
            Block(cfg, local=cfg.sliding_window > 0 and i % 2 == 0,
                  device=device) for i in range(cfg.layers))
        self.ln_f = RMSNorm(cfg.hidden, device=device)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Decoder":
        """Random weights from ``seed`` with flax's initializers: embedding
        normal(0.02), dense kernels lecun-normal (truncated at two standard
        deviations, fan-in over the input axes), norm scales 1."""
        gen = torch.Generator(device=self.embed.device).manual_seed(seed)
        self.embed.normal_(0.0, 0.02, generator=gen)
        for block in self.blocks:
            for module, name, in_dims in (
                    (block.attn, "q", 1), (block.attn, "k", 1),
                    (block.attn, "v", 1), (block.attn, "o", 2),
                    (block.mlp, "gate", 1), (block.mlp, "up", 1),
                    (block.mlp, "down", 1)):
                p = getattr(module, name)
                fan_in = int(np.prod(p.shape[:in_dims]))
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
        for m in self.modules():
            if isinstance(m, RMSNorm):
                m.scale.fill_(1.0)
        return self

    def forward(self, tokens, positions, caches=None,
                attn_impl: Optional[str] = None):
        """tokens [B, T] → (logits [B, T, vocab] f32, caches); ``caches``
        are per-layer KV dicts, updated in place. ``attn_impl`` overrides
        ``cfg.attn_impl`` for this call."""
        cfg = self.cfg
        impl = attn_impl or cfg.attn_impl
        x = self.embed[tokens].to(compute_dtype(cfg)).float() * math.sqrt(cfg.hidden)
        for i, block in enumerate(self.blocks):
            x, _ = block(x, positions, caches[i] if caches is not None else None,
                         impl)
        x = self.ln_f(x)
        logits = x.float() @ self.embed.float().t()
        if cfg.final_softcap > 0:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        return logits, caches


def params_from_jax(tree, cfg: LMConfig) -> Decoder:
    """A CPU ``Decoder`` holding the flax params ``tree`` (nested dicts of
    numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)``):
    q/k/v kernels (hidden, heads, head_dim), o (heads, head_dim, hidden),
    Dense kernels [in, out], norm scales, the tied embedding."""
    dec = Decoder(cfg)
    names = {"embed": ("embed",), "ln_f.scale": ("ln_f", "scale")}
    for i, block in enumerate(dec.blocks):
        pre = f"block_{i}"
        for n in ("ln1", "ln2") + (("post_attn", "post_ffw")
                                   if cfg.post_norms else ()):
            names[f"blocks.{i}.{n}.scale"] = (pre, n, "scale")
        for n in ("q", "k", "v", "o"):
            names[f"blocks.{i}.attn.{n}"] = (pre, "attn", n, "kernel")
        for n in ("gate", "up", "down"):
            names[f"blocks.{i}.mlp.{n}"] = (pre, "mlp", n, "kernel")
    state = dec.state_dict()
    if set(names) != set(state):
        raise AssertionError("params_from_jax: parameter names out of step")
    for name, path in names.items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        arr = np.asarray(leaf, np.float32)
        if tuple(arr.shape) != tuple(state[name].shape):
            raise ValueError(f"params_from_jax: {'/'.join(path)} has shape "
                             f"{arr.shape}, the config needs "
                             f"{tuple(state[name].shape)}")
        state[name] = torch.from_numpy(arr.copy())
    dec.load_state_dict(state)
    return dec


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def next_token_loss(decoder: Decoder, tokens: torch.Tensor, mask: torch.Tensor,
                    attn_impl: str) -> torch.Tensor:
    """Mean next-token cross-entropy of ``decoder`` on ``tokens [B, T]``:
    positions ``arange(T)``, f32 logits, ``log_softmax``, the NLL of
    ``tokens[:, 1:]`` weighted by ``mask[:, 1:]`` and divided by
    ``max(mask[:, 1:].sum(), 1)`` (JAX ``_make_ce_train_step``'s
    ``loss_fn``)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    logits, _ = decoder(tokens, positions, attn_impl=attn_impl)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    weights = mask[:, 1:].float()
    return (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def make_train_step(cfg: LMConfig, optimizer: torch.optim.Optimizer,
                    mesh=None):
    """Next-token cross-entropy train step (JAX ``make_train_step``).

    Returns ``train_step(decoder, tokens, mask) -> loss``: ``decoder`` is a
    :class:`Decoder` built for ``cfg`` whose parameters ``optimizer`` holds,
    ``tokens`` ``[B, T]`` ids and ``mask`` ``[B, T]`` (1 where a token
    counts) on the decoder's device. It computes :func:`next_token_loss`,
    runs the backward, ``optimizer.step()`` and
    ``optimizer.zero_grad(set_to_none=True)``, and returns the loss before
    the update as a 0-d f32 tensor on the device (no host sync). The
    parameters change in place. ``cfg.attn_impl`` resolves as JAX's
    ``_resolve_attn_impl`` does: ``"auto"`` is flash on a CUDA device, whose
    backward launches the dQ and dK/dV kernels, and xla on the CPU.

    optax optimizers map to torch as: ``optax.sgd(lr)`` is ``SGD(params,
    lr)``; ``optax.adam(lr)`` is ``Adam(params, lr, eps=1e-8)``;
    ``optax.adamw(lr)`` is ``AdamW(params, lr, betas=(0.9, 0.999), eps=1e-8,
    weight_decay=1e-4)`` (torch's AdamW defaults to ``weight_decay=0.01``,
    optax's to 1e-4). A ``mesh`` (data/tensor parallelism) is not ported yet
    and raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step over a mesh is not ported yet (ROADMAP Queue 1 "
            "item 21, multi-device)")

    def train_step(decoder: Decoder, tokens: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
        if dataclasses.replace(decoder.cfg, attn_impl=cfg.attn_impl) != cfg:
            raise ValueError("decoder was built for another LMConfig")
        impl = resolve_impl(cfg.attn_impl, decoder.embed.device)
        with torch.enable_grad():
            loss = next_token_loss(decoder, tokens, mask, impl)
            loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step


def make_seq_parallel_train_step(cfg: LMConfig, optimizer, mesh,
                                 seq_axis: str = "sp",
                                 dp_axis: Optional[str] = "data"):
    """The long-context train step over a ``(data, sp)`` mesh (ring
    attention) is multi-device and not ported yet."""
    raise NotImplementedError(
        "make_seq_parallel_train_step is not ported yet (ROADMAP Queue 1 "
        "item 21, multi-device)")


class LanguageModel:
    """Host wrapper of the decoder: weights, KV caches, sampling loops.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``device="cpu"`` for the plain versions. ``decoder`` installs given
    weights (e.g. from :func:`params_from_jax`); otherwise they are drawn
    from ``seed``. ``readbacks`` counts the device-to-host copies of the
    on-device JSON loop."""

    def __init__(self, cfg: Optional[LMConfig] = None, seed: int = 0,
                 device=None, tokenizer=None,
                 decoder: Optional[Decoder] = None):
        self.device = resolve_device(device)
        cfg = cfg or LMConfig.small()
        cfg = dataclasses.replace(
            cfg, attn_impl=resolve_impl(cfg.attn_impl, self.device))
        self.cfg = cfg
        self.tokenizer = tokenizer if tokenizer is not None else ByteTokenizer()
        eos = getattr(self.tokenizer, "EOS", None)      # explicit None checks:
        if eos is None:                                 # an EOS of id 0 is valid
            eos = getattr(self.tokenizer, "eos_id", None)
        self.eos_id = int(eos) if eos is not None else ByteTokenizer.EOS
        if decoder is None:
            decoder = Decoder(cfg, device=self.device).init_weights(seed)
        elif dataclasses.replace(decoder.cfg, attn_impl=cfg.attn_impl) != cfg:
            raise ValueError("decoder was built for another LMConfig")
        self.model = decoder.to(self.device)
        self.readbacks = 0

    # -- inference ----------------------------------------------------------
    def _forward(self, tokens, positions, caches=None, attn_impl=None):
        return self.model(tokens, positions, caches,
                          attn_impl=attn_impl or self.cfg.attn_impl)

    def _empty_cache(self, batch: int) -> List[Dict[str, torch.Tensor]]:
        cfg = self.cfg
        shape = (batch, cfg.max_seq, cfg.kv_heads, cfg.head_dim)
        dt = compute_dtype(cfg)
        return [{"k": torch.zeros(shape, dtype=dt, device=self.device),
                 "v": torch.zeros(shape, dtype=dt, device=self.device)}
                for _ in range(cfg.layers)]

    def _prefill(self, tokens, positions, caches):
        logits, caches = self._forward(tokens, positions, caches)
        return logits[:, -1], caches

    def _decode_one(self, token, position, caches):
        logits, caches = self._forward(token[:, None], position[:, None], caches)
        return logits[:, -1], caches

    def _readback(self, t: torch.Tensor):
        """The one way the JSON loop reads the device: a counted copy."""
        self.readbacks += 1
        return t.tolist()

    def _prep_prompt(self, prompt: str, max_new_tokens: int,
                     extra_ids: tuple = ()):
        """Shared generation preamble: clamp the budget, keep the prompt tail
        that fits, prefill the KV cache. ``extra_ids`` are teacher-forced
        tokens appended after the prompt (generate_json's scaffold), in the
        same prefill. Returns (clamped max_new_tokens, last-position logits,
        caches, pos)."""
        cfg = self.cfg
        max_new_tokens = min(max_new_tokens, cfg.max_seq - 2 - len(extra_ids))
        if max_new_tokens < 1:
            raise ValueError(
                f"{len(extra_ids)} forced prefix tokens leave no generation "
                f"budget in max_seq={cfg.max_seq}")
        prompt_budget = cfg.max_seq - 1 - max_new_tokens - len(extra_ids)
        ids = self.tokenizer.encode(prompt)
        if len(ids) > prompt_budget:
            ids = ids[len(ids) - prompt_budget:]
        ids = list(ids) + list(extra_ids)
        tokens = torch.tensor([ids], dtype=torch.long, device=self.device)
        positions = torch.arange(len(ids), device=self.device)[None, :]
        logits, caches = self._prefill(tokens, positions, self._empty_cache(1))
        return max_new_tokens, logits, caches, len(ids)

    def _sample(self, logits: torch.Tensor, temperature: float,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        """Greedy (temperature 0) or categorical over ``logits / T``, drawn
        by the Gumbel-max trick from ``gen``; ids on the device, no copy."""
        if temperature > 0:
            u = torch.rand(logits.shape, generator=gen, device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            return torch.argmax(logits / max(temperature, 1e-6) + gumbel, dim=-1)
        return torch.argmax(logits, dim=-1)

    def _generator(self, temperature: float, seed: int):
        if temperature <= 0:
            return None
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def _token_stream(self, prompt: str, max_new_tokens: int,
                      temperature: float, seed: int):
        """The ONE sampling loop: prefill, then sample → yield id → decode
        step, stopping on EOS or the context limit. Both generate() and
        generate_stream() consume this."""
        cfg = self.cfg
        max_new_tokens, logits, caches, pos = self._prep_prompt(
            prompt, max_new_tokens)
        gen = self._generator(temperature, seed)
        for _ in range(max_new_tokens):
            token = self._sample(logits.float(), temperature, gen)
            tid = int(token[0])
            if tid == self.eos_id or pos >= cfg.max_seq - 1:
                return
            yield tid
            position = torch.full((1,), pos, dtype=torch.long, device=self.device)
            logits, caches = self._decode_one(token, position, caches)
            pos += 1

    def generate(self, prompt: str, max_new_tokens: int = 64,
                 temperature: float = 0.0, seed: int = 0) -> str:
        ids = list(self._token_stream(prompt, max_new_tokens, temperature, seed))
        return self.tokenizer.decode(ids)

    def generate_stream(self, prompt: str, max_new_tokens: int = 64,
                        temperature: float = 0.0, seed: int = 0):
        """Incremental generation: yields text pieces as tokens decode; the
        concatenated pieces equal ``generate()``'s output exactly. Byte
        tokenizer: an incremental UTF-8 decoder (``errors="replace"``).
        Subword tokenizers: the growing prefix is re-decoded and the delta
        yielded."""
        stream = self._token_stream(prompt, max_new_tokens, temperature, seed)
        if isinstance(self.tokenizer, ByteTokenizer):
            decoder = codecs.getincrementaldecoder("utf-8")("replace")
            for tid in stream:
                if 0 <= tid < 256:
                    piece = decoder.decode(bytes([tid]))
                    if piece:
                        yield piece
            tail = decoder.decode(b"", final=True)
            if tail:
                yield tail
        else:
            ids: list = []
            prev = ""
            for tid in stream:
                ids.append(tid)
                text = self.tokenizer.decode(ids)
                if len(text) > len(prev) and text.startswith(prev):
                    yield text[len(prev):]
                    prev = text
            final = self.tokenizer.decode(ids) if ids else ""
            if len(final) > len(prev) and final.startswith(prev):
                yield final[len(prev):]

    @torch.no_grad()
    def generate_json(self, prompt: str, max_new_tokens: int = 256,
                      temperature: float = 0.0, seed: int = 0,
                      force_object: bool = True,
                      scaffold: Optional[str] = None,
                      device_loop: bool = True) -> str:
        """Grammar-constrained generation: valid JSON by construction (any
        weights). The byte-level automaton masks illegal logits to -inf
        before sampling; when the budget runs out the shortest closing
        suffix completes the document.

        ``scaffold``: a literal JSON prefix the output must start with,
        teacher-forced through the prefill and validated against the
        automaton. ``device_loop=True`` (default) keeps the automaton state,
        the sampled id and the output buffer on the device
        (``models/json_device.py``) and reads one ``done`` flag per step
        plus the ids once at the end; ``device_loop=False`` runs the
        automaton on the host per byte. Greedy outputs are identical."""
        if not isinstance(self.tokenizer, ByteTokenizer):
            raise ValueError(
                "generate_json requires the byte tokenizer (the JSON grammar "
                "automaton masks logits per BYTE; subword ids don't map 1:1)")
        cfg = self.cfg
        state = JsonState(force_object=force_object)
        out = bytearray()
        scaffold_ids: tuple = ()
        if scaffold:
            sbytes = scaffold.encode("utf-8")
            for i, b in enumerate(sbytes):
                mask = constrain_mask(state, cfg.vocab_size, ByteTokenizer.EOS)
                if not mask[b]:
                    raise ValueError(
                        f"scaffold is not a valid JSON prefix at byte {i} "
                        f"({bytes([b])!r} after {sbytes[:i]!r})")
                out.append(b)
                state.feed(b)
            scaffold_ids = tuple(int(b) for b in sbytes)
        max_new_tokens, logits, caches, pos = self._prep_prompt(
            prompt, max_new_tokens, extra_ids=scaffold_ids)

        if device_loop:
            dstate = JD.encode_host_state(state, device=self.device)
            ids = self._json_device_loop(logits, caches, pos, dstate,
                                         max_new_tokens, temperature,
                                         self._generator(temperature, seed))
            for tid in ids:
                if tid < 0:
                    break
                out.append(tid)
                state.feed(tid)          # host replay → closing_suffix state
        else:
            gen = (torch.Generator().manual_seed(seed) if temperature > 0
                   else None)                   # samples the host logits
            for _ in range(max_new_tokens):
                mask = constrain_mask(state, cfg.vocab_size, ByteTokenizer.EOS)
                host_logits = logits[0].float().cpu()
                host_logits[torch.from_numpy(~mask)] = float("-inf")
                tid = int(self._sample(host_logits[None], temperature, gen)[0])
                if tid == ByteTokenizer.EOS:
                    break
                out.append(tid)
                state.feed(tid)
                if state.mode == "done":
                    # Structurally complete; a top-level number is `done` but
                    # extendable ("4" → "42"), so it keeps decoding until the
                    # model itself picks EOS (legal once done).
                    break
                if pos >= cfg.max_seq - 1:
                    break
                token = torch.full((1,), tid, dtype=torch.long, device=self.device)
                position = torch.full((1,), pos, dtype=torch.long,
                                      device=self.device)
                logits, caches = self._decode_one(token, position, caches)
                pos += 1
        out += state.closing_suffix()
        return out.decode("utf-8", errors="replace")

    def _json_device_loop(self, logits, caches, pos: int, dstate,
                          max_new: int, temperature: float,
                          gen: Optional[torch.Generator]) -> list:
        """The constrained decode with its state on the device: sample under
        the automaton's mask, write the id into the output buffer, feed the
        automaton, and decode the next token unless the document is done.
        Reads back one ``done`` flag per step and the ids once at the end
        (the JAX ``lax.while_loop`` evaluates its ``cond`` on the device)."""
        vocab, eos = self.cfg.vocab_size, ByteTokenizer.EOS
        out_buf = torch.full((max_new,), -1, dtype=torch.int32, device=self.device)
        position = torch.full((1,), pos, dtype=torch.long, device=self.device)
        st = dstate
        for t in range(max_new):
            mask = JD.allowed_mask(st, vocab, eos)
            ml = logits[0].float().masked_fill(~mask, float("-inf"))
            tid = self._sample(ml, temperature, gen).to(torch.int32)
            is_eos = tid == eos
            out_buf[t] = torch.where(is_eos, torch.full_like(tid, -1), tid)
            fed = JD.feed(st, torch.clamp(tid, 0, 255))
            st = st.select(is_eos, fed)
            done = is_eos | (st.mode == JD.DONE)
            # skip the transformer step once the document is complete
            if self._readback(done):
                break
            logits, caches = self._decode_one(tid.reshape(1).long(), position,
                                              caches)
            position = position + 1
        return self._readback(out_buf)

    @torch.no_grad()
    def logits_for(self, text: str, attn_impl: Optional[str] = None) -> np.ndarray:
        """Full-sequence forward (no cache): [T, vocab] f32 logits.
        ``attn_impl`` overrides the model's for this call."""
        ids = self.tokenizer.encode(text)
        tokens = torch.tensor([ids], dtype=torch.long, device=self.device)
        positions = torch.arange(len(ids), device=self.device)[None, :]
        logits, _ = self._forward(tokens, positions, attn_impl=attn_impl)
        return logits[0].cpu().numpy()

