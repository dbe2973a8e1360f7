"""The port's decoder train step (``lazzaro_tpu_torch.models.llm.
make_train_step``) against the JAX package's ``make_train_step``, from the
same flax weights carried across by ``params_from_jax``, on the CPU in f32
at ``LMConfig.tiny()``. Both run attention through flash: the JAX Pallas
kernels in interpret mode, the port's plain forward and backward.

Tolerances: loss within 1e-5 and updated parameters within 5e-5 (atol and
rtol), the JAX package's own for its flash step against its xla step
(``tests/test_flash_attention.py``); the two frameworks sum the same f32
products in other orders. Adam is the one exception, and only for a few
elements: its step is ``lr * g / (|g| + eps)``, so a gradient whose true
value is ~0 (here 1e-2 * 8192 gate entries carry ~7e-9, below ``eps`` =
1e-8) turns the frameworks' ~1e-9 of summation noise into a step
difference of up to ``lr * 1e-9 / eps`` = 1e-3. With Adam, at most 0.1% of
a tensor's elements may differ by more than 5e-5, and none by more than
1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lazzaro_tpu.models.llm import Decoder as JaxDecoder
from lazzaro_tpu.models.llm import LMConfig as JaxConfig
from lazzaro_tpu.models.llm import make_train_step as jax_make_train_step
from lazzaro_tpu_torch.models.llm import (Decoder, LanguageModel, LMConfig,
                                          make_seq_parallel_train_step,
                                          make_train_step, params_from_jax)
from lazzaro_tpu_torch.ops import flash_attention as fa

LOSS_TOL = 1e-5
PARAM_TOL = dict(atol=5e-5, rtol=5e-5)
ADAM_NOISE_SHARE, ADAM_NOISE_TOL = 1e-3, 1e-3
B, T = 2, 24


def _cfgs(impl="flash"):
    jcfg = dataclasses.replace(JaxConfig.tiny(), max_seq=32, attn_impl=impl)
    return jcfg, dataclasses.replace(LMConfig.tiny(), max_seq=32, attn_impl=impl)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    tok0 = jnp.zeros((1, 8), jnp.int32)
    return JaxDecoder(jcfg).init(jax.random.PRNGKey(0), tok0, tok0)["params"]


def _batch(seed=3, masked=False):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, 250, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    if masked:
        mask[0, 15:] = 0                  # a padded tail
        mask[1, :5] = 0                   # and a masked head
    return tokens, mask


def _port_decoder(jparams, cfg):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)


def _flat_jax(params, cfg):
    """The JAX params as the port's state-dict names → numpy."""
    dec = _port_decoder(params, cfg)
    return {n: t.numpy() for n, t in dec.state_dict().items()}


def _run_both(jparams, joptimizer, make_topt, steps, masked=False):
    jcfg, cfg = _cfgs()
    tokens, mask = _batch(masked=masked)
    jstep = jax_make_train_step(jcfg, joptimizer)
    p = jax.tree_util.tree_map(jnp.copy, jparams)
    state = joptimizer.init(p)
    jlosses = []
    for _ in range(steps):
        p, state, loss = jstep(p, state, jnp.asarray(tokens), jnp.asarray(mask))
        jlosses.append(float(loss))
    dec = _port_decoder(jparams, cfg)
    step = make_train_step(cfg, make_topt(dec.parameters()))
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    losses = [float(step(dec, torch.from_numpy(tokens).long(),
                         torch.from_numpy(mask))) for _ in range(steps)]
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == before   # CPU: plain
    return jlosses, _flat_jax(p, cfg), losses, dec


def _assert_same(jlosses, jflat, losses, dec, adam=False):
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_TOL, rtol=0)
    for name, t in dec.state_dict().items():
        got, want = t.numpy(), jflat[name]
        if not adam:
            np.testing.assert_allclose(got, want, err_msg=name, **PARAM_TOL)
            continue
        err = np.abs(got - want)
        over = err > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want)
        assert over.mean() <= ADAM_NOISE_SHARE, (name, int(over.sum()))
        assert err.max() <= ADAM_NOISE_TOL, (name, float(err.max()))


def test_sgd_step_matches_jax(jax_params):
    out = _run_both(jax_params, optax.sgd(1e-2),
                    lambda ps: torch.optim.SGD(ps, lr=1e-2), steps=1)
    _assert_same(*out)


def test_adamw_steps_match_jax_with_optax_defaults(jax_params):
    """Three ``optax.adamw(1e-2)`` steps against ``AdamW`` with optax's
    defaults (weight decay 1e-4, not torch's 0.01: that would shrink every
    parameter by ~1e-2 * lr * |p| more per step, 3e-4 over three steps on
    the norm scales of 1, and is caught here)."""
    out = _run_both(jax_params, optax.adamw(1e-2),
                    lambda ps: torch.optim.AdamW(ps, lr=1e-2, betas=(0.9, 0.999),
                                                 eps=1e-8, weight_decay=1e-4),
                    steps=3)
    _assert_same(*out, adam=True)
    assert out[2][-1] < out[2][0]


def test_masked_batch_matches_jax(jax_params):
    out = _run_both(jax_params, optax.sgd(1e-2),
                    lambda ps: torch.optim.SGD(ps, lr=1e-2), steps=1,
                    masked=True)
    _assert_same(*out)


def test_flash_step_equals_xla_step(jax_params):
    """The port's own two paths: the plain flash forward and backward
    against autograd through the materialized-scores attention."""
    tokens, mask = (torch.from_numpy(x).long() for x in _batch(seed=4))
    results = {}
    for impl in ("flash", "xla"):
        _, cfg = _cfgs(impl)
        dec = _port_decoder(jax_params, cfg)
        step = make_train_step(cfg, torch.optim.SGD(dec.parameters(), lr=1e-2))
        results[impl] = (float(step(dec, tokens, mask)), dec.state_dict())
    assert results["flash"][0] == pytest.approx(results["xla"][0], abs=LOSS_TOL)
    for name, t in results["flash"][1].items():
        np.testing.assert_allclose(t.numpy(), results["xla"][1][name].numpy(),
                                   err_msg=name, **PARAM_TOL)


def _grads(cfg, jax_params, tokens, mask):
    dec = _port_decoder(jax_params, cfg)
    seen = {}
    for name, p in dec.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, name=name: seen.__setitem__(name, p.grad.clone()))
    make_train_step(cfg, torch.optim.SGD(dec.parameters(), lr=0.0))(
        dec, tokens, mask)
    return seen, dec


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_bf16_step_reaches_every_master(jax_params, impl):
    """At the bf16 compute type every f32 master gets a gradient (the
    matmuls take a differentiable cast, not a detached cached copy), and
    it agrees with the f32 configuration's: cosine > 0.99 per tensor, the
    bf16 rounding of activations and weights being ~3e-3 relative."""
    tokens, mask = (torch.from_numpy(x).long() for x in _batch(seed=5))
    _, cfg32 = _cfgs(impl)
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    g16, dec = _grads(cfg16, jax_params, tokens, mask)
    g32, _ = _grads(cfg32, jax_params, tokens, mask)
    assert set(g16) == {n for n, _ in dec.named_parameters()}
    for name, g in g16.items():
        assert g.dtype == torch.float32 and bool((g != 0).any()), name
        cos = float(torch.nn.functional.cosine_similarity(
            g.flatten().double(), g32[name].flatten().double(), dim=0))
        assert cos > 0.99, (name, cos)


def test_logits_for_after_a_step_uses_fresh_weights(jax_params):
    """Inference keeps bf16 copies of the masters; an optimizer step
    changes the masters in place, and the next ``logits_for`` must serve
    the new weights, equal to a forward on freshly cast copies."""
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    lm = LanguageModel(cfg, device="cpu",
                       decoder=_port_decoder(jax_params, cfg))
    text = "the user keeps notes"
    before = lm.logits_for(text)
    tokens, mask = (torch.from_numpy(x).long() for x in _batch(seed=6))
    make_train_step(cfg, torch.optim.SGD(lm.model.parameters(), lr=0.1))(
        lm.model, tokens, mask)
    after = lm.logits_for(text)
    copy = Decoder(cfg)
    copy.load_state_dict(lm.model.state_dict())
    fresh = LanguageModel(cfg, device="cpu", decoder=copy)
    np.testing.assert_array_equal(after, fresh.logits_for(text))
    assert not np.array_equal(after, before)


def test_train_step_loss_falls_over_steps(jax_params):
    _, cfg = _cfgs()
    dec = _port_decoder(jax_params, cfg)
    step = make_train_step(cfg, torch.optim.AdamW(
        dec.parameters(), lr=1e-2, eps=1e-8, weight_decay=1e-4))
    tokens, mask = (torch.from_numpy(x).long() for x in _batch(seed=7))
    losses = [float(step(dec, tokens, mask)) for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_multi_device_steps_raise_naming_roadmap():
    _, cfg = _cfgs()
    dec = Decoder(cfg)
    opt = torch.optim.SGD(dec.parameters(), lr=1e-2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 21"):
        make_train_step(cfg, opt, mesh=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 21"):
        make_seq_parallel_train_step(cfg, opt, mesh=object())


def test_step_refuses_a_decoder_of_another_config(jax_params):
    _, cfg = _cfgs()
    step = make_train_step(cfg, torch.optim.SGD(Decoder(cfg).parameters(),
                                                lr=1e-2))
    other = Decoder(dataclasses.replace(cfg, layers=1)).init_weights(0)
    tokens, mask = (torch.from_numpy(x).long() for x in _batch())
    with pytest.raises(ValueError, match="another LMConfig"):
        step(other, tokens, mask)
