"""The port's decoder LM (``lazzaro_tpu_torch.models.llm``) against the JAX
package's, from the same flax weights carried across by ``params_from_jax``,
on the CPU in f32 at ``LMConfig.tiny()``.

Tolerances: logits within 1e-4 (the two frameworks sum the same f32
products in other orders); greedy ids, texts and constrained JSON documents
identical.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lazzaro_tpu.models.llm import Decoder as JaxDecoder
from lazzaro_tpu.models.llm import LanguageModel as JaxLM
from lazzaro_tpu.models.llm import LMConfig as JaxConfig
from lazzaro_tpu_torch.models.llm import (Decoder, LanguageModel, LMConfig,
                                          params_from_jax)
from lazzaro_tpu_torch.ops import flash_attention as fa

LOGIT_TOL = 1e-4


def _port_of(jlm, cfg):
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    return LanguageModel(cfg, device="cpu", decoder=params_from_jax(tree, cfg))


@pytest.fixture(scope="module")
def pair():
    jlm = JaxLM(JaxConfig.tiny(), seed=0)
    return jlm, _port_of(jlm, LMConfig.tiny())


def _tokens(B=2, T=24, seed=0):
    toks = np.random.RandomState(seed).randint(0, 250, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy()
    return toks, pos


def _logits_both(jparams, dec, jcfg, impl, toks, pos):
    want, _ = JaxDecoder(dataclasses.replace(jcfg, attn_impl=impl)).apply(
        {"params": jparams}, jnp.asarray(toks), jnp.asarray(pos))
    with torch.no_grad():
        got, _ = dec(torch.from_numpy(toks).long(), torch.from_numpy(pos),
                     attn_impl=impl)
    return np.asarray(want), got.numpy()


def test_config_presets_match_jax():
    for name in ("tiny", "small", "base2b"):
        assert (dataclasses.asdict(getattr(LMConfig, name)())
                == dataclasses.asdict(getattr(JaxConfig, name)()))
    assert dataclasses.asdict(LMConfig()) == dataclasses.asdict(JaxConfig())


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_decoder_logits_match_jax(pair, impl):
    jlm, lm = pair
    want, got = _logits_both(jlm.params, lm.model, JaxConfig.tiny(), impl,
                             *_tokens())
    assert got.shape == (2, 24, 512) and got.dtype == np.float32
    assert np.abs(want - got).max() < LOGIT_TOL


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_gemma2_variant_logits_match_jax(impl):
    """Softcaps, a sliding window shorter than the sequence, a query scale
    and sandwich norms: every layer takes the materialized-scores path."""
    g2 = dict(attn_softcap=5.0, final_softcap=3.0, sliding_window=6,
              query_scale=0.3, post_norms=True)
    jcfg = dataclasses.replace(JaxConfig.tiny(), **g2)
    toks, pos = _tokens(seed=1)
    jparams = JaxDecoder(jcfg).init(jax.random.PRNGKey(1), jnp.asarray(toks),
                                    jnp.asarray(pos))["params"]
    dec = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                          dataclasses.replace(LMConfig.tiny(), **g2))
    before = fa.launches
    want, got = _logits_both(jparams, dec, jcfg, impl, toks, pos)
    assert np.abs(want - got).max() < LOGIT_TOL
    assert fa.launches == before


def test_prefill_and_decode_match_full_forward(pair):
    _, lm = pair
    ids = lm.tokenizer.encode("memory systems")
    tokens = torch.tensor([ids])
    pos = torch.arange(len(ids))[None]
    with torch.no_grad():
        full, _ = lm.model(tokens, pos)
        pre, caches = lm._prefill(tokens, pos, lm._empty_cache(1))
        assert float((full[:, -1] - pre).abs().max()) < LOGIT_TOL
        nxt = torch.argmax(pre, dim=-1)
        step, _ = lm._decode_one(nxt, torch.tensor([len(ids)]), caches)
        full2, _ = lm.model(torch.cat([tokens, nxt[:, None]], 1),
                            torch.arange(len(ids) + 1)[None])
    assert float((full2[:, -1] - step).abs().max()) < LOGIT_TOL


def test_logits_for_matches_jax(pair):
    jlm, lm = pair
    text = "The user works as a data engineer."
    assert np.abs(jlm.logits_for(text) - lm.logits_for(text)).max() < LOGIT_TOL
    assert np.abs(lm.logits_for(text, attn_impl="flash")
                  - lm.logits_for(text)).max() < LOGIT_TOL


@pytest.mark.parametrize("prompt", ["hello", "Extract the facts: I like tea."])
def test_greedy_generate_matches_jax(pair, prompt):
    jlm, lm = pair
    want = list(jlm._token_stream(prompt, 24, 0.0, 0))
    got = list(lm._token_stream(prompt, 24, 0.0, 0))
    assert got == want
    assert lm.generate(prompt, max_new_tokens=24) == jlm.generate(
        prompt, max_new_tokens=24)


def test_generate_stream_concatenates_to_generate(pair):
    _, lm = pair
    for seed, temp in ((0, 0.0), (1, 0.0), (5, 0.9)):
        full = lm.generate("stream parity", max_new_tokens=24,
                           temperature=temp, seed=seed)
        pieces = list(lm.generate_stream("stream parity", max_new_tokens=24,
                                         temperature=temp, seed=seed))
        assert "".join(pieces) == full


@pytest.mark.parametrize("device_loop", [True, False])
@pytest.mark.parametrize("scaffold", [None, '{"memories": [{"content": "'])
def test_generate_json_matches_jax(pair, device_loop, scaffold):
    jlm, lm = pair
    kw = dict(max_new_tokens=48, scaffold=scaffold)
    want = jlm.generate_json("Extract facts.", **kw)
    got = lm.generate_json("Extract facts.", device_loop=device_loop, **kw)
    assert got == want
    json.loads(got)
    if scaffold:
        assert got.startswith(scaffold)


def test_generate_json_free_values_match_jax():
    """force_object=False: top-level values of every kind, on both loops."""
    for seed in range(3):
        jlm = JaxLM(JaxConfig.tiny(), seed=seed)
        lm = _port_of(jlm, LMConfig.tiny())
        want = jlm.generate_json("v:", max_new_tokens=24, force_object=False)
        for device_loop in (True, False):
            assert lm.generate_json("v:", max_new_tokens=24, force_object=False,
                                    device_loop=device_loop) == want


def test_generate_json_sampled_is_valid_json(pair):
    _, lm = pair
    for seed in range(3):
        for device_loop in (True, False):
            json.loads(lm.generate_json("Extract.", max_new_tokens=40,
                                        temperature=0.9, seed=seed,
                                        device_loop=device_loop))


def test_device_loop_reads_back_one_flag_per_step(pair):
    _, lm = pair
    before = lm.readbacks
    doc = lm.generate_json("Extract facts.", max_new_tokens=16)
    steps = lm.readbacks - before - 1               # the ids: one more copy
    assert 1 <= steps <= 16
    assert len(doc.encode()) >= steps


def test_eos_id_zero_respected():
    class EosZeroTok:
        EOS = 0

        def encode(self, text, add_bos=True, add_eos=False):
            return [5, 6]

        def decode(self, ids):
            return "".join(chr(65 + i % 26) for i in ids)

    lm = LanguageModel(LMConfig.tiny(), device="cpu", tokenizer=EosZeroTok())
    assert lm.eos_id == 0


def test_auto_attention_resolves_by_device():
    assert LanguageModel(LMConfig.tiny(), device="cpu").cfg.attn_impl == "xla"
    flash = dataclasses.replace(LMConfig.tiny(), attn_impl="flash")
    assert LanguageModel(flash, device="cpu").cfg.attn_impl == "flash"
    with pytest.raises(ValueError):
        LanguageModel(dataclasses.replace(LMConfig.tiny(), attn_impl="ring"),
                      device="cpu")


def test_language_model_needs_a_gpu(monkeypatch):
    from lazzaro_tpu_torch.core.providers import OnDeviceLLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LanguageModel()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnDeviceLLM()


def test_params_from_jax_checks_shapes(pair):
    jlm, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, dataclasses.replace(LMConfig.tiny(), mlp_dim=64))
    with pytest.raises(ValueError, match="another LMConfig"):
        LanguageModel(dataclasses.replace(LMConfig.tiny(), layers=3),
                      device="cpu", decoder=params_from_jax(tree, LMConfig.tiny()))


def test_random_init_follows_flax_distributions():
    """Seeded weights: embedding std 0.02, lecun-normal kernels truncated at
    two standard deviations, unit norm scales; one seed, one model."""
    cfg = dataclasses.replace(LMConfig.tiny(), hidden=128, mlp_dim=512)
    a = Decoder(cfg).init_weights(3)
    b = Decoder(cfg).init_weights(3)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    sd = a.state_dict()                                   # detached
    assert abs(float(sd["embed"].std()) - 0.02) < 2e-3
    w = sd["blocks.0.mlp.gate"]
    std = (1 / 128) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6
    assert abs(float(w.std()) - (1 / 128) ** 0.5) < 0.05 * (1 / 128) ** 0.5
    o = sd["blocks.0.attn.o"]                             # fan-in H * D = 64
    assert float(o.abs().max()) <= 2 * (1 / 64) ** 0.5 / 0.87962566103423978 + 1e-6
    assert float(sd["ln_f.scale"].min()) == 1.0 == float(sd["blocks.1.ln2.scale"].max())
