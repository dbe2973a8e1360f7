"""The port's device JSON automaton (``lazzaro_tpu_torch.models.json_device``)
against the host automaton, mask by mask, mirroring
``tests/test_json_device.py``.

Random legal walks: at every step the host automaton (the JAX package's,
and the port's copy of it) enumerates the legal byte set; the device mask
must match it exactly. A random legal byte is fed to all of them, and the
walk repeats; done-ness must agree at every step.
"""

import json

import numpy as np
import pytest
import torch

from lazzaro_tpu.models import json_constrain as H
from lazzaro_tpu_torch.models import json_constrain as PH
from lazzaro_tpu_torch.models import json_device as D

EOS = 258
VOCAB = 259


def _device_mask(st):
    return D.allowed_mask(st, VOCAB, EOS).numpy()


def _host_mask(js):
    m = np.zeros((VOCAB,), bool)
    for b in js.allowed():
        m[b] = True
    if js.done:
        m[EOS] = True
    return m


def _feed(ds, b):
    return D.feed(ds, torch.tensor(b, dtype=torch.int32))


@pytest.mark.parametrize("force_object", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_walk_masks_match(force_object, seed):
    rng = np.random.default_rng(seed)
    js = H.JsonState(force_object=force_object)
    ps = PH.JsonState(force_object=force_object)
    ds = D.initial_state(force_object=force_object)
    doc = bytearray()
    for step in range(300):
        hm = _host_mask(js)
        assert (hm == _host_mask(ps)).all(), f"host copy differs at step {step}"
        dm = _device_mask(ds)
        if js.stack and len(js.stack) >= D.MAX_DEPTH:
            # device-only depth cap: open brackets masked off at the cap
            hm[ord("{")] = hm[ord("[")] = False
        assert (hm == dm).all(), (
            f"step {step} mode={js.mode} doc={bytes(doc)!r}: "
            f"host^device bytes {np.nonzero(hm != dm)[0]}")
        legal = np.nonzero(hm)[0]
        # bias away from whitespace/closers so documents grow structure
        weights = np.ones(len(legal))
        for i, b in enumerate(legal):
            if b < 256 and b in b" \t\n\r":
                weights[i] = 0.05
            elif b == EOS:
                weights[i] = 0.02
        b = int(rng.choice(legal, p=weights / weights.sum()))
        if b == EOS:
            break
        doc.append(b)
        js.feed(b)
        ps.feed(b)
        ds = _feed(ds, b)
        assert bool(js.done) == bool(D.is_done(ds)), (
            f"done divergence at step {step}, doc={bytes(doc)!r}")
    tail = js.closing_suffix()
    assert tail == ps.closing_suffix()
    json.loads((bytes(doc) + tail).decode("utf-8", errors="replace"))


def test_deep_nesting_hits_the_cap():
    """At MAX_DEPTH open containers the device masks '{' and '[' off."""
    js = H.JsonState()
    ds = D.initial_state()
    for _ in range(D.MAX_DEPTH):
        js.feed(ord("["))
        ds = _feed(ds, ord("["))
    dm = _device_mask(ds)
    hm = _host_mask(js)
    assert hm[ord("[")] and not dm[ord("[")] and not dm[ord("{")]
    hm[ord("{")] = hm[ord("[")] = False
    assert (hm == dm).all()
    for _ in range(D.MAX_DEPTH):
        js.feed(ord("]"))
        ds = _feed(ds, ord("]"))
    assert bool(D.is_done(ds)) and js.done


def test_scaffold_state_translation():
    scaffold = b'{"memories": [{"content": "abc'
    js = H.JsonState(force_object=True)
    for b in scaffold:
        js.feed(b)
    ds = D.encode_host_state(js)
    assert (_host_mask(js) == _device_mask(ds)).all()
    for b in b'", "type": "semantic"}]}':
        assert _device_mask(ds)[b], f"byte {bytes([b])!r} illegal on device"
        js.feed(b)
        ds = _feed(ds, b)
        assert (_host_mask(js) == _device_mask(ds)).all()
    assert bool(D.is_done(ds))


def test_literal_and_number_states_translate():
    for prefix in (b"[tr", b"[fal", b"{\"a\": nu", b"[-1.5e", b"[12", b"0"):
        js = H.JsonState()
        for b in prefix:
            js.feed(b)
        ds = D.encode_host_state(js)
        assert (_host_mask(js) == _device_mask(ds)).all(), prefix


def test_eos_is_legal_only_when_done():
    ds = D.initial_state(force_object=True)
    assert not _device_mask(ds)[EOS]
    for b in b"{}":
        ds = _feed(ds, b)
    assert _device_mask(ds)[EOS]
    assert D.allowed_mask(ds, 512, EOS).shape == (512,)
