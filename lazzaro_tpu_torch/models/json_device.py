"""The JSON grammar automaton on device tensors, a port of
``lazzaro_tpu/models/json_device.py``.

``models/json_constrain.py`` runs the pushdown automaton on the host, which
needs the logits on the host at every byte. Here the same grammar is a few
scalar tensor ops: mode (an int over 32 states), container stack (a fixed
``[MAX_DEPTH]`` i32 column plus depth) and the string-is-key flag live on
the device, so ``LanguageModel.generate_json`` keeps the sampled id, the
automaton state and the output buffer there and reads the ids back once.

Exactness: byte for byte the host automaton's semantics (the tests replay
random legal documents through both and compare masks at every step), with
ONE deliberate restriction, as in the JAX package: container nesting is
capped at ``MAX_DEPTH`` (64); at the cap '{' and '[' are masked off.

No operation here reads a device value back to the host: table lookups go
through ``index_select``/``gather`` and writes through ``scatter``, never
through a Python index taken from a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lazzaro_tpu_torch.models import json_constrain as host_json

MAX_DEPTH = 64
N_MODES = 32

# Mode encoding, shared with the JAX package: names mirror
# json_constrain.JsonState.mode, with the force-object-before-first-byte case
# and each literal suffix given their own states so every mask is a pure
# function of the mode (plus the stack top / depth, handled dynamically).
(FVALUE, VALUE, VALUE_OR_CLOSE, OBJ_FIRST, OBJ_KEY, OBJ_COLON, OBJ_AFTER,
 ARR_AFTER, STRING, STR_ESC, STR_U4, STR_U3, STR_U2, STR_U1, NUM_SIGN,
 NUM_ZERO, NUM_INT, NUM_DOT, NUM_FRAC, NUM_E, NUM_ESIGN, NUM_EXP,
 LIT_RUE, LIT_UE, LIT_E, LIT_ALSE, LIT_LSE, LIT_SE, LIT_ULL, LIT_LL,
 LIT_L, DONE) = range(N_MODES)

_NUM_TERMINAL = (NUM_ZERO, NUM_INT, NUM_FRAC, NUM_EXP)
_STRING_MODES = (STRING, STR_ESC, STR_U4, STR_U3, STR_U2, STR_U1)

_HOST_MODE = {
    "value": VALUE, "value_or_close": VALUE_OR_CLOSE, "obj_first": OBJ_FIRST,
    "obj_key": OBJ_KEY, "obj_colon": OBJ_COLON, "obj_after": OBJ_AFTER,
    "arr_after": ARR_AFTER, "string": STRING, "string_escape": STR_ESC,
    "string_u4": STR_U4, "string_u3": STR_U3, "string_u2": STR_U2,
    "string_u1": STR_U1, "num_sign": NUM_SIGN, "num_zero": NUM_ZERO,
    "num_int": NUM_INT, "num_dot": NUM_DOT, "num_frac": NUM_FRAC,
    "num_e": NUM_E, "num_esign": NUM_ESIGN, "num_exp": NUM_EXP, "done": DONE,
}
_LIT_MODE = {b"rue": LIT_RUE, b"ue": LIT_UE, b"e": LIT_E, b"alse": LIT_ALSE,
             b"lse": LIT_LSE, b"se": LIT_SE, b"ull": LIT_ULL, b"ll": LIT_LL,
             b"l": LIT_L}


def _build_base_masks() -> np.ndarray:
    """Static per-mode legal-byte masks [N_MODES, 256]. Dynamic bits (number
    terminators, the depth cap on open brackets, EOS) are set or cleared at
    run time in :func:`allowed_mask`."""
    m = np.zeros((N_MODES, 256), bool)

    def setb(mode, byts):
        for b in byts:
            m[mode, b] = True

    ws = bytes(host_json.WS)
    digits = bytes(host_json.DIGITS)
    value_start = bytes(host_json.VALUE_START)
    setb(FVALUE, ws + b"{")
    setb(VALUE, ws + value_start)
    setb(VALUE_OR_CLOSE, ws + value_start + b"]")
    setb(OBJ_FIRST, ws + b'"}')
    setb(OBJ_KEY, ws + b'"')
    setb(OBJ_COLON, ws + b":")
    setb(OBJ_AFTER, ws + b",}")
    setb(ARR_AFTER, ws + b",]")
    setb(STRING, bytes(host_json.STRING_BODY) + b'"\\')
    setb(STR_ESC, bytes(host_json.ESCAPABLE))
    for mode in (STR_U4, STR_U3, STR_U2, STR_U1):
        setb(mode, bytes(host_json.HEX))
    setb(NUM_SIGN, digits)
    setb(NUM_ZERO, ws + b".eE")
    setb(NUM_INT, ws + digits + b".eE")
    setb(NUM_DOT, digits)
    setb(NUM_FRAC, ws + digits + b"eE")
    setb(NUM_E, digits + b"+-")
    setb(NUM_ESIGN, digits)
    setb(NUM_EXP, ws + digits)
    for mode, ch in ((LIT_RUE, b"r"), (LIT_UE, b"u"), (LIT_E, b"e"),
                     (LIT_ALSE, b"a"), (LIT_LSE, b"l"), (LIT_SE, b"s"),
                     (LIT_ULL, b"u"), (LIT_LL, b"l"), (LIT_L, b"l")):
        setb(mode, ch)
    setb(DONE, ws)
    return m


_BASE_MASKS = _build_base_masks()
_WS_MASK = np.zeros((256,), bool)
for _b in host_json.WS:
    _WS_MASK[_b] = True
_NUM_TERM_MASK = np.zeros((N_MODES,), bool)
_NUM_TERM_MASK[list(_NUM_TERMINAL)] = True
_STRING_MASK = np.zeros((N_MODES,), bool)
_STRING_MASK[list(_STRING_MODES)] = True

_HOST_TABLES = {"base": _BASE_MASKS, "ws": _WS_MASK,
                "num_term": _NUM_TERM_MASK, "string": _STRING_MASK}
_tables: dict = {}


def _upload_tables(device) -> None:
    """Put the constant tables on ``device`` once; the state constructors
    call this, so the decode loop itself never copies from the host."""
    device = torch.device(device)
    if (device, "base") not in _tables:
        for name, arr in _HOST_TABLES.items():
            _tables[(device, name)] = torch.from_numpy(arr).to(device)


def _table(name: str, device: torch.device) -> torch.Tensor:
    if (device, name) not in _tables:
        _upload_tables(device)
    return _tables[(device, name)]


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a 0-d index tensor, with no host readback."""
    return table.index_select(0, idx.reshape(1).long()).squeeze(0)


@dataclass
class JsonDeviceState:
    mode: torch.Tensor      # i32 scalar
    depth: torch.Tensor     # i32 scalar
    stack: torch.Tensor     # [MAX_DEPTH] i32: 1 obj, 0 arr
    is_key: torch.Tensor    # bool scalar: the open string is an object key

    def select(self, keep_self: torch.Tensor,
               other: "JsonDeviceState") -> "JsonDeviceState":
        """Field by field ``keep_self ? self : other`` (``lax`` ``where``
        over the state tree)."""
        return JsonDeviceState(
            mode=torch.where(keep_self, self.mode, other.mode),
            depth=torch.where(keep_self, self.depth, other.depth),
            stack=torch.where(keep_self, self.stack, other.stack),
            is_key=torch.where(keep_self, self.is_key, other.is_key))


def initial_state(force_object: bool = False,
                  device="cpu") -> JsonDeviceState:
    _upload_tables(device)
    i32 = dict(dtype=torch.int32, device=device)
    return JsonDeviceState(
        mode=torch.tensor(FVALUE if force_object else VALUE, **i32),
        depth=torch.tensor(0, **i32),
        stack=torch.zeros((MAX_DEPTH,), **i32),
        is_key=torch.tensor(False, device=device))


def encode_host_state(st: host_json.JsonState,
                      device="cpu") -> JsonDeviceState:
    """Translate a host JsonState (e.g. after feeding a scaffold prefix)
    into the device encoding, so generation resumes mid-document."""
    _upload_tables(device)
    if st.mode == "literal":
        mode = _LIT_MODE[bytes(st._literal_rest)]
    elif st.mode == "value" and st.force_object and not st.started:
        mode = FVALUE
    else:
        mode = _HOST_MODE[st.mode]
    if len(st.stack) > MAX_DEPTH:
        raise ValueError(f"scaffold nests deeper than MAX_DEPTH={MAX_DEPTH}")
    stack = np.zeros((MAX_DEPTH,), np.int32)
    for i, f in enumerate(st.stack):
        stack[i] = 1 if f == "obj" else 0
    i32 = dict(dtype=torch.int32, device=device)
    return JsonDeviceState(
        mode=torch.tensor(mode, **i32), depth=torch.tensor(len(st.stack), **i32),
        stack=torch.from_numpy(stack).to(device),
        is_key=torch.tensor(bool(st._string_is_key), device=device))


def _top(stack: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """The stack's top frame (1 obj, 0 arr), or -1 at depth 0."""
    frame = _take(stack, torch.clamp(depth - 1, min=0))
    return torch.where(depth > 0, frame, torch.full_like(frame, -1))


def _is_num_terminal(mode: torch.Tensor) -> torch.Tensor:
    return _take(_table("num_term", mode.device), mode)


def is_done(st: JsonDeviceState) -> torch.Tensor:
    """Host ``JsonState.done``: DONE mode, or a top-level number terminal
    ("42" is a complete document)."""
    return (st.mode == DONE) | (_is_num_terminal(st.mode) & (st.depth == 0))


def allowed_mask(st: JsonDeviceState, vocab_size: int,
                 eos_id: int) -> torch.Tensor:
    """[vocab_size] bool: legal next token ids (bytes 0..255 + EOS)."""
    dev = st.mode.device
    base = _take(_table("base", dev), st.mode).clone()         # [256]
    top = _top(st.stack, st.depth)
    num_term = _is_num_terminal(st.mode)
    # number terminators depend on the enclosing container
    c, o, a = ord(","), ord("}"), ord("]")
    base[c] = base[c] | (num_term & (st.depth > 0))
    base[o] = base[o] | (num_term & (top == 1))
    base[a] = base[a] | (num_term & (top == 0))
    # depth cap: no new containers at MAX_DEPTH (device-only restriction)
    at_cap = st.depth >= MAX_DEPTH
    base[ord("{")] = base[ord("{")] & ~at_cap
    base[ord("[")] = base[ord("[")] & ~at_cap
    mask = torch.zeros((vocab_size,), dtype=torch.bool, device=dev)
    mask[:256] = base
    mask[eos_id] = is_done(st)
    return mask


def feed(st: JsonDeviceState, b: torch.Tensor) -> JsonDeviceState:
    """Advance the automaton by one legal byte ``b`` (a 0-d int tensor).
    Mirrors json_constrain.JsonState.feed byte for byte."""
    mode, depth, stack, is_key = st.mode, st.depth, st.stack, st.is_key
    where = torch.where
    dev = mode.device

    def const(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    top = _top(stack, depth)
    is_ws = _take(_table("ws", dev), b)
    num_term = _is_num_terminal(mode)

    def ctx_mode(d, t):
        # mode after completing a (non-key) value inside (d, top t)
        return where(d == 0, const(DONE),
                     where(t == 1, const(OBJ_AFTER), const(ARR_AFTER)))

    # ---- case A: a number terminates on ws / ',' / close -----------------
    a_close = num_term & ((b == ord("}")) | (b == ord("]")))
    a_comma = num_term & (b == ord(","))
    a_any = a_close | a_comma | (num_term & is_ws)
    a_depth = where(a_close, depth - 1, depth)
    a_top = _top(stack, a_depth)
    a_mode = where(a_comma, where(top == 1, const(OBJ_KEY), const(VALUE)),
                   ctx_mode(a_depth, a_top))

    # ---- case B: structural whitespace is a no-op ------------------------
    in_string = _take(_table("string", dev), mode)
    b_ws = is_ws & ~in_string & ~a_any

    # ---- case C: everything else, one branch per mode --------------------
    is_digit = (b >= ord("0")) & (b <= ord("9"))
    value_like = (mode == VALUE) | (mode == FVALUE) | (mode == VALUE_OR_CLOSE)

    def set_if(cond, to, cur):
        return where(cond, const(to), cur)

    # value starts
    push_obj = value_like & (b == ord("{"))
    push_arr = value_like & (b == ord("["))
    close_arr_now = (mode == VALUE_OR_CLOSE) & (b == ord("]"))
    c_mode = set_if(push_obj, OBJ_FIRST, mode)
    c_mode = set_if(push_arr, VALUE_OR_CLOSE, c_mode)
    c_mode = set_if(value_like & (b == ord('"')), STRING, c_mode)
    c_mode = set_if(value_like & (b == ord("-")), NUM_SIGN, c_mode)
    c_mode = set_if(value_like & (b == ord("0")), NUM_ZERO, c_mode)
    c_mode = set_if(value_like & is_digit & (b != ord("0")), NUM_INT, c_mode)
    c_mode = set_if(value_like & (b == ord("t")), LIT_RUE, c_mode)
    c_mode = set_if(value_like & (b == ord("f")), LIT_ALSE, c_mode)
    c_mode = set_if(value_like & (b == ord("n")), LIT_ULL, c_mode)

    # object / array punctuation
    key_start = ((mode == OBJ_FIRST) | (mode == OBJ_KEY)) & (b == ord('"'))
    c_mode = set_if(key_start, STRING, c_mode)
    c_mode = set_if((mode == OBJ_COLON) & (b == ord(":")), VALUE, c_mode)
    c_mode = set_if((mode == OBJ_AFTER) & (b == ord(",")), OBJ_KEY, c_mode)
    c_mode = set_if((mode == ARR_AFTER) & (b == ord(",")), VALUE, c_mode)

    # closers: pop, then complete into the surrounding context
    pop = (close_arr_now
           | ((mode == OBJ_FIRST) & (b == ord("}")))
           | ((mode == OBJ_AFTER) & (b == ord("}")))
           | ((mode == ARR_AFTER) & (b == ord("]"))))
    p_depth = depth - 1
    c_mode = where(pop, ctx_mode(p_depth, _top(stack, p_depth)), c_mode)

    # strings
    str_end = (mode == STRING) & (b == ord('"'))
    c_mode = where(str_end, where(is_key, const(OBJ_COLON),
                                  ctx_mode(depth, top)), c_mode)
    c_mode = set_if((mode == STRING) & (b == ord("\\")), STR_ESC, c_mode)
    c_mode = where(mode == STR_ESC,
                   where(b == ord("u"), const(STR_U4), const(STRING)), c_mode)
    c_mode = set_if(mode == STR_U4, STR_U3, c_mode)
    c_mode = set_if(mode == STR_U3, STR_U2, c_mode)
    c_mode = set_if(mode == STR_U2, STR_U1, c_mode)
    c_mode = set_if(mode == STR_U1, STRING, c_mode)

    # numbers (non-terminating bytes)
    c_mode = where(mode == NUM_SIGN,
                   where(b == ord("0"), const(NUM_ZERO), const(NUM_INT)), c_mode)
    in_int = (mode == NUM_ZERO) | (mode == NUM_INT)
    is_e = (b == ord("e")) | (b == ord("E"))
    c_mode = set_if(in_int & (b == ord(".")), NUM_DOT, c_mode)
    c_mode = set_if(in_int & is_e, NUM_E, c_mode)
    c_mode = set_if(mode == NUM_DOT, NUM_FRAC, c_mode)
    c_mode = set_if((mode == NUM_FRAC) & is_e, NUM_E, c_mode)
    c_mode = where(mode == NUM_E,
                   where((b == ord("+")) | (b == ord("-")), const(NUM_ESIGN),
                         const(NUM_EXP)), c_mode)
    c_mode = set_if(mode == NUM_ESIGN, NUM_EXP, c_mode)

    # literals: advance the chain; the last byte completes a value
    for frm, to in ((LIT_RUE, LIT_UE), (LIT_UE, LIT_E),
                    (LIT_ALSE, LIT_LSE), (LIT_LSE, LIT_SE), (LIT_SE, LIT_E),
                    (LIT_ULL, LIT_LL), (LIT_LL, LIT_L)):
        c_mode = set_if(mode == frm, to, c_mode)
    lit_done = (mode == LIT_E) | (mode == LIT_L)
    c_mode = where(lit_done, ctx_mode(depth, top), c_mode)

    # ---- merge the cases -------------------------------------------------
    new_mode = where(a_any, a_mode, where(b_ws, mode, c_mode))
    new_depth = where(a_any, a_depth,
                      where(b_ws, depth,
                            where(pop, p_depth,
                                  where(push_obj | push_arr, depth + 1,
                                        depth))))
    write_slot = torch.clamp(depth, max=MAX_DEPTH - 1).reshape(1).long()
    pushed = stack.scatter(0, write_slot, push_obj.to(torch.int32).reshape(1))
    new_stack = where(~a_any & ~b_ws & (push_obj | push_arr), pushed, stack)
    new_is_key = where(~a_any & ~b_ws,
                       where(key_start, torch.ones_like(is_key),
                             where(str_end, torch.zeros_like(is_key), is_key)),
                       is_key)
    return JsonDeviceState(mode=new_mode.to(torch.int32),
                           depth=new_depth.to(torch.int32),
                           stack=new_stack, is_key=new_is_key)
