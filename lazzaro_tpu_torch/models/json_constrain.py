"""Byte-level constrained JSON decoding for the decoder LM: the host
pushdown automaton, a copy of ``lazzaro_tpu/models/json_constrain.py``.

With a byte tokenizer (one token = one byte) the automaton computes the set
of legal next *bytes* at every decode step, the sampler masks all other
logits, and the emitted document is valid JSON by construction, from any
weights, including random ones.

``JsonState`` is the incremental automaton (feed one byte, ask for the
allowed next-byte set); ``closing_suffix`` completes any partial document
when the token budget runs out, so ``generate_json`` can guarantee
parseability unconditionally. ``models/json_device.py`` is the same grammar
on device tensors.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

WS = frozenset(b" \t\n\r")
DIGITS = frozenset(b"0123456789")
ONENINE = frozenset(b"123456789")
HEX = frozenset(b"0123456789abcdefABCDEF")
ESCAPABLE = frozenset(b'"\\/bfnrtu')
VALUE_START = frozenset(b'{["-tfn') | DIGITS
# Inside a string: any byte except the control range, quote, backslash.
# Bytes >= 0x80 are allowed (UTF-8 continuation — the tokenizer decodes with
# errors="replace", and well-trained weights emit valid sequences).
STRING_BODY = frozenset(range(0x20, 0x100)) - frozenset(b'"\\')

_LITERALS = {ord("t"): b"rue", ord("f"): b"alse", ord("n"): b"ull"}


class JsonState:
    """Incremental JSON-prefix automaton.

    ``feed(byte)`` advances the state (byte MUST be in ``allowed()``);
    ``allowed()`` returns the legal next bytes; ``done`` is True once a
    complete top-level value has been consumed (only whitespace/EOS remain
    legal). ``force_object=True`` pins the top-level value to an object —
    the shape every extraction prompt in the reference asks for.
    """

    # modes: value | value_or_close | obj_first | obj_key | obj_colon
    #        | obj_after | arr_after | string | string_escape | string_u<k>
    #        | num_sign | num_zero | num_int | num_dot | num_frac
    #        | num_e | num_esign | num_exp | literal | done
    def __init__(self, force_object: bool = False):
        self.stack: List[str] = []          # 'obj' / 'arr' open containers
        self.mode = "value"
        self.force_object = force_object
        self.started = False
        self._literal_rest = b""
        self._string_is_key = False
        self._ahead: Optional[int] = None   # byte to re-process after a number ends

    _NUM_TERMINAL = ("num_zero", "num_int", "num_frac", "num_exp")

    # -- helpers ------------------------------------------------------------
    @property
    def done(self) -> bool:
        # A top-level number is complete at end-of-input even though no
        # terminator byte ever arrived ("42" is a full document).
        return (self.mode == "done"
                or (self.mode in self._NUM_TERMINAL and not self.stack))

    def _value_starts(self) -> frozenset:
        if self.force_object and not self.started:
            return frozenset(b"{")
        return VALUE_START

    def _terminators(self) -> frozenset:
        """Bytes that may legally follow a just-completed value."""
        if not self.stack:
            return frozenset()
        return frozenset(b",}") if self.stack[-1] == "obj" else frozenset(b",]")

    # -- the automaton ------------------------------------------------------
    def allowed(self) -> frozenset:
        m = self.mode
        if m == "value":
            return WS | self._value_starts()
        if m == "value_or_close":
            return WS | VALUE_START | frozenset(b"]")
        if m == "obj_first":
            return WS | frozenset(b'"}')
        if m == "obj_key":
            return WS | frozenset(b'"')
        if m == "obj_colon":
            return WS | frozenset(b":")
        if m == "obj_after":
            return WS | frozenset(b",}")
        if m == "arr_after":
            return WS | frozenset(b",]")
        if m == "string":
            return STRING_BODY | frozenset(b'"\\')
        if m == "string_escape":
            return ESCAPABLE
        if m.startswith("string_u"):
            return HEX
        if m == "num_sign":
            return DIGITS
        if m == "num_zero":
            return WS | frozenset(b".eE") | self._terminators()
        if m == "num_int":
            return WS | DIGITS | frozenset(b".eE") | self._terminators()
        if m == "num_dot":
            return DIGITS
        if m == "num_frac":
            return WS | DIGITS | frozenset(b"eE") | self._terminators()
        if m == "num_esign":
            return DIGITS
        if m == "num_e":
            return DIGITS | frozenset(b"+-")
        if m == "num_exp":
            return WS | DIGITS | self._terminators()
        if m == "literal":
            return frozenset((self._literal_rest[0],))
        if m == "done":
            return WS
        raise AssertionError(f"unknown mode {self.mode}")

    def _complete_value(self) -> None:
        """A value just finished: pop into the surrounding context."""
        if self._string_is_key:
            self._string_is_key = False
            self.mode = "obj_colon"
            return
        if not self.stack:
            self.mode = "done"
        elif self.stack[-1] == "obj":
            self.mode = "obj_after"
        else:
            self.mode = "arr_after"

    def feed(self, b: int) -> None:
        assert b in self.allowed(), f"byte {bytes([b])!r} illegal in mode {self.mode}"
        m = self.mode

        # Number modes terminate on a byte that belongs to the NEXT context;
        # complete the number first, then re-process the byte.
        if m in ("num_zero", "num_int", "num_frac", "num_exp") and (
                b in WS or b in self._terminators()):
            self._complete_value()
            if self.mode == "obj_colon":  # impossible: numbers are never keys
                raise AssertionError
            self.feed(b)
            return

        if b in WS and m not in ("string", "string_escape") \
                and not m.startswith("string_u"):
            return  # whitespace never changes structural state

        if m in ("value", "value_or_close"):
            self.started = True
            if m == "value_or_close" and b == ord("]"):
                self.stack.pop()
                self._complete_value()
            elif b == ord("{"):
                self.stack.append("obj")
                self.mode = "obj_first"
            elif b == ord("["):
                self.stack.append("arr")
                self.mode = "value_or_close"
            elif b == ord('"'):
                self.mode = "string"
            elif b == ord("-"):
                self.mode = "num_sign"
            elif b == ord("0"):
                self.mode = "num_zero"
            elif b in ONENINE:
                self.mode = "num_int"
            else:
                self._literal_rest = _LITERALS[b]
                self.mode = "literal"
        elif m == "obj_first":
            if b == ord("}"):
                self.stack.pop()
                self._complete_value()
            else:                               # '"' starts a key
                self._string_is_key = True
                self.mode = "string"
        elif m == "obj_key":
            self._string_is_key = True
            self.mode = "string"
        elif m == "obj_colon":
            self.mode = "value"
        elif m == "obj_after":
            if b == ord("}"):
                self.stack.pop()
                self._complete_value()
            else:
                self.mode = "obj_key"
        elif m == "arr_after":
            if b == ord("]"):
                self.stack.pop()
                self._complete_value()
            else:
                self.mode = "value"
        elif m == "string":
            if b == ord('"'):
                self._complete_value()
            elif b == ord("\\"):
                self.mode = "string_escape"
        elif m == "string_escape":
            self.mode = "string_u4" if b == ord("u") else "string"
        elif m.startswith("string_u"):
            k = int(m[-1]) - 1
            self.mode = "string" if k == 0 else f"string_u{k}"
        elif m == "num_sign":
            self.mode = "num_zero" if b == ord("0") else "num_int"
        elif m in ("num_zero", "num_int"):
            if b == ord("."):
                self.mode = "num_dot"
            elif b in (ord("e"), ord("E")):
                self.mode = "num_e"
            # else: another digit in num_int — stay
        elif m == "num_dot":
            self.mode = "num_frac"
        elif m == "num_frac":
            if b in (ord("e"), ord("E")):
                self.mode = "num_e"
        elif m == "num_e":
            self.mode = "num_esign" if b in (ord("+"), ord("-")) else "num_exp"
        elif m == "num_esign":
            self.mode = "num_exp"
        elif m == "num_exp":
            pass                            # more exponent digits
        elif m == "literal":
            self._literal_rest = self._literal_rest[1:]
            if not self._literal_rest:
                self._complete_value()
        else:
            raise AssertionError(f"feed in mode {m}")

    # -- budget-exhaustion repair ------------------------------------------
    def closing_suffix(self) -> bytes:
        """Shortest byte suffix that completes the document from the current
        state — guarantees parseability when generation hits max tokens."""
        out = bytearray()
        st = self
        m = st.mode
        # Finish any in-progress scalar.
        if m == "string_escape":
            out += b'n'
            m = "string"
        elif m.startswith("string_u"):
            out += b"0" * int(m[-1])
            m = "string"
        if m == "string":
            out += b'"'
            if st._string_is_key:
                out += b':null'
        elif m in ("num_sign", "num_dot"):
            out += b"0"
        elif m == "num_e" or m == "num_esign":
            out += b"0"
        elif m == "literal":
            out += st._literal_rest
        elif m in ("value", "value_or_close"):
            if not st.started and st.force_object:
                out += b"{}"
            elif m == "value_or_close":
                out += b"]"
                return bytes(out) + st._close_frames(st.stack[:-1])
            else:
                out += b"null"
        elif m == "obj_first":
            out += b"}"
            return bytes(out) + st._close_frames(st.stack[:-1])
        elif m == "obj_key":
            out += b'"":null'
        elif m == "obj_colon":
            out += b":null"
        return bytes(out) + st._close_frames(st.stack)

    @staticmethod
    def _close_frames(frames: List[str]) -> bytes:
        return b"".join(b"}" if f == "obj" else b"]" for f in reversed(frames))


def validate_json_bytes(data: bytes, force_object: bool = False) -> bool:
    """True iff ``data`` is a complete JSON document per the automaton
    (used by tests to cross-check against ``json.loads``)."""
    st = JsonState(force_object=force_object)
    for b in data:
        if b not in st.allowed():
            return False
        st.feed(b)
    return st.done


def constrain_mask(state: JsonState, vocab_size: int, eos_id: int) -> "np.ndarray":
    """Boolean mask [vocab_size]: True = legal next token. Byte tokens map
    1:1 to ids 0-255; EOS is legal only once the document is complete."""
    import numpy as np

    mask = np.zeros((vocab_size,), bool)
    for b in state.allowed():
        mask[b] = True
    if state.done:
        mask[eos_id] = True
    return mask
