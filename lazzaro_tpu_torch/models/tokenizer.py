"""Byte-level tokenizer of the decoder LM, a copy of
``lazzaro_tpu/models/tokenizer.py:ByteTokenizer``.

Lossless and offline: ids 0..255 are raw bytes, then PAD 256, BOS 257 and
EOS 258. ``HashTokenizer`` belongs to the encoder and is ported with it.
"""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    """Reversible byte-level tokenizer for the decoder LM.

    vocab = 256 raw bytes + {PAD=256, BOS=257, EOS=258}, so generated ids
    detokenize back to text without any downloaded vocabulary."""

    PAD = 256
    BOS = 257
    EOS = 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.BOS] + ids
        if add_eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids) -> str:
        data = bytes(int(i) for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")
