"""Byte-level tokenizer for the examples and the serving engine.

Deliberately minimal (UTF-8 bytes + specials) — the framework treats
tokenization as an exchangeable frontend; the serving engine and data
pipeline only need ids < vocab_size and a reserved EOS.
"""
from __future__ import annotations

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_OFFSET = 3          # byte b -> id b + _OFFSET


class ByteTokenizer:
    vocab_size = 256 + _OFFSET

    def encode(self, text: str, bos: bool = True, eos: bool = False):
        ids = [b + _OFFSET for b in text.encode("utf-8")]
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        data = bytes(int(i) - _OFFSET for i in np.asarray(ids).ravel()
                     if int(i) >= _OFFSET)
        return data.decode("utf-8", errors="replace")

    def pad_batch(self, seqs, length: int | None = None) -> np.ndarray:
        length = length or max(len(s) for s in seqs)
        out = np.full((len(seqs), length), PAD_ID, dtype=np.int32)
        for i, s in enumerate(seqs):
            s = np.asarray(s)[:length]
            out[i, length - len(s):] = s        # left padding (decode-ready)
        return out
