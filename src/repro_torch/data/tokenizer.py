"""Byte-level tokenizer for the real tiny-pool serving path (no external
tokenizer artifacts in this environment)."""
from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 256, 257, 258
VOCAB_SIZE = 259


class ByteTokenizer:
    vocab_size = VOCAB_SIZE
    pad, bos, eos = PAD, BOS, EOS

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [BOS] + ids
        if add_eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        return bytes(int(i) for i in ids if int(i) < 256).decode("utf-8", errors="replace")

    def pad_batch(self, seqs: list[list[int]], length: int | None = None):
        """Right-pad to a common length.  Returns (tokens (B, L) int32, lengths)."""
        L = length or max(len(s) for s in seqs)
        out = np.full((len(seqs), L), PAD, dtype=np.int32)
        lens = np.zeros(len(seqs), dtype=np.int32)
        for i, s in enumerate(seqs):
            s = s[:L]
            out[i, : len(s)] = s
            lens[i] = len(s)
        return out, lens
