# Copy of repro/data/tokenizer.py (framework-free).
"""Deterministic hash tokenizer (offline stand-in for BPE).

Word-level hashing into a fixed vocab with reserved specials. Deterministic
across runs/processes (uses zlib.crc32, not Python's salted hash).
"""

from __future__ import annotations

import re
import zlib

PAD, BOS, EOS, UNK = 0, 1, 2, 3
N_SPECIALS = 4
_WORD = re.compile(r"[a-z0-9']+")


def encode(text: str, vocab_size: int, max_len: int | None = None,
           add_bos: bool = True) -> list[int]:
    ids = [BOS] if add_bos else []
    for w in _WORD.findall(text.lower()):
        h = zlib.crc32(w.encode()) % (vocab_size - N_SPECIALS)
        ids.append(N_SPECIALS + h)
    if max_len is not None:
        ids = ids[:max_len] + [PAD] * (max_len - len(ids))
    return ids


def encode_batch(texts, vocab_size: int, max_len: int):
    import numpy as np
    return np.array([encode(t, vocab_size, max_len) for t in texts], np.int32)
