"""Self-contained byte-level tokenizer (no external vocab files); the
port's copy of ``repro/data/tokenizer.py``.

ids 0..3 are reserved: 0 pad, 1 bos, 2 sep/answer-marker, 3 eos; bytes map
to 4..259. Good enough for the runnable examples; production would swap in
a trained BPE via the same interface.
"""
from __future__ import annotations

from typing import List

import numpy as np

PAD, BOS, SEP, EOS = 0, 1, 2, 3
OFFSET = 4
VOCAB_SIZE = 256 + OFFSET


def encode(text: str, max_len: int = 0) -> np.ndarray:
    ids = [BOS] + [b + OFFSET for b in text.encode("utf-8")] + [EOS]
    if max_len:
        ids = ids[:max_len]
        ids = ids + [PAD] * (max_len - len(ids))
    return np.asarray(ids, np.int32)


def decode(ids) -> str:
    bs = bytes(int(i) - OFFSET for i in ids if int(i) >= OFFSET)
    return bs.decode("utf-8", errors="replace")


def encode_batch(texts: List[str], max_len: int) -> np.ndarray:
    return np.stack([encode(t, max_len) for t in texts])
