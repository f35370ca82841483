"""Token-level classification queries and their bincount embedding.

Frozen copies of the program's ``data/synth.py::make_token_task`` and of
the query embedding its smoke script uses (``token_embed``), kept with the
benchmark so that a later change to the program cannot change the traffic.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def make_token_task(
    num_classes: int,
    seq_len: int,
    vocab: int,
    n: int,
    seed: int = 0,
    noise: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Sequences whose final token must be the class id.

    The class is determined by which `signature` token appears most often in
    the sequence body — learnable by a tiny LM, with capacity controlling
    attainable accuracy (bigger arms really are better).
    """
    rng = np.random.default_rng(seed)
    if vocab <= num_classes + 8:
        raise ValueError(f"vocab {vocab} must exceed num_classes + 8 = {num_classes + 8}")
    sig_tokens = np.arange(num_classes) + 4          # reserved signature ids
    body_len = seq_len - 2
    tokens = rng.integers(num_classes + 4, vocab, size=(n, seq_len))
    labels = rng.integers(num_classes, size=n)
    for i in range(n):
        # plant signature occurrences of the true class (+ distractors)
        k_true = rng.integers(4, max(5, body_len // 4))
        pos = rng.choice(body_len, size=k_true, replace=False)
        tokens[i, pos] = sig_tokens[labels[i]]
        distract = rng.integers(num_classes)
        if distract != labels[i]:
            k_d = int(rng.integers(1, max(2, k_true - 1)))   # strictly fewer
            free = np.setdiff1d(np.arange(body_len), pos)    # never overwrite
            if free.size:
                pos_d = rng.choice(free, size=min(k_d, free.size), replace=False)
                tokens[i, pos_d] = sig_tokens[distract]
    tokens[:, -2] = 2                                 # "answer:" marker
    tokens[:, -1] = sig_tokens[labels]                # answer token
    if noise > 0:
        flip = rng.random(n) < noise
        tokens[flip, -1] = sig_tokens[rng.integers(num_classes, size=flip.sum())]
    return {
        "tokens": tokens.astype(np.int32),
        "labels": labels.astype(np.int32),
        "class_token_ids": sig_tokens.astype(np.int32),
    }


def token_embed(tokens, vocab: int) -> np.ndarray:
    """The bincount query embedding of ``examples/train_and_serve.py``."""
    return np.stack([np.bincount(t, minlength=vocab) for t in tokens]).astype(float)
