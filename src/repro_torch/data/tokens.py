"""Synthetic token streams for LM smoke runs (the reference's
``src/repro/data/tokens.py``, copied as numpy code so both packages draw
the same tokens from a seed).  Markov-chain tokens give non-trivial,
learnable structure, so a falling training loss is a meaningful signal."""

from __future__ import annotations

import numpy as np


def markov_tokens(num_tokens: int, vocab: int, *, seed: int = 0,
                  branching: int = 8) -> np.ndarray:
    """``num_tokens`` int32 tokens of a random chain in which each token
    has ``branching`` successors, drawn uniformly."""
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, vocab, size=(vocab, branching))
    out = np.empty(num_tokens, dtype=np.int32)
    t = int(rng.integers(0, vocab))
    for i in range(num_tokens):
        out[i] = t
        t = int(nxt[t, rng.integers(0, branching)])
    return out


def lm_batches(tokens: np.ndarray, batch: int, seq: int, *, seed: int = 0):
    """Endless ``{"tokens", "labels"}`` batches of ``batch`` windows of
    ``seq`` tokens at random starts, labels shifted by one."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        starts = rng.integers(0, n, batch)
        x = np.stack([tokens[s:s + seq] for s in starts])
        y = np.stack([tokens[s + 1:s + seq + 1] for s in starts])
        yield {"tokens": x, "labels": y}
