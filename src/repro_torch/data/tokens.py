"""LM token pipeline: deterministic synthetic shards + next-token batching.

Documents come from a seeded Markov-ish mixture (each sequence follows one
of ``n_modes`` bigram shifts 75% of the time), packed into fixed-length
sequences and served as {tokens, labels} with labels = tokens shifted
left.  A seed gives the same batches as the JAX package's
``repro.data.tokens`` (same draws in the same order); numpy only.
"""

from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seq_len: int, *, seed: int = 0, n_modes: int = 32):
        self.vocab = vocab
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        # low-entropy structure: per-mode bigram preferences
        self.mode_shift = self.rng.integers(1, vocab - 1, n_modes)
        self.n_modes = n_modes

    def batch(self, batch_size: int) -> dict[str, np.ndarray]:
        B, S, V = batch_size, self.seq_len, self.vocab
        mode = self.rng.integers(0, self.n_modes, B)
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = self.rng.integers(0, V, B)
        noise = self.rng.random((B, S))
        rand = self.rng.integers(0, V, (B, S))
        shift = self.mode_shift[mode][:, None]
        for t in range(S):
            nxt = (toks[:, t] + shift[:, 0]) % V
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, nxt, rand[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
