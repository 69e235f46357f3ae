"""Synthetic token streams for LM-scale HFL training, a copy of the
reference's ``data/tokens.py`` (numpy, so both packages draw the same
tokens from the same seed).

Zipf-distributed tokens with client-specific topic biases so clients are
non-IID (mirrors the 2-labels-per-client classification split at LM
scale). Batches are numpy int32; the training loop moves them to its
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class TokenStream:
    """Deterministic, reshufflable stream of (tokens, labels) LM batches."""
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    topic_bias: int = 0     # shifts the token distribution per client

    def batches(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        while True:
            yield self.sample(rng)

    def sample(self, rng: np.random.Generator) -> dict:
        z = rng.zipf(self.zipf_a, (self.batch_size, self.seq_len + 1))
        toks = (z + self.topic_bias) % self.vocab_size
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def client_token_shards(num_clients: int, vocab_size: int, seq_len: int,
                        batch_size: int, seed: int = 0
                        ) -> Tuple[TokenStream, ...]:
    return tuple(
        TokenStream(vocab_size=vocab_size, seq_len=seq_len,
                    batch_size=batch_size, seed=seed + 1000 * c,
                    topic_bias=(c * vocab_size) // max(num_clients, 1))
        for c in range(num_clients))
