"""Synthetic LM token pipeline, counterpart of ``repro.data.tokens``:
deterministic Markov-ish token streams in numpy, batch for batch the
reference's (the same generator calls in the same order), shaped for
``models.lm.forward`` (the data substrate under ``LMTrainJob``).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class TokenStream:
    """Order-1 Markov chain over the vocab with a banded transition kernel:
    cheap, deterministic, non-uniform (so loss actually decreases)."""

    def __init__(self, vocab_size: int, seed: int = 0, band: int = 32):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        self.band = band

    def sample(self, batch: int, seq: int) -> np.ndarray:
        toks = np.empty((batch, seq), np.int32)
        toks[:, 0] = self.rng.integers(0, self.vocab, batch)
        steps = self.rng.integers(1, self.band, size=(batch, seq - 1))
        jump = self.rng.random((batch, seq - 1)) < 0.05
        rand = self.rng.integers(0, self.vocab, size=(batch, seq - 1))
        for t in range(1, seq):
            nxt = (toks[:, t - 1] + steps[:, t - 1]) % self.vocab
            toks[:, t] = np.where(jump[:, t - 1], rand[:, t - 1], nxt)
        return toks


def lm_batches(cfg, batch: int, seq: int, *, seed: int = 0,
               n_batches: Optional[int] = None) -> Iterator[dict]:
    """Batches shaped for models.lm.forward (tokens, labels, + frontend
    stubs for vlm/audio archs)."""
    stream = TokenStream(cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    i = 0
    while n_batches is None or i < n_batches:
        toks = stream.sample(batch, seq)
        out = {"tokens": toks, "labels": toks.copy()}
        if cfg.use_mrope:
            pos = np.broadcast_to(np.arange(seq, dtype=np.int32)[None, None],
                                  (batch, 3, seq)).copy()
            out["mrope_positions"] = pos
        if cfg.family == "vlm":
            nv = min(cfg.n_vision_tokens, seq)
            out["vision_embeds"] = rng.normal(
                0, 0.02, (batch, nv, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            out["frames"] = rng.normal(
                0, 1.0, (batch, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        yield out
        i += 1
