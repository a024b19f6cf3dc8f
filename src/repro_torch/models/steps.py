"""Serving entry points: counterpart of the serving half of
``repro.models.steps`` (training waits for ROADMAP queue 1 item 1.5)."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import lm


def prefill(params: dict, batch: dict, *, cfg: ArchConfig, cache_len: int = 0):
    """Full-sequence forward emitting a decode cache (padded to cache_len).
    Returns (last-position logits (B,V), cache)."""
    cache_len = cache_len or batch["tokens"].shape[1]
    logits, _, cache = lm.forward(params, cfg, batch, collect_cache=True,
                                  cache_len=cache_len)
    return logits[:, -1], cache


def serve_step(params: dict, cache: dict, tokens: torch.Tensor, positions: torch.Tensor,
               *, cfg: ArchConfig):
    """ONE new token per sequence against the cache. tokens: (B,1)."""
    return lm.decode_step(params, cfg, tokens, positions, cache)


def greedy_decode_loop(params: dict, cache: dict, first_token: torch.Tensor,
                       start_pos: torch.Tensor, n_steps: int, *, cfg: ArchConfig):
    """Greedy generation, one decode step per token: first_token (B,1),
    start_pos (B,).  Returns (tokens (B, n_steps), cache)."""
    tok, pos, out = first_token, start_pos, []
    for _ in range(n_steps):
        logits, cache = lm.decode_step(params, cfg, tok, pos, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        pos = pos + 1
        out.append(tok[:, 0])
    toks = torch.stack(out, dim=1) if out else first_token[:, :0]
    return toks, cache
