"""GQA attention with RoPE: counterpart of the GQA part of
``repro.models.attention``.

Parameters keep the reference's einsum layouts: ``wq (d,Hq,hd)``,
``wk``/``wv (d,Hkv,hd)``, ``wo (Hq,hd,d)``.  Decode and chunked prefill
write their new K/V rows into the cache tensors they are given, in place,
and return them: the reference returns updated copies, which on the card
would cost a cache copy per layer per step.  The sliding-window ("local")
ring cache is not ported yet (ROADMAP queue 1, item 1.2).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .modules import dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B,S,H,D); positions: (B,S) -> rotated x (half-split convention)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                  # (D/2,)
    angles = positions[..., None].float() * freqs                      # (B,S,D/2)
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def gqa_init(cfg: ArchConfig, dtype: torch.dtype, *, generator: torch.Generator,
             device) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {"wq": dense_init((d, hq, hd), fan_in=d, **kw),
            "wk": dense_init((d, hkv, hd), fan_in=d, **kw),
            "wv": dense_init((d, hkv, hd), fan_in=d, **kw),
            "wo": dense_init((hq, hd, d), fan_in=hq * hd, **kw)}


def _qkv(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def gqa_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                *, window: int = 0, causal: bool = True, return_kv: bool = False):
    """Full-sequence attention (prefill). x: (B,S,D); positions (B,S)."""
    q, k, v = _qkv(p, x, positions, cfg)
    o = ops.flash_attention(q, k, v, causal=causal, window=window,
                            use_kernel=cfg.use_kernels)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return (out, (k, v)) if return_kv else out


def gqa_decode(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
               cfg: ArchConfig):
    """One-token decode. x: (B,1,D); cache {k,v: (B,S,Hkv,hd)} written in
    place at row ``positions``; positions (B,) absolute position of the new
    token.  Returns (out (B,1,D), cache)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, positions[:, None], cfg)
    bidx = torch.arange(b, device=x.device)
    rows = positions.long()
    cache["k"][bidx, rows] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, rows] = v[:, 0].to(cache["v"].dtype)
    o = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                             (positions + 1).to(torch.int32),
                             use_kernel=cfg.use_kernels)
    return torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None, :], cache


def gqa_prefill(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
                cfg: ArchConfig):
    """Chunked prefill: C prompt tokens at once against the decode cache.

    x: (B,C,D); positions (B,C) absolute, contiguous ascending.  Writes the
    chunk's K/V rows into the cache in place, then attends every query over
    the whole cache with the masked softmax of the one-token decode path, so
    its logits match decode's.  Plain code: the reference runs no kernel
    here either.  Returns (out (B,C,D), cache)."""
    b, c, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg)
    cache_size = cache["k"].shape[1]
    scale = q.shape[-1] ** -0.5
    group = max(cfg.n_heads // k.shape[2], 1)
    b2 = torch.arange(b, device=x.device)[:, None]
    cache["k"][b2, positions.long()] = k.to(cache["k"].dtype)
    cache["v"][b2, positions.long()] = v.to(cache["v"].dtype)
    keys = cache["k"].repeat_interleave(group, dim=2) if group > 1 else cache["k"]
    vals = cache["v"].repeat_interleave(group, dim=2) if group > 1 else cache["v"]
    logits = torch.einsum("bqhd,bkhd->bqhk", q.to(keys.dtype).float(), keys.float()) * scale
    valid = torch.arange(cache_size, device=x.device)[None, None, :] < (positions[:, :, None] + 1)
    logits = torch.where(valid[:, :, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bqhk,bkhd->bqhd", probs.to(vals.dtype).float(),
                     vals.float()).to(q.dtype)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache


def gqa_cache_shape(cfg: ArchConfig, batch: int, length: int) -> dict:
    kv = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}
