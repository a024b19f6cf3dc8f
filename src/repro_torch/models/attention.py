"""GQA attention with RoPE: counterpart of the GQA part of
``repro.models.attention``.

Parameters keep the reference's einsum layouts: ``wq (d,Hq,hd)``,
``wk``/``wv (d,Hkv,hd)``, ``wo (Hq,hd,d)``.  Decode and chunked prefill
write their new K/V rows into the cache tensors they are given, in place,
and return them: the reference returns updated copies, which on the card
would cost a cache copy per layer per step.  With ``window > 0`` decode
and chunked prefill treat the cache as a ring of ``min(window, S)`` rows
(post-RoPE attention does not care about key order): zamba2's shared block
takes that branch whenever its cache is no longer than the window.  The
prefill-side ring placement of ``local`` layers (``lm._pad_cache`` in the
reference) is not ported yet (ROADMAP queue 1, item 1.2).
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
               cfg: ArchConfig, *, window: int = 0):
    """One-token decode. x: (B,1,D); cache {k,v: (B,S,Hkv,hd)} written in
    place; positions (B,) absolute position of the new token.  Global: row
    ``positions``, keys 0..positions.  Ring (``window > 0``): row
    ``positions % size``, the last ``min(positions + 1, size)`` keys.
    Returns (out (B,1,D), cache)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, positions[:, None], cfg)
    if window > 0:
        size = min(window, cache["k"].shape[1])
        slot = positions % size
        eff_len = torch.clamp_max(positions + 1, size)
    else:
        slot, eff_len = positions, positions + 1
    bidx = torch.arange(b, device=x.device)
    rows = slot.long()
    cache["k"][bidx, rows] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, rows] = v[:, 0].to(cache["v"].dtype)
    o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], eff_len.to(torch.int32),
                             use_kernel=cfg.use_kernels)
    return torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None, :], cache


def _masked_softmax_attend(q: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                           valid: torch.Tensor, spec: str) -> torch.Tensor:
    """The decode path's masked softmax for many queries at once, products
    accumulated in fp32 (``spec`` names the key axis layout)."""
    logits = torch.einsum(f"bqhd,{spec}->bqhk", q.to(keys.dtype).float(),
                          keys.float()) * q.shape[-1] ** -0.5
    logits = torch.where(valid[:, :, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum(f"bqhk,{spec}->bqhd", probs.to(vals.dtype).float(),
                        vals.float()).to(q.dtype)


def gqa_prefill(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
                cfg: ArchConfig, *, window: int = 0):
    """Chunked prefill: C prompt tokens at once against the decode cache.

    x: (B,C,D); positions (B,C) absolute, contiguous ascending.  Every query
    attends with the masked softmax of the one-token decode path, so its
    logits match decode's; the chunk's K/V rows land in the cache in place.
    Global: rows ``positions``, each query over the whole cache.  Ring
    (``window > 0``): each query sees the ring as it stood at its own decode
    step (slot s at time t holds position t - ((t - s) % size): a chunk row
    if that lies in the chunk, else the pre-chunk ring), and the ring ends
    holding, per slot, the last chunk position that maps there.  Plain
    code: the reference runs no kernel here either.  Returns (out (B,C,D),
    cache)."""
    b, c, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg)
    group = max(cfg.n_heads // k.shape[2], 1)
    k_cd, v_cd = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
    pos = positions.long()

    def expand(t, dim):
        return t.repeat_interleave(group, dim=dim) if group > 1 else t

    if window > 0:
        size = min(window, cache["k"].shape[1])
        slots = torch.arange(size, device=x.device)
        start = pos[:, :1]                                               # chunk offset
        cand = pos[:, :, None] - ((pos[:, :, None] - slots[None, None, :]) % size)
        sel = (cand >= start[:, :, None])[..., None, None]               # (B,C,size,1,1)
        idx = torch.clamp(cand - start[:, :, None], 0, c - 1)
        b3 = torch.arange(b, device=x.device)[:, None, None]
        keys = torch.where(sel, k_cd[b3, idx], cache["k"][:, None])     # (B,C,size,Hkv,hd)
        vals = torch.where(sel, v_cd[b3, idx], cache["v"][:, None])
        valid = slots[None, None, :] < torch.clamp_max(pos + 1, size)[:, :, None]
        o = _masked_softmax_attend(q, expand(keys, 3), expand(vals, 3), valid, "bqkhd")
        last = pos[:, -1:]
        cand_f = last - ((last - slots[None, :]) % size)                 # (B,size)
        sel_f = (cand_f >= start)[..., None, None]
        idx_f = torch.clamp(cand_f - start, 0, c - 1)
        b2 = torch.arange(b, device=x.device)[:, None]
        cache["k"].copy_(torch.where(sel_f, k_cd[b2, idx_f], cache["k"]))
        cache["v"].copy_(torch.where(sel_f, v_cd[b2, idx_f], cache["v"]))
    else:
        b2 = torch.arange(b, device=x.device)[:, None]
        cache["k"][b2, pos] = k_cd
        cache["v"][b2, pos] = v_cd
        rows = torch.arange(cache["k"].shape[1], device=x.device)
        valid = rows[None, None, :] < (pos[:, :, None] + 1)
        o = _masked_softmax_attend(q, expand(cache["k"], 2), expand(cache["v"], 2), valid,
                                   "bkhd")
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache


def gqa_cache_shape(cfg: ArchConfig, batch: int, length: int, window: int = 0) -> dict:
    size = min(window, length) if window > 0 else length
    kv = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}
