"""GQA attention with RoPE: counterpart of the GQA part of
``repro.models.attention``.

Parameters keep the reference's einsum layouts: ``wq (d,Hq,hd)``,
``wk``/``wv (d,Hkv,hd)``, ``wo (Hq,hd,d)``.  Decode and chunked prefill
write their new K/V rows into the cache tensors they are given, in place,
and return them: the reference returns updated copies, which on the card
would cost a cache copy per layer per step.  With ``window > 0`` decode
and chunked prefill treat the cache as a ring of ``min(window, S)`` rows
(post-RoPE attention does not care about key order): ``local`` layers
(h2o_danube) always, zamba2's shared block whenever its cache is no longer
than the window.  ``lm.forward`` places a prefill's rows in the ring.
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
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
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
                           valid: torch.Tensor) -> torch.Tensor:
    """The decode path's masked softmax for many queries at once, over one key
    buffer per row that every query of the row shares, products accumulated
    in fp32: q (B,C,Hq,hd); keys, vals (B,L,Hkv,hd); valid (B,C,L).  Query
    heads are grouped onto their kv head rather than the keys repeated, so
    the logits (Hq x C x L a row) are the largest intermediate."""
    b, c, hq, hd = q.shape
    hkv = keys.shape[2]
    qg = q.to(keys.dtype).float().reshape(b, c, hkv, hq // hkv, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, keys.float()) * hd ** -0.5
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(vals.dtype).float(), vals.float())
    return out.reshape(b, c, hq, hd).to(q.dtype)


def gqa_prefill(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
                cfg: ArchConfig, *, window: int = 0):
    """Chunked prefill: C prompt tokens at once against the decode cache.

    x: (B,C,D); positions (B,C) absolute, contiguous ascending.  Every query
    attends with the masked softmax of the one-token decode path, so its
    logits match decode's; the chunk's K/V rows land in the cache in place.
    Global: rows ``positions``, each query over the whole cache.  Ring
    (``window > 0``): query t sees exactly what its decode step would, the
    positions max(0, t - size + 1) .. t: those before the chunk from the
    pre-chunk ring, the rest from the chunk.  The reference rebuilds the
    ring per query (C copies of it); here every query of a row shares one
    buffer, the pre-chunk ring unrolled into position order followed by the
    chunk's rows, under a band mask, so memory is O((size + C) Hkv hd) a row
    plus Hq x C x (size + C) logits.  The ring ends holding, per slot, the
    last chunk position that maps there.  Plain code: the reference runs no
    kernel here either.  Returns (out (B,C,D), cache)."""
    b, c, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg)
    k_cd, v_cd = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
    pos = positions.long()
    b2 = torch.arange(b, device=x.device)[:, None]
    if window > 0:
        size = min(window, cache["k"].shape[1])
        slots = torch.arange(size, device=x.device)
        start = pos[:, :1]                                               # chunk offset
        # one buffer per row, in position order: the pre-chunk ring unrolled
        # (positions start - size .. start - 1, negative ones never written)
        # then the chunk's rows; query t sees the band t - size < p <= t
        ring = (start + slots[None, :]) % size                           # (B,size)
        keys = torch.cat([cache["k"][b2, ring], k_cd], dim=1)           # (B,size+C,Hkv,hd)
        vals = torch.cat([cache["v"][b2, ring], v_cd], dim=1)
        kpos = start - size + torch.arange(size + c, device=x.device)[None, :]
        valid = (kpos[:, None, :] <= pos[:, :, None]) & \
            (kpos[:, None, :] > pos[:, :, None] - size) & (kpos[:, None, :] >= 0)
        o = _masked_softmax_attend(q, keys, vals, valid)
        last = pos[:, -1:]
        cand_f = last - ((last - slots[None, :]) % size)                 # (B,size)
        sel_f = (cand_f >= start)[..., None, None]
        idx_f = torch.clamp(cand_f - start, 0, c - 1)
        cache["k"].copy_(torch.where(sel_f, k_cd[b2, idx_f], cache["k"]))
        cache["v"].copy_(torch.where(sel_f, v_cd[b2, idx_f], cache["v"]))
    else:
        cache["k"][b2, pos] = k_cd
        cache["v"][b2, pos] = v_cd
        rows = torch.arange(cache["k"].shape[1], device=x.device)
        valid = rows[None, None, :] < (pos[:, :, None] + 1)
        o = _masked_softmax_attend(q, cache["k"], cache["v"], valid)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache


def gqa_cache_shape(cfg: ArchConfig, batch: int, length: int, window: int = 0) -> dict:
    size = min(window, length) if window > 0 else length
    kv = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}
