"""GQA attention (RoPE, M-RoPE or none), cross-attention and MLA:
counterpart of ``repro.models.attention``.

Positions are (B,S) or, under M-RoPE (qwen2-vl), (B,3,S): the (t, h, w)
streams, each rotating its own section of the frequency dims.  Caches are
indexed by the temporal stream (``_tpos``), as in the reference.  An arch
with ``use_rope=False`` (whisper) rotates nothing.  Whisper's decoder
cross-attends the encoder's rows: ``cross_kv`` projects them once a
prefill, ``cross_forward`` runs non-causal flash attention over them and
``cross_decode`` decode attention with every row's length the encoder's.

Under tensor parallelism (``models/sharding``) ``gqa_forward`` runs on
this rank's heads: q/k/v column parallel, both attention kernels on the
local heads (k and v sliced for them where their heads do not divide the
model axis), ``wo`` row parallel and its partial sum reduced.  The
cross-attention does the same with its k and v projected from the
encoder's rows (the rank's block of the cross cache).
``mla_forward`` does the same with MLA's queries and decompression
(``_split_mla``), its compression whole on every rank.

Parameters keep the reference's einsum layouts: ``wq (d,Hq,hd)``,
``wk``/``wv (d,Hkv,hd)``, ``wo (Hq,hd,d)``.  Decode and chunked prefill
write their new K/V rows into the cache tensors they are given, in place,
and return them: the reference returns updated copies, which on the card
would cost a cache copy per layer per step.  With ``window > 0`` decode
and chunked prefill treat the cache as a ring of ``min(window, S)`` rows
(post-RoPE attention does not care about key order): ``local`` layers
(h2o_danube) always, zamba2's shared block whenever its cache is no longer
than the window.  ``lm.forward`` places a prefill's rows in the ring.

MLA (deepseek-v2) keeps the compressed cache ``{c_kv (B,S,r), k_rope
(B,S,dr)}``.  Its full-sequence forward decompresses to multi-head
attention at qk head dim ``dn + dr`` through flash attention (the kernel
path zero-pads v to that width and passes the scale of the qk dim); its
decode and chunked prefill run in the absorbed form (q folded through
``w_uk``, the output through ``w_uv``) over the compressed cache, plain
products with fp32 scores, no kernel, as in the reference.  Layouts:
``w_uq (d,H,dn)``, ``w_qr (d,H,dr)``, ``w_dkv (d,r+dr)``, ``w_uk (r,H,dn)``,
``w_uv (r,H,dv)``, ``wo (H,dv,d)``.

The ``*_decode_stacked`` variants write one layer's rows straight into the
layer-stacked cache (G,B,S,...) at group ``g``: the reference keeps them
as twins of its scanned decode.  Since decode writes in place here, each
runs the per-layer decode on views of group ``g``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from . import sharding as msh
from .modules import dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """theta^(-i / half), i < half: the fp32 exponents of the reference, the
    power taken in fp64 and rounded (the correctly rounded fp32 value,
    which the reference's fp32 power gives; torch's fp32 ``pow`` is an ulp
    off at some i, which moves the angle at position p by p such ulps)."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    base = torch.tensor(theta, dtype=torch.float32).item()
    return torch.pow(base, expo.double()).float()


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,D) rotated by angles (B,S,D/2), half-split convention, in fp32."""
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B,S,H,D); positions: (B,S) -> rotated x (half-split convention)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                  # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions (B,3,S), the (t, h, w) streams.  The D/2
    frequencies split into three sections, ``half - 2 (half // 3)`` then
    ``half // 3`` twice (22/21/21 at D 128), stream i rotating section i."""
    half = x.shape[-1] // 2
    sections = (half - 2 * (half // 3), half // 3, half // 3)
    freqs = rope_freqs(x.shape[-1], theta, x.device).split(sections)
    pos = positions.float()
    return _rotate(x, torch.cat([pos[:, i, :, None] * f for i, f in enumerate(freqs)], dim=-1))


def _rope(x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if not cfg.use_rope:
        return x
    if cfg.use_mrope:
        return apply_mrope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


def _tpos(positions: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The temporal stream of (B,3,...) M-RoPE positions, which indexes the
    cache; plain positions as they are."""
    return positions[:, 0] if cfg.use_mrope else positions


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
    """Roped q, k and v of x (B,S,D) (``_project_heads``)."""
    q, k, v = _project_heads(p, x, ("wq", "wk", "wv"), cfg)
    return _rope(q, positions, cfg), _rope(k, positions, cfg), v


def _project_heads(p: dict, x: torch.Tensor, names: tuple, cfg: ArchConfig) -> list:
    """The projections ``names`` (of ``wq``, ``wk``, ``wv``) of x (B,S,D),
    each (B,S,h,hd): x goes through one ``copy``, each projection runs on
    this rank's block of its weight, and each output is constrained as the
    reference constrains q and k (heads over the model axis where they
    divide it, else whole), before any rotation, which needs whole sums: a
    block split on D gives a partial sum, reduced here.  With no mesh, the
    plain einsums."""
    if msh.model_ways() == 1:
        return [torch.einsum("bsd,dhk->bshk", x, p[n]) for n in names]
    heads = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads, "wv": cfg.n_kv_heads}
    x = msh.copy(x)
    return [_heads(p, "bsd,dhk->bshk", x, n, (cfg.d_model, heads[n], cfg.head_dim))
            for n in names]


def _local_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig):
    """The kv heads this rank's query heads read, from k and v (B,S,Hkv,hd):
    keys and values, or a decode cache.  Under tensor parallelism with q
    split on heads and k, v whole (their heads do not divide the model
    axis), each rank takes the kv heads of its own query heads (head h
    reads kv head h // (Hq/Hkv)) after a ``copy``, so the kernel's dk and
    dv, partial over the ranks that share a kv head, are summed: a view
    (``narrow``) where they are a range of heads that each serve the same
    number of those query heads, which copies nothing (a decode step reads
    its rank's heads in place in the cache); one kv head a query head, by
    ``index_select``, where the ranks' query heads do not split evenly
    over kv heads.  Otherwise k and v as they are."""
    hq = q.shape[2]
    if hq == cfg.n_heads or k.shape[2] < cfg.n_kv_heads:
        return k, v
    heads = kv_heads(msh.model_index() * hq, hq, cfg.n_heads // cfg.n_kv_heads)
    k, v = msh.copy(k), msh.copy(v)
    if heads == list(range(heads[0], heads[0] + len(heads))):
        return k.narrow(2, heads[0], len(heads)), v.narrow(2, heads[0], len(heads))
    idx = torch.tensor(heads, device=k.device)
    return torch.index_select(k, 2, idx), torch.index_select(v, 2, idx)


def kv_heads(first: int, hq: int, group: int) -> list:
    """The kv heads query heads ``first`` .. ``first + hq - 1`` read (head h
    reads h // ``group``), each once where every one of them serves the
    same number of those query heads (a local group of hq / their count),
    else one a query head (a local group of 1)."""
    heads = [(first + j) // group for j in range(hq)]
    kv = sorted(set(heads))
    return kv if all(heads.count(h) * len(kv) == hq for h in kv) else heads


def gqa_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                *, window: int = 0, causal: bool = True, return_kv: bool = False):
    """Full-sequence attention (prefill; whisper's encoder with ``causal``
    False). x: (B,S,D); positions (B,S) or (B,3,S).  ``cfg.fused_attention``
    puts the plain path on ``ops.flash_chunked`` (the kernel path ignores
    it).  ``return_kv``: also (k, v) as a prefill caches them, under tensor
    parallelism this rank's block of the cache (its kv heads where they
    divide the model axis, else every one), not only those it read."""
    q, k, v = _qkv(p, x, positions, cfg)
    kl, vl = _local_kv(q, k, v, cfg)
    o = ops.flash_attention(q, kl, vl, causal=causal, window=window,
                            use_kernel=cfg.use_kernels, chunked=cfg.fused_attention,
                            chunk_k=cfg.attn_chunk)
    out = _out_proj(p, o, cfg, cfg.head_dim)
    return (out, (k, v)) if return_kv else out


def _out_proj(p: dict, o: torch.Tensor, cfg: ArchConfig, hd: int) -> torch.Tensor:
    """``wo`` (H,hd,D) on the attention output o (B,S,h,hd).  Under tensor
    parallelism o holds this rank's heads (h < H: ``wo`` row parallel, its
    partial sum reduced) or every head (``wo`` relocated: o through
    ``copy``); the output is whole."""
    if msh.model_ways() == 1:
        return torch.einsum("bshk,hkd->bsd", o, p["wo"])
    split = o.shape[2] < cfg.n_heads                    # o on this rank's heads
    out, layout = msh.project("bshk,hkd->bsd", o if split else msh.copy(o),
                              msh.Layout(2) if split else msh.WHOLE, p["wo"],
                              (cfg.n_heads, hd, cfg.d_model))
    return msh.constrain(out, "batch", None, None, layout=layout)


def gqa_decode(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
               cfg: ArchConfig, *, window: int = 0):
    """One-token decode. x: (B,1,D); cache {k,v: (B,S,Hkv,hd)} written in
    place (other entries, such as whisper's cross rows, untouched);
    positions (B,), or (B,3) under M-RoPE, absolute position of the new
    token, whose temporal stream t indexes the cache.  Global: row t, keys
    0..t.  Ring (``window > 0``): row ``t % size``, the last
    ``min(t + 1, size)`` keys.  Under tensor parallelism the cache is this
    rank's block (``sharding.cache_shardings``: its kv heads, or
    every kv head where they do not divide the model axis), the rank's k
    and v rows land in it, decode attention runs on the rank's query heads
    over the kv heads they read (``_local_kv``: a view of the cache) and
    ``_out_proj`` makes the output whole.  Returns (out (B,1,D), cache)."""
    b = x.shape[0]
    pos_seq = positions[:, :, None] if cfg.use_mrope else positions[:, None]
    q, k, v = _qkv(p, x, pos_seq, cfg)
    tpos = _tpos(pos_seq, cfg)[:, 0]
    if window > 0:
        size = min(window, cache["k"].shape[1])
        slot = tpos % size
        eff_len = torch.clamp_max(tpos + 1, size)
    else:
        slot, eff_len = tpos, tpos + 1
    bidx = torch.arange(b, device=x.device)
    rows = slot.long()
    cache["k"][bidx, rows] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, rows] = v[:, 0].to(cache["v"].dtype)
    kc, vc = _local_kv(q, cache["k"], cache["v"], cfg)
    o = ops.decode_attention(q[:, 0], kc, vc, eff_len.to(torch.int32),
                             use_kernel=cfg.use_kernels)
    return _out_proj(p, o[:, None], cfg, cfg.head_dim), cache


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

    x: (B,C,D); positions (B,C) (or (B,3,C) under M-RoPE, whose temporal
    stream indexes the cache) absolute, contiguous ascending.  Every query
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
    kernel here either.  Under tensor parallelism the cache and the heads
    are the rank's as in ``gqa_decode``.  Returns (out (B,C,D), cache)."""
    b, c, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg)
    k_cd, v_cd = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
    pos = _tpos(positions, cfg).long()
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
        o = _masked_softmax_attend(q, *_local_kv(q, keys, vals, cfg), valid)
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
        o = _masked_softmax_attend(q, *_local_kv(q, cache["k"], cache["v"], cfg), valid)
    return _out_proj(p, o, cfg, cfg.head_dim), cache


def gqa_cache_shape(cfg: ArchConfig, batch: int, length: int, window: int = 0) -> dict:
    size = min(window, length) if window > 0 else length
    kv = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}


def gqa_decode_stacked(p: dict, x: torch.Tensor, stacked: dict, g: int,
                       positions: torch.Tensor, cfg: ArchConfig, *, window: int = 0):
    """``gqa_decode`` writing into group ``g`` of the layer-stacked cache
    {k, v: (G,B,S,Hkv,hd)}, in place.  Returns (out, stacked)."""
    out, _ = gqa_decode(p, x, {name: t[g] for name, t in stacked.items()}, positions, cfg,
                        window=window)
    return out, stacked


# ---------------------------------------------------------------------------
# Cross-attention (whisper's decoder)
# ---------------------------------------------------------------------------
def cross_init(cfg: ArchConfig, dtype: torch.dtype, *, generator: torch.Generator,
               device) -> dict:
    return gqa_init(cfg, dtype, generator=generator, device=device)


def cross_kv(p: dict, enc_out: torch.Tensor, cfg: ArchConfig):
    """(k, v) (B,Senc,Hkv,hd) of the encoder's output (B,Senc,D), whole on
    every rank.  Under tensor parallelism ``_project_heads``: this rank's
    block of the rows as ``cache_shardings`` places ``cross_k`` and
    ``cross_v`` (its kv heads where they divide the model axis, else every
    head: the weights sit on D and the partial sums are reduced)."""
    k, v = _project_heads(p, enc_out, ("wk", "wv"), cfg)
    return k, v


def cross_forward(p: dict, x: torch.Tensor, enc_kv: tuple, cfg: ArchConfig) -> torch.Tensor:
    """x (B,S,D) attends every encoder row (non-causal flash attention);
    enc_kv = ``cross_kv`` of the encoder's output.  Under tensor
    parallelism q is on this rank's heads (``_project_heads``), the kernel
    runs on them over the kv heads they read (``_local_kv``) and
    ``_out_proj`` makes the output whole."""
    q, = _project_heads(p, x, ("wq",), cfg)
    k, v = _local_kv(q, *enc_kv, cfg)
    o = ops.flash_attention(q, k, v, causal=False, use_kernel=cfg.use_kernels)
    return _out_proj(p, o, cfg, cfg.head_dim)


def cross_decode(p: dict, x: torch.Tensor, enc_kv: tuple, cfg: ArchConfig) -> torch.Tensor:
    """One token a row, x (B,1,D), over the cached encoder rows: decode
    attention with every row's length the full ``k.shape[1]``.  Reads the
    rows in place, never writes them.  Under tensor parallelism as
    ``cross_forward``, over this rank's block of the cached rows."""
    q, = _project_heads(p, x, ("wq",), cfg)
    k, v = _local_kv(q, *enc_kv, cfg)
    lens = torch.full((x.shape[0],), k.shape[1], dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q[:, 0], k, v, lens, use_kernel=cfg.use_kernels)
    return _out_proj(p, o[:, None], cfg, cfg.head_dim)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): low-rank compressed KV + decoupled RoPE
# ---------------------------------------------------------------------------
def mla_init(cfg: ArchConfig, dtype: torch.dtype, *, generator: torch.Generator,
             device) -> dict:
    d, hq = cfg.d_model, cfg.n_heads
    r, dr, dn, dv = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {"w_uq": dense_init((d, hq, dn), fan_in=d, **kw),
            "w_qr": dense_init((d, hq, dr), fan_in=d, **kw),
            "w_dkv": dense_init((d, r + dr), fan_in=d, **kw),
            "w_uk": dense_init((r, hq, dn), fan_in=r, **kw),
            "w_uv": dense_init((r, hq, dv), fan_in=r, **kw),
            "wo": dense_init((hq, dv, d), fan_in=hq * dv, **kw)}


def _mla_scale(cfg: ArchConfig) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def _mla_compress(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """(c_kv (B,S,r), roped k_rope (B,S,dr)) of x (B,S,D)."""
    r = cfg.kv_lora_rank
    c = x @ p["w_dkv"]
    k_rope = apply_rope(c[..., None, r:], positions, cfg.rope_theta)[:, :, 0]
    return c[..., :r], k_rope


def _mla_queries(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """(q_nope (B,S,H,dn), roped q_rope (B,S,H,dr)); under tensor
    parallelism ``_split_mla_queries``."""
    if msh.model_ways() > 1:
        return _split_mla_queries(p, x, positions, cfg)
    q_nope = torch.einsum("bsd,dhk->bshk", x, p["w_uq"])
    q_rope = apply_rope(torch.einsum("bsd,dhk->bshk", x, p["w_qr"]), positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def mla_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                *, return_cache: bool = False):
    """Prefill / training: decompress to MHA at qk head dim dn + dr and run
    flash attention.  The kernel path zero-pads v from dv to that width
    (the kernel takes one head dim), passes the qk dim's scale and cuts
    the output back to dv; the plain path attends with v at its own width
    (through ``ops.flash_chunked`` under ``cfg.fused_attention``).
    With ``return_cache`` also the compressed rows {c_kv, k_rope}."""
    c_kv, k_rope = _mla_compress(p, x, positions, cfg)
    if msh.model_ways() == 1:
        q_nope, q_rope = _mla_queries(p, x, positions, cfg)
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
        v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"])
        kr = k_rope
    else:
        q_nope, q_rope, k_nope, v, kr = _split_mla(p, x, c_kv, k_rope, positions, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand_as(q_rope)], dim=-1)
    dqk, dv = q.shape[-1], v.shape[-1]
    if cfg.use_kernels:
        v_p = F.pad(v, (0, dqk - dv)) if dv < dqk else v
        o = ops.flash_attention(q, k, v_p, causal=True, scale=_mla_scale(cfg),
                                use_kernel=True)[..., :dv]
    else:
        o = ops.flash_attention(q, k, v, causal=True, use_kernel=False,
                                chunked=cfg.fused_attention, chunk_k=cfg.attn_chunk)
    out = _out_proj(p, o, cfg, dv)
    return (out, {"c_kv": c_kv, "k_rope": k_rope}) if return_cache else out


def _split_mla(p: dict, x: torch.Tensor, c_kv: torch.Tensor, k_rope: torch.Tensor,
               positions: torch.Tensor, cfg: ArchConfig):
    """MLA's queries and decompression under tensor parallelism: (q_nope,
    roped q_rope, k_nope, v, the k_rope to attend with).  ``c_kv`` and
    ``k_rope`` are whole (``w_dkv`` is replicated).  x and ``c_kv`` each go
    through one ``copy``, each product runs on this rank's block of its
    weight, and each output is constrained as the reference constrains q
    (heads over the model axis where they divide it, else whole): a block
    split on D (``w_uq``, ``w_qr``) or on r (``w_uk``, ``w_uv``) gives a
    partial sum, reduced before the rotation and the concatenation.  On
    this rank's heads k_rope, shared by every head, goes through ``copy``
    too; with every head on every rank it stays as it is."""
    h, r, dn, dv = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.v_head_dim
    q_nope, q_rope = _split_mla_queries(p, x, positions, cfg)
    cc = msh.copy(c_kv)
    k_nope = _heads(p, "bsr,rhk->bshk", cc, "w_uk", (r, h, dn))
    v = _heads(p, "bsr,rhk->bshk", cc, "w_uv", (r, h, dv))
    return q_nope, q_rope, k_nope, v, msh.copy(k_rope) if q_nope.shape[2] < h else k_rope


def _heads(p: dict, eq: str, t: torch.Tensor, name: str, whole: tuple) -> torch.Tensor:
    """``eq`` of a whole ``t`` (through ``copy``) and this rank's block of
    ``p[name]``, constrained as the reference constrains q: heads over the
    model axis where they divide it, else whole (a partial sum reduced, a
    split gathered)."""
    y, layout = msh.project(eq, t, msh.WHOLE, p[name], whole)
    return msh.constrain(y, "batch", None, "model", layout=layout)


def _split_mla_queries(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig):
    """(q_nope, roped q_rope) under tensor parallelism: x goes through one
    ``copy``; on this rank's heads, or whole where the heads do not divide
    the model axis (``w_uq`` and ``w_qr`` split on D give partial sums,
    reduced before the rotation)."""
    d, h, dr, dn = cfg.d_model, cfg.n_heads, cfg.qk_rope_dim, cfg.qk_nope_dim
    xc = msh.copy(x)
    q_nope = _heads(p, "bsd,dhk->bshk", xc, "w_uq", (d, h, dn))
    q_rope = apply_rope(_heads(p, "bsd,dhk->bshk", xc, "w_qr", (d, h, dr)), positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_absorbed(p: dict, x: torch.Tensor, q_nope: torch.Tensor, q_rope: torch.Tensor,
                  c_kv: torch.Tensor, k_rope: torch.Tensor, valid: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """Absorbed-form attention of C queries a row over the compressed cache:
    q_nope (B,C,H,dn), q_rope (B,C,H,dr), c_kv (B,S,r), k_rope (B,S,dr),
    valid (B,C,S) -> (B,C,D).  Scores and the weighted sum of c_kv take
    their operands in the cache's dtype and accumulate in fp32 (the
    reference's ``preferred_element_type=f32``; a bf16 product would round
    the scores).  Under tensor parallelism q_nope and q_rope hold this
    rank's heads (or every head, ``_split_mla_queries``), the compressed
    rows are whole on every rank (``cache_shardings`` replicates them), the
    absorptions run on the rank's blocks of ``w_uk`` and ``w_uv``
    (``_split_absorb``) and ``_out_proj`` makes the output whole."""
    q_abs = _split_absorb(p, q_nope, "bqhk,rhk->bqhr", "w_uk",
                          (cfg.kv_lora_rank, cfg.n_heads, cfg.qk_nope_dim))
    logits = (torch.einsum("bqhr,bsr->bqhs", q_abs.to(c_kv.dtype).float(), c_kv.float())
              + torch.einsum("bqhk,bsk->bqhs", q_rope.to(k_rope.dtype).float(),
                             k_rope.float())) * _mla_scale(cfg)
    logits = torch.where(valid[:, :, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o_c = torch.einsum("bqhs,bsr->bqhr", probs.to(c_kv.dtype).float(), c_kv.float())
    o = _split_absorb(p, o_c.to(x.dtype), "bqhr,rhk->bqhk", "w_uv",
                      (cfg.kv_lora_rank, cfg.n_heads, cfg.v_head_dim))
    return _out_proj(p, o, cfg, cfg.v_head_dim)


def _split_absorb(p: dict, t: torch.Tensor, eq: str, name: str, whole: tuple) -> torch.Tensor:
    """``eq`` of t (B,C,h,.) on this rank's heads (h < H) or every head, and
    this rank's block of ``p[name]`` (``w_uk`` or ``w_uv``, (r,H,.)): on the
    rank's heads where they divide the model axis, the product's heads the
    rank's; else the weight split on r or on its last dim, and the product
    (a partial sum over r, or split on its last dim) made whole before it
    goes on: q_abs reduced before the scores, o before ``wo``.  With no
    mesh, the plain einsum."""
    split = t.shape[2] < whole[1]
    y, layout = msh.project(eq, t if split else msh.copy(t), msh.Layout(2) if split
                            else msh.WHOLE, p[name], whole)
    return msh.constrain(y, "batch", None, "model", None, layout=layout)


def mla_decode(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
               cfg: ArchConfig):
    """One-token absorbed-form decode.  x (B,1,D); cache {c_kv (B,S,r),
    k_rope (B,S,dr)} written in place at row ``positions`` (B,); keys
    0..positions.  Returns (out (B,1,D), cache)."""
    b = x.shape[0]
    pos_seq = positions[:, None]
    c_new, krope_new = _mla_compress(p, x, pos_seq, cfg)
    bidx, rows = torch.arange(b, device=x.device), positions.long()
    cache["c_kv"][bidx, rows] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][bidx, rows] = krope_new[:, 0].to(cache["k_rope"].dtype)
    q_nope, q_rope = _mla_queries(p, x, pos_seq, cfg)
    keys = torch.arange(cache["c_kv"].shape[1], device=x.device)
    valid = keys[None, None, :] <= pos_seq[:, :, None]
    return _mla_absorbed(p, x, q_nope, q_rope, cache["c_kv"], cache["k_rope"], valid,
                         cfg), cache


def mla_prefill(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
                cfg: ArchConfig):
    """Chunked prefill in the absorbed form: C prompt tokens a row written
    into the compressed cache in place, then every query over it with the
    decode path's masked softmax.  x (B,C,D); positions (B,C) absolute,
    contiguous ascending.  Returns (out (B,C,D), cache)."""
    c_new, krope_new = _mla_compress(p, x, positions, cfg)
    b2, pos = torch.arange(x.shape[0], device=x.device)[:, None], positions.long()
    cache["c_kv"][b2, pos] = c_new.to(cache["c_kv"].dtype)
    cache["k_rope"][b2, pos] = krope_new.to(cache["k_rope"].dtype)
    q_nope, q_rope = _mla_queries(p, x, positions, cfg)
    keys = torch.arange(cache["c_kv"].shape[1], device=x.device)
    valid = keys[None, None, :] <= pos[:, :, None]
    return _mla_absorbed(p, x, q_nope, q_rope, cache["c_kv"], cache["k_rope"], valid,
                         cfg), cache


def mla_decode_stacked(p: dict, x: torch.Tensor, stacked: dict, g: int,
                       positions: torch.Tensor, cfg: ArchConfig):
    """``mla_decode`` writing into group ``g`` of the layer-stacked
    compressed cache {c_kv (G,B,S,r), k_rope (G,B,S,dr)}, in place."""
    out, _ = mla_decode(p, x, {name: t[g] for name, t in stacked.items()}, positions, cfg)
    return out, stacked


def mla_cache_shape(cfg: ArchConfig, batch: int, length: int) -> dict:
    return {"c_kv": (batch, length, cfg.kv_lora_rank),
            "k_rope": (batch, length, cfg.qk_rope_dim)}
