"""Decoder-only language model: counterpart of ``repro.models.lm`` for the
dense GQA archs, the MoE ones (granite-moe; deepseek-v2 with MLA and a
dense first layer) and the SSM family (xlstm; zamba2 with its weight-tied
shared attention + MLP block after each group).

Entry points, as in the reference:
  init_params(cfg, ...)                          -> params tree
  forward(params, cfg, batch, collect_cache)     -> (logits, aux, cache|None)
  decode_step(params, cfg, tokens, positions, cache) -> (logits, cache)
  prefill_chunk(params, cfg, tokens, positions, cache) -> (logits, cache)
  init_cache(cfg, batch, length, ...)            -> zeroed decode cache

Parameters and caches are nested dicts of tensors with the reference's key
paths; every ``phase*`` leaf carries the stacked ``n_groups`` dim, and where
the reference runs ``lax.scan`` over it the port loops over the group index.
Serving holds the parameters in the compute dtype from load on.  Training
holds fp32 masters (``init_params(..., dtype=cfg.param_dtype)``) and
``forward`` casts the tree's floating leaves to the compute dtype once at
entry, as the reference's ``nn.cast_tree`` does on every call; for a tree
already in the compute dtype the cast returns the same tensors.  With
``cfg.remat`` each group's body runs under ``torch.utils.checkpoint`` when
gradients are recorded (the reference's ``jax.checkpoint`` around its
scanned group).  ``decode_step`` and ``prefill_chunk`` update the cache in place.
The shared block's per-group KV caches sit under ``phase*/shared``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import blocks
from .modules import dense_init, require_device


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.use_mrope or not cfg.use_rope:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE and rope-less archs are not ported yet "
            "(ROADMAP.md queue 1 item 1.9)")
    blocks.build_plan(cfg)


def _at(tree: dict, g: int) -> dict:
    """Group ``g`` of a stacked tree (views, no copy)."""
    return {k: (_at(v, g) if isinstance(v, dict) else v[g]) for k, v in tree.items()}


def _stack(n: int, make: Callable[[int], dict]) -> dict:
    """Stack ``make(0..n-1)`` on a new leading dim, one group at a time (a
    full-width layer stack never exists twice in memory)."""
    def alloc(t):
        return {k: alloc(v) for k, v in t.items()} if isinstance(t, dict) else \
            torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)

    def put(dst, src, g):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, g)
            else:
                dst[k][g].copy_(v)

    first = make(0)
    out = alloc(first)
    put(out, first, 0)
    for g in range(1, n):
        put(out, make(g), g)
    return out


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                dtype: torch.dtype | None = None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``, in
    ``dtype`` (default: the compute dtype, for serving; training passes
    ``cfg.param_dtype``'s fp32 masters).  Tied embeddings (gemma3) have no
    ``lm_head``: the head reads ``embed``.  A MoE router is fp32 whatever
    ``dtype`` is, as the reference initialises it (``moe.router_logits``
    rounds it to the compute dtype, as the reference's ``cast_tree`` does)."""
    _check_supported(cfg)
    dev = require_device(device)
    dtype = dtype or cfg.compute_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=gen, device=dev)
    p: dict = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model,
                            dtype=dtype, **kw),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), fan_in=cfg.d_model,
                                  dtype=dtype, **kw)
    for pi, phase in enumerate(blocks.build_plan(cfg)):
        p[f"phase{pi}"] = _stack(phase.n_groups, lambda g, phase=phase: {
            f"slot{j}": blocks.slot_init(cfg, kind, ffn, dtype, **kw)
            for j, (kind, ffn) in enumerate(zip(phase.kinds, phase.ffns))})
    if cfg.family == "hybrid":          # zamba2's tied shared attention + MLP block
        p["shared"] = blocks.slot_init(cfg, "global", "mlp", dtype, **kw)
    return p


def init_cache(cfg: ArchConfig, batch: int, length: int, *, device="cuda") -> dict:
    """Zeroed decode caches (structure mirrors forward(collect_cache)): KV and
    MLA's compressed rows in the compute dtype, recurrent states in fp32."""
    dev = require_device(device)

    def zeros(n: int, shapes: dict, dtype) -> dict:
        return {k: torch.zeros((n,) + shp, dtype=dtype, device=dev) for k, shp in shapes.items()}

    cache: dict = {}
    for pi, phase in enumerate(blocks.build_plan(cfg)):
        pc = {f"slot{j}": zeros(phase.n_groups,
                                blocks.slot_cache_shape(cfg, kind, batch, length),
                                blocks.cache_dtypes(kind, cfg.compute_dtype))
              for j, kind in enumerate(phase.kinds)}
        if phase.shared_attn:
            kind = "local" if _shared_window(cfg, length) else "global"
            pc["shared"] = zeros(phase.n_groups,
                                 blocks.slot_cache_shape(cfg, kind, batch, length),
                                 cfg.compute_dtype)
        cache[f"phase{pi}"] = pc
    return cache


def _shared_window(cfg: ArchConfig, cache_len: int) -> int:
    """zamba2's long-context adaptation: the tied attention block is windowed
    when the decode budget exceeds 64k (the reference's ``lm.py:187-192``)."""
    if cfg.family == "hybrid" and cache_len and cache_len > 65536:
        return cfg.sliding_window
    return 0


def _shared_kind(cfg: ArchConfig, shared_cache: dict) -> str:
    """Decode and chunked prefill window the shared block iff its cache is
    no longer than the window, as the reference decides (``lm.py:264-268``)."""
    return "local" if shared_cache["k"].shape[1] <= cfg.sliding_window else "global"


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------
def _embed(params: dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table; with ``scale_embed`` times sqrt(d_model) rounded to
    the compute dtype first, as the reference's ``jnp.asarray(d ** 0.5,
    dtype)`` is (bf16: 50.596 -> 50.5).  A Python float factor would take
    the product in fp32 and round once, parting from the reference.  The
    0-d factor stays on the host: torch passes it to a CUDA kernel as a
    scalar, with no copy to the card per call."""
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head; tied: ``x @ embed.T`` (the reference's
    ``"...d,vd->...v"``) through a transposed view, no copy of the table."""
    x = blocks.norm(x, params["final_norm"], cfg)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["lm_head"].to(x.dtype)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def forward(params: dict, cfg: ArchConfig, batch: dict, *, collect_cache: bool = False,
            cache_len: int = 0):
    """batch {"tokens": (B,S)} -> (logits (B,S,V), aux, cache or None).

    ``aux`` is the MoE load-balance loss summed over every MoE slot (the
    reference's scan carry), an fp32 zero for archs without one.

    With ``collect_cache`` the KV caches come back placed as the reference's
    ``_pad_cache`` places them, so decode can continue from the prefill:
    global slots padded with zeros to ``max(cache_len, S)`` rows; windowed
    ones (``local`` layers, zamba2's shared block past a 64k budget) as a
    ring of ``min(window, cache_len)`` rows holding the last positions at
    slots ``p % size`` (S rows, unplaced, when ``cache_len`` is 0)."""
    params = _cast_tree(params, cfg.compute_dtype)       # mixed precision
    shared = "local" if _shared_window(cfg, cache_len) else "global"
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    x = _embed(params, cfg, tokens)
    cache: dict | None = {} if collect_cache else None
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for pi, phase in enumerate(blocks.build_plan(cfg)):
        pcache: dict = {}
        for g in range(phase.n_groups):
            gp = _at(params[f"phase{pi}"], g)

            def group(x, a, gp=gp, phase=phase, g=g, pcache=pcache):
                for j, (kind, ffn) in enumerate(zip(phase.kinds, phase.ffns)):
                    x, c, aj = blocks.slot_forward(gp[f"slot{j}"], x, positions, cfg, kind,
                                                   ffn, collect_cache=collect_cache)
                    if collect_cache:
                        _put(pcache, f"slot{j}", g, phase.n_groups, c, kind, cache_len, cfg)
                    if aj is not None:
                        a = a + aj
                if phase.shared_attn:
                    x, c, _ = blocks.slot_forward(params["shared"], x, positions, cfg, shared,
                                                  "mlp", collect_cache=collect_cache)
                    if collect_cache:
                        _put(pcache, "shared", g, phase.n_groups, c, shared, cache_len, cfg)
                return x, a

            x, aux = checkpoint(group, x, aux, use_reentrant=False) if remat else group(x, aux)
        if collect_cache:
            cache[f"phase{pi}"] = pcache
    return _head(params, cfg, x), aux, cache


def _cast_tree(tree: dict, dtype: torch.dtype) -> dict:
    """Floating leaves to ``dtype`` (``.to`` returns a leaf already in it
    unchanged); integer leaves as they are."""
    return {k: (_cast_tree(v, dtype) if isinstance(v, dict)
                else v.to(dtype) if v.is_floating_point() else v) for k, v in tree.items()}


def _put(pcache: dict, name: str, g: int, n_groups: int, c: dict, kind: str,
         cache_len: int, cfg: ArchConfig) -> None:
    """Write slot ``c``'s prefill output into group ``g`` of its stacked
    cache ``pcache[name]``, allocated (zeroed) at the first group: K/V rows
    and MLA's compressed rows (``c_kv``, ``k_rope``) placed as the
    reference's ``_pad_cache`` places them (see ``forward``), recurrent
    states whole."""
    window = blocks.window_of(cfg, kind)
    s = next(iter(c.values())).shape[1] if kind in blocks.CACHE_KINDS else 0
    rows = (min(window, cache_len) if window else max(cache_len, s)) if cache_len else s
    if name not in pcache:
        def shape(t):
            return (n_groups, t.shape[0], rows) + tuple(t.shape[2:]) if s else \
                (n_groups,) + tuple(t.shape)
        dtype = blocks.cache_dtypes(kind, cfg.compute_dtype)
        pcache[name] = {k: torch.zeros(shape(t), dtype=dtype, device=t.device)
                        for k, t in c.items()}
    for k, t in c.items():
        dst = pcache[name][k][g]
        if not s:
            dst.copy_(t)
        elif window and s >= rows:        # the last ``rows`` positions at their ring slots
            dst[:, torch.arange(s - rows, s, device=t.device) % rows] = t[:, s - rows:]
        else:
            dst[:, :s] = t


# ---------------------------------------------------------------------------
# Decode and chunked prefill
# ---------------------------------------------------------------------------
def _run_cached(params: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                cache: dict, slot_fn) -> torch.Tensor:
    for pi, phase in enumerate(blocks.build_plan(cfg)):
        pcache = cache[f"phase{pi}"]
        for g in range(phase.n_groups):
            gp, gc = _at(params[f"phase{pi}"], g), _at(pcache, g)
            for j, (kind, ffn) in enumerate(zip(phase.kinds, phase.ffns)):
                x, _ = slot_fn(gp[f"slot{j}"], x, gc[f"slot{j}"], positions, cfg, kind, ffn)
            if phase.shared_attn:
                x, _ = slot_fn(params["shared"], x, gc["shared"], positions, cfg,
                               _shared_kind(cfg, gc["shared"]), "mlp")
    return x


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache: dict):
    """tokens (B,1); positions (B,) absolute position of the new token.
    Returns (logits (B,V), cache) with the cache updated in place."""
    x = _run_cached(params, cfg, _embed(params, cfg, tokens), positions, cache,
                    blocks.slot_decode)
    return _head(params, cfg, x[:, 0]), cache


def prefill_chunk(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, cache: dict):
    """C prompt tokens at once against the decode cache: tokens (B,C);
    positions (B,C) absolute, contiguous ascending per row.  Returns
    (logits (B,C,V), cache) with the cache updated in place."""
    x = _run_cached(params, cfg, _embed(params, cfg, tokens), positions, cache,
                    blocks.slot_prefill)
    return _head(params, cfg, x), cache
