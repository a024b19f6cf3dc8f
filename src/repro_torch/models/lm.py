"""Language models: counterpart of ``repro.models.lm`` for every arch of the
reference: the dense GQA archs, the MoE ones (granite-moe; deepseek-v2 with
MLA and a dense first layer), the SSM family (xlstm; zamba2 with its
weight-tied shared attention + MLP block after each group), whisper's
encoder-decoder and qwen2-vl.

``batch`` holds ``tokens`` (B,S) and, by family, the frontends' stubs, as
in the reference: ``frames`` (B,encoder_len,D) for audio, whose encoder
(``p["encoder"]``, ``encoder_layers`` stacked global/MLP slots) runs
non-causal attention over them after a sinusoid; ``vision_embeds``
(B,n_vis,D), which overwrite the first n_vis embedded rows, and
``mrope_positions`` (B,3,S) for M-RoPE archs.  Whisper's decoder slots
carry a cross sub-layer; a prefill stores each slot's projected encoder
rows as ``cross_k``/``cross_v`` beside its K/V (and the top-level
``enc_len``), and decode reads them and never writes them.

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
scanned group), bound to the active mesh and profile so that the rerun in
the backward shards as the forward did.  ``decode_step`` and
``prefill_chunk`` update the cache in place.  The shared block's per-group
KV caches sit under ``phase*/shared``.

Under tensor parallelism (an active mesh with a model axis, ``tp``
profile: ``models/sharding``) each leaf is this rank's block under its
fitted spec; the embedding and the head run on their blocks (``_lookup``,
``_head``), the residual stream stays whole on every rank, and ``forward``
returns this rank's block of the vocabulary where the head is split on V.
``constrain`` stands where the reference's does; with no mesh it returns
its input.  The serving entry points run there too: ``init_cache`` gives
the rank's block of the cache, ``forward(collect_cache=True)`` caches the
rank's k and v blocks, its blocks of the recurrent states and whisper's
cross rows (``attention.cross_kv``: the rank's heads of the encoder's
whole output), and ``decode_step`` and ``prefill_chunk`` return logits
whole over the vocabulary (``whole_vocab``).  A family outside
``sharding.TP_FAMILIES`` (one named nowhere) raises under a model axis
larger than 1 (``sharding.refuse_outside_tp``).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import attention as attn
from . import blocks
from . import sharding as msh
from .modules import dense_init, require_device


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions (B,S) -> (B,S,D) fp32, the classic transformer sinusoid:
    sin then cos of ``p * exp(-i log(10000) / (D/2 - 1))``.  The step and
    each exponent are fp32, as the reference's are; the exponential is taken
    in fp64 and rounded, so each frequency is the correctly rounded one
    (fp32 ``exp`` implementations differ from it by an ulp here and there,
    which moves the angle at position p by up to p ulps of the frequency)."""
    half = d // 2
    step = (torch.tensor(math.log(10000.0), dtype=torch.float32) / max(half - 1, 1)).item()
    expo = -torch.arange(half, dtype=torch.float32, device=positions.device) * step
    freqs = torch.exp(expo.double()).float()
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
    rounds it to the compute dtype, as the reference's ``cast_tree`` does).
    Whisper's decoder slots carry ``norm_x`` and ``cross``; its encoder is
    ``p["encoder"]``, ``encoder_layers`` global/MLP slots stacked.  On
    ``meta`` (the dry-run's device, which has no generator) the tree holds
    shapes and dtypes only, and nothing is allocated."""
    plan = blocks.build_plan(cfg)
    dev = require_device(device)
    dtype = dtype or cfg.compute_dtype
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=gen, device=dev)
    p: dict = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model,
                            dtype=dtype, **kw),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), fan_in=cfg.d_model,
                                  dtype=dtype, **kw)
    cross = cfg.family == "audio"
    for pi, phase in enumerate(plan):
        p[f"phase{pi}"] = _stack(phase.n_groups, lambda g, phase=phase: {
            f"slot{j}": blocks.slot_init(cfg, kind, ffn, dtype, cross=cross, **kw)
            for j, (kind, ffn) in enumerate(zip(phase.kinds, phase.ffns))})
    if cfg.family == "hybrid":          # zamba2's tied shared attention + MLP block
        p["shared"] = blocks.slot_init(cfg, "global", "mlp", dtype, **kw)
    if cfg.family == "audio":           # whisper's encoder stack
        p["encoder"] = _stack(cfg.encoder_layers,
                              lambda g: blocks.slot_init(cfg, "global", "mlp", dtype, **kw))
    return p


def init_cache(cfg: ArchConfig, batch: int, length: int, *, device="cuda") -> dict:
    """Zeroed decode caches (structure mirrors forward(collect_cache)): KV and
    MLA's compressed rows in the compute dtype, recurrent states in fp32;
    audio adds each slot's ``cross_k``/``cross_v`` of ``encoder_len`` rows
    and the top-level ``enc_len`` (B,) int32.  On ``meta``, shapes and
    dtypes only.  Under an active mesh, this rank's block of the cache of
    ``batch`` rows: each leaf's shape under
    ``sharding.cache_shardings`` (its rows of the batch, its kv
    heads where they divide the model axis)."""
    dev = require_device(device)
    mesh = msh.current_mesh()
    if mesh is not None:
        with msh.use_mesh(None):
            whole = init_cache(cfg, batch, length, device="meta")

        def block(t, spec):
            if isinstance(t, dict):
                return {k: block(v, spec[k]) for k, v in t.items()}
            return torch.zeros(msh.local_slice(t, spec, mesh).shape, dtype=t.dtype, device=dev)
        return block(whole, msh.cache_shardings(whole, mesh))

    def zeros(n: int, shapes: dict, dtype) -> dict:
        return {k: torch.zeros((n,) + shp, dtype=dtype, device=dev) for k, shp in shapes.items()}

    cross = {}
    if cfg.family == "audio":
        rows = (batch, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim)
        cross = {"cross_k": rows, "cross_v": rows}
    cache: dict = {}
    for pi, phase in enumerate(blocks.build_plan(cfg)):
        pc = {f"slot{j}": {**zeros(phase.n_groups,
                                   blocks.slot_cache_shape(cfg, kind, batch, length),
                                   blocks.cache_dtypes(kind, cfg.compute_dtype)),
                           **zeros(phase.n_groups, cross, cfg.compute_dtype)}
              for j, kind in enumerate(phase.kinds)}
        if phase.shared_attn:
            kind = "local" if _shared_window(cfg, length) else "global"
            pc["shared"] = zeros(phase.n_groups,
                                 blocks.slot_cache_shape(cfg, kind, batch, length),
                                 cfg.compute_dtype)
        cache[f"phase{pi}"] = pc
    if cfg.family == "audio":
        cache["enc_len"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
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
    x = _lookup(params["embed"], tokens, cfg).to(cfg.compute_dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _lookup(table: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Rows of the embedding table.  Under tensor parallelism from this
    rank's block: split on V, a lookup of the ids the block holds (zeros
    elsewhere), then ``reduce``; split on D, a lookup, then ``gather``."""
    ids = tokens.long()
    dim = msh.weight_split(table, (cfg.vocab_size, cfg.d_model)) if msh.model_ways() > 1 else None
    if dim is None:
        return table[ids]
    if dim == 1:
        return msh.gather(table[ids], -1)
    n = table.shape[0]
    local = ids - msh.model_index() * n
    rows = table[local.clamp(0, n - 1)]
    own = ((local >= 0) & (local < n))[..., None]
    return msh.reduce(torch.where(own, rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device)))


def _head(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head; tied: ``x @ embed.T`` (the reference's
    ``"...d,vd->...v"``) through a transposed view, no copy of the table.
    Under tensor parallelism the head takes this rank's block: split on V
    it gives this rank's block of the vocabulary (``steps.loss_fn`` reads
    it so), split on D a partial sum, reduced to the whole logits."""
    x = blocks.norm(x, params["final_norm"], cfg)
    if msh.model_ways() == 1:
        if cfg.tie_embeddings:
            return x @ params["embed"].to(x.dtype).T
        return x @ params["lm_head"].to(x.dtype)
    x, v, d = msh.copy(x), cfg.vocab_size, cfg.d_model
    if cfg.tie_embeddings:
        logits, layout = msh.project("...d,vd->...v", x, msh.WHOLE, params["embed"].to(x.dtype),
                                     (v, d), op=lambda a, b: a @ b.T)
    else:
        logits, layout = msh.project("...d,dv->...v", x, msh.WHOLE,
                                     params["lm_head"].to(x.dtype), (d, v), op=torch.matmul)
    return msh.reduce(logits) if layout.partial else logits


def whole_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits over the whole vocabulary on every rank of the model group:
    a head split on V gives each rank its block (``_head``), gathered
    here, as the reference's serving steps hand back whole logits at their
    jit boundary; whole logits as they are."""
    return msh.gather(logits, -1) if logits.shape[-1] < cfg.vocab_size else logits


def _arange(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _encoder(params: dict, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over the frame embeddings (the conv/mel frontend is
    a stub, as in the reference): a sinusoid, then per layer non-causal
    attention and the MLP, pre-norm residual.  Under tensor parallelism
    each layer runs on the rank's heads and columns, and the output is
    whole on every rank; its gradient sums every decoder layer's part
    (each ``cross_kv`` passes it through ``copy``)."""
    x = frames.to(cfg.compute_dtype)
    pos = _arange(x.shape[0], x.shape[1], x.device)
    x = x + sinusoid(pos, cfg.d_model).to(x.dtype)
    enc = params["encoder"]
    for g in range(enc["norm1"].shape[0]):
        gp = _at(enc, g)
        x = x + attn.gqa_forward(gp["mixer"], blocks.norm(x, gp["norm1"], cfg), pos, cfg,
                                 causal=False)
        x = x + blocks.mlp_forward(gp["ffn"], blocks.norm(x, gp["norm2"], cfg), cfg)
    return x


def _positions_for(cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """(B,3,S) ``mrope_positions`` under M-RoPE, else 0..S-1 a row."""
    if cfg.use_mrope:
        return batch["mrope_positions"]
    b, s = batch["tokens"].shape
    return _arange(b, s, batch["tokens"].device)


def _inputs(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The embedded tokens; a VLM's first n_vis rows replaced by
    ``vision_embeds``; audio's plus the sinusoid of 0..S-1."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm" and "vision_embeds" in batch:
        vis = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([vis, x[:, vis.shape[1]:]], dim=1)
    if cfg.family == "audio":
        b, s = batch["tokens"].shape
        x = x + sinusoid(_arange(b, s, x.device), cfg.d_model).to(x.dtype)
    return msh.constrain(x, "batch", None, None)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def forward(params: dict, cfg: ArchConfig, batch: dict, *, collect_cache: bool = False,
            cache_len: int = 0):
    """batch {"tokens": (B,S), and the family's stubs (module docstring)}
    -> (logits (B,S,V), aux, cache or None).

    ``aux`` is the MoE load-balance loss summed over every MoE slot (the
    reference's scan carry), an fp32 zero for archs without one.

    With ``collect_cache`` the KV caches come back placed as the reference's
    ``_pad_cache`` places them, so decode can continue from the prefill:
    global slots padded with zeros to ``max(cache_len, S)`` rows; windowed
    ones (``local`` layers, zamba2's shared block past a 64k budget) as a
    ring of ``min(window, cache_len)`` rows holding the last positions at
    slots ``p % size`` (S rows, unplaced, when ``cache_len`` is 0).  Audio:
    each decoder slot's ``cross_k``/``cross_v`` (the encoder's rows,
    unpadded) beside them, and ``enc_len``."""
    msh.refuse_outside_tp(cfg, "lm.forward")
    params = _cast_tree(params, cfg.compute_dtype)       # mixed precision
    shared = "local" if _shared_window(cfg, cache_len) else "global"
    tokens = batch["tokens"]
    positions = _positions_for(cfg, batch)
    x = _inputs(params, cfg, batch)
    enc_out = _encoder(params, cfg, batch["frames"]) if cfg.family == "audio" else None
    cache: dict | None = {} if collect_cache else None
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for pi, phase in enumerate(blocks.build_plan(cfg)):
        pcache: dict = {}
        for g in range(phase.n_groups):
            gp = _at(params[f"phase{pi}"], g)

            def group(x, a, gp=gp, phase=phase, g=g, pcache=pcache):
                for j, (kind, ffn) in enumerate(zip(phase.kinds, phase.ffns)):
                    sp = gp[f"slot{j}"]
                    enc_kv = None if enc_out is None else attn.cross_kv(sp["cross"], enc_out, cfg)
                    x, c, aj = blocks.slot_forward(sp, x, positions, cfg, kind, ffn,
                                                   collect_cache=collect_cache, enc_kv=enc_kv)
                    if collect_cache:
                        _put(pcache, f"slot{j}", g, phase.n_groups, c, kind, cache_len, cfg)
                        if enc_kv is not None:
                            _put_rows(pcache[f"slot{j}"], g, phase.n_groups,
                                      {"cross_k": enc_kv[0], "cross_v": enc_kv[1]})
                    if aj is not None:
                        a = a + aj
                if phase.shared_attn:
                    x, c, _ = blocks.slot_forward(params["shared"], x, positions, cfg, shared,
                                                  "mlp", collect_cache=collect_cache)
                    if collect_cache:
                        _put(pcache, "shared", g, phase.n_groups, c, shared, cache_len, cfg)
                return msh.constrain(x, "batch", None, None), a

            x, aux = (checkpoint(msh.bind_active(group), x, aux, use_reentrant=False) if remat
                      else group(x, aux))
        if collect_cache:
            cache[f"phase{pi}"] = pcache
    if collect_cache and enc_out is not None:
        cache["enc_len"] = torch.full((x.shape[0],), enc_out.shape[1], dtype=torch.int32,
                                      device=x.device)
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


def _put_rows(slot_cache: dict, g: int, n_groups: int, rows: dict) -> None:
    """Write ``rows`` (whisper's projected encoder rows, unpadded) into group
    ``g`` of the slot's stacked cache, allocated at the first group."""
    for k, t in rows.items():
        if k not in slot_cache:
            slot_cache[k] = torch.zeros((n_groups,) + tuple(t.shape), dtype=t.dtype,
                                        device=t.device)
        slot_cache[k][g].copy_(t)


# ---------------------------------------------------------------------------
# Decode and chunked prefill
# ---------------------------------------------------------------------------
def _run_cached(params: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                cache: dict, slot_fn) -> torch.Tensor:
    """Every slot's ``slot_fn`` against its cache; a slot that caches
    encoder rows (whisper's decoder) cross-attends them."""
    for pi, phase in enumerate(blocks.build_plan(cfg)):
        pcache = cache[f"phase{pi}"]
        for g in range(phase.n_groups):
            gp, gc = _at(params[f"phase{pi}"], g), _at(pcache, g)
            for j, (kind, ffn) in enumerate(zip(phase.kinds, phase.ffns)):
                sc = gc[f"slot{j}"]
                kw = {"enc_kv": (sc["cross_k"], sc["cross_v"])} if "cross_k" in sc else {}
                x, _ = slot_fn(gp[f"slot{j}"], x, sc, positions, cfg, kind, ffn, **kw)
            if phase.shared_attn:
                x, _ = slot_fn(params["shared"], x, gc["shared"], positions, cfg,
                               _shared_kind(cfg, gc["shared"]), "mlp")
    return x


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache: dict):
    """tokens (B,1); positions (B,) (or (B,3) under M-RoPE) absolute position
    of the new token; audio adds the sinusoid at that position.  Returns
    (logits (B,V), cache) with the cache updated in place (whisper's cross
    rows and ``enc_len`` read, never written).  Under tensor parallelism
    the cache is this rank's block (``init_cache`` under the mesh) and the
    logits are whole over the vocabulary (``whole_vocab``)."""
    msh.refuse_outside_tp(cfg, "lm.decode_step")
    x = _embed(params, cfg, tokens)
    if cfg.family == "audio":
        x = x + sinusoid(positions[:, None], cfg.d_model).to(x.dtype)
    x = msh.constrain(x, "batch", None, None)
    x = _run_cached(params, cfg, x, positions, cache, blocks.slot_decode)
    return whole_vocab(_head(params, cfg, x[:, 0]), cfg), cache


def prefill_chunk(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, cache: dict):
    """C prompt tokens at once against the decode cache: tokens (B,C);
    positions (B,C) (or (B,3,C) under M-RoPE) absolute, contiguous ascending
    per row.  Returns (logits (B,C,V), whole over the vocabulary, cache)
    with the cache updated in place.  Audio raises, as in the reference:
    its prefill is the encoder's and the full forward's."""
    if cfg.family == "audio":
        raise NotImplementedError("chunked prefill: audio enc-dec unsupported")
    msh.refuse_outside_tp(cfg, "lm.prefill_chunk")
    x = msh.constrain(_embed(params, cfg, tokens), "batch", None, None)
    x = _run_cached(params, cfg, x, positions, cache, blocks.slot_prefill)
    return whole_vocab(_head(params, cfg, x), cfg), cache
