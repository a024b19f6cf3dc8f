"""Block assembly: per-layer "slots" (mixer + ffn) grouped into phases.

Counterpart of ``repro.models.blocks``.  Each layer is
    x = x + mixer(norm1(x));  x = x + ffn(norm2(x))      (ffn optional)
and layers are grouped by the repeating block pattern; a phase's parameters
are stacked on a leading ``n_groups`` dim, as in the reference.  Mixers:
``global`` and ``local`` (sliding-window, ring-buffer cache) GQA, ``mla``
(compressed cache, absorbed-form decode), ``mamba2``, ``mlstm`` and
``slstm``; ffns: ``mlp`` (SwiGLU or a one-matrix activation such as
minitron's squared ReLU), ``moe`` (``models/moe.py``) and ``none``.
deepseek's plan puts a dense ``mlp`` layer 0 in a phase of its own before
the ``moe`` ones (``first_layer_dense``).  zamba2's
weight-tied shared attention + MLP block runs after each group of a
``shared_attn`` phase, windowed when the decode budget exceeds 64k and, in
decode, as a ``local`` one (the ring branches of ``attention``) while its
cache is no longer than the window.  The ``audio`` (whisper) and ``vlm``
(qwen2-vl) families plan as dense ones, as in the reference; whisper's
decoder slots (``cross=True``) add a cross-attention sub-layer between the
mixer and the ffn, ``x + cross(norm_x(x), enc_kv)``.
The norm sites go through ``ops.rmsnorm`` (the kernel when
``cfg.use_kernels``), on the whole residual under tensor parallelism too,
so a norm scale's gradient is whole on every rank.  Decode and chunked
prefill update their cache in place: attention writes its rows, recurrent
mixers their state (the rank's block of it under tensor parallelism).
The MoE ffn routes with capacity in the full-sequence forward and in
decode, and with ``no_drop`` in chunked prefill (so a chunk routes each
token as its decode step would); ``slot_forward`` returns its aux loss.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from . import attention as attn
from . import moe as moe_mod
from . import sharding as msh
from . import ssm
from .modules import ACTIVATIONS, dense_init, split_mlp, swiglu

KV_KINDS = ("global", "local")       # GQA; ``mla`` keeps a compressed cache
CACHE_KINDS = KV_KINDS + ("mla",)    # caches of rows by position; the rest: recurrent states


def _ssm(kind: str, fn: str):
    """``ssm.<kind>_<fn>``: init, forward, decode, prefill or cache_shape."""
    return getattr(ssm, f"{kind}_{fn}")


@dataclasses.dataclass(frozen=True)
class Phase:
    kinds: tuple          # mixer kind per slot in the group
    ffns: tuple           # ffn kind per slot
    n_groups: int
    shared_attn: bool = False   # zamba2: tied attention block after each group


def build_plan(cfg: ArchConfig) -> list[Phase]:
    """The phase plan, as the reference derives it from the config."""
    L = cfg.n_layers
    if cfg.family == "ssm":                          # xlstm
        per = cfg.slstm_every or L
        if L % per:
            raise ValueError("xlstm layer count must tile the sLSTM period")
        kinds = tuple("mlstm" if (i + 1) % per else "slstm" for i in range(per))
        return [Phase(kinds, ("none",) * per, L // per)]
    if cfg.family == "hybrid":                       # zamba2
        per = cfg.shared_attn_every
        full, rem = divmod(L, per)
        phases = [Phase(("mamba2",) * per, ("none",) * per, full, shared_attn=True)]
        if rem:
            phases.append(Phase(("mamba2",) * rem, ("none",) * rem, 1))
        return phases
    ffn = "moe" if cfg.n_experts else "mlp"
    pattern = cfg.block_pattern
    phases = []
    if cfg.n_experts and cfg.first_layer_dense:      # deepseek: dense layer 0
        phases.append(Phase((pattern[0],), ("mlp",), 1))
        L -= 1
    per = len(pattern)
    full, rem = divmod(L, per)
    if full:
        phases.append(Phase(tuple(pattern), (ffn,) * per, full))
    if rem:
        phases.append(Phase(tuple(pattern[:rem]), (ffn,) * rem, 1))
    return phases


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_init(cfg: ArchConfig, dtype: torch.dtype, *, generator: torch.Generator,
             device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, dtype=dtype, device=device)
    if cfg.mlp_act == "swiglu":
        return {"w_gate": dense_init((d, f), **kw),
                "w_up": dense_init((d, f), **kw),
                "w_down": dense_init((f, d), fan_in=f, **kw)}
    return {"w_up": dense_init((d, f), **kw),
            "w_down": dense_init((f, d), fan_in=f, **kw)}


def mlp_forward(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The MLP; under tensor parallelism ``_split_mlp``."""
    if msh.model_ways() > 1:
        return _split_mlp(p, x, cfg)
    h = x @ p["w_up"]
    if cfg.mlp_act == "swiglu":
        h = swiglu(h, x @ p["w_gate"])
    else:
        h = ACTIVATIONS[cfg.mlp_act](h)
    return h @ p["w_down"]


def _split_mlp(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The MLP under tensor parallelism: x goes through one ``copy``, then
    ``modules.split_mlp``, and the output is whole."""
    out, layout = split_mlp(p, msh.copy(x), cfg.d_model, cfg.d_ff, cfg.mlp_act)
    return msh.constrain(out, "batch", None, None, layout=layout)


# ---------------------------------------------------------------------------
# Slots
# ---------------------------------------------------------------------------
def slot_init(cfg: ArchConfig, kind: str, ffn: str, dtype: torch.dtype, *,
              generator: torch.Generator, device, cross: bool = False) -> dict:
    kw = dict(generator=generator, device=device)
    if kind in KV_KINDS:
        mixer = attn.gqa_init(cfg, dtype, **kw)
    elif kind == "mla":
        mixer = attn.mla_init(cfg, dtype, **kw)
    else:
        mixer = _ssm(kind, "init")(cfg, dtype, **kw)
    p = {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=device), "mixer": mixer}
    if ffn != "none":
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        p["ffn"] = (moe_mod.moe_init(cfg, dtype, **kw) if ffn == "moe"
                    else mlp_init(cfg, dtype, **kw))
    if cross:                           # whisper's decoder: the cross-attention sub-layer
        p["norm_x"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        p["cross"] = attn.cross_init(cfg, dtype, **kw)
    return p


def norm(x: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps=cfg.norm_eps, use_kernel=cfg.use_kernels)


def _ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, ffn: str, *, no_drop: bool = False):
    """(x + ffn(norm2(x)), the MoE aux loss or None)."""
    if ffn == "none":
        return x, None
    h = norm(x, p["norm2"], cfg)
    if ffn == "moe":
        y, aux = moe_mod.moe_forward(p["ffn"], h, cfg, no_drop=no_drop)
        return x + y, aux
    return x + mlp_forward(p["ffn"], h, cfg), None


def _cross(p: dict, x: torch.Tensor, cfg: ArchConfig, enc_kv, fn) -> torch.Tensor:
    """x + the cross sub-layer (``attention.cross_forward`` or
    ``cross_decode``) where the slot has one (``enc_kv`` given)."""
    if enc_kv is None:
        return x
    return x + fn(p["cross"], norm(x, p["norm_x"], cfg), enc_kv, cfg)


def window_of(cfg: ArchConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


def _store(cache: dict, new: dict) -> None:
    """Write a recurrent mixer's new state into its cache, in place: under
    tensor parallelism the rank's block of each state into its cache block
    (the mixers return the blocks ``cache_shardings`` gives)."""
    for name, t in new.items():
        cache[name].copy_(t)


# the slot functions take kind/ffn from a plan that build_plan has checked
def slot_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                 kind: str, ffn: str, *, collect_cache: bool = False, enc_kv=None):
    """Returns (x, cache or None, aux): {k, v} for GQA, {c_kv, k_rope} for
    MLA, the final state for recurrent mixers; the MoE aux loss (fp32
    scalar), None for other ffns.  ``enc_kv`` (whisper's decoder): the
    encoder's (k, v) the cross sub-layer attends."""
    xn = norm(x, p["norm1"], cfg)
    if kind in KV_KINDS:
        out = attn.gqa_forward(p["mixer"], xn, positions, cfg, window=window_of(cfg, kind),
                               return_kv=collect_cache)
        mix, cache = (out[0], {"k": out[1][0], "v": out[1][1]}) if collect_cache \
            else (out, None)
    elif kind == "mla":
        out = attn.mla_forward(p["mixer"], xn, positions, cfg, return_cache=collect_cache)
        mix, cache = out if collect_cache else (out, None)
    elif collect_cache:
        mix, cache = _ssm(kind, "forward")(p["mixer"], xn, cfg, return_state=True)
    else:
        mix, cache = _ssm(kind, "forward")(p["mixer"], xn, cfg), None
    x, aux = _ffn(p, _cross(p, x + mix, cfg, enc_kv, attn.cross_forward), cfg, ffn)
    return x, cache, aux


def _mixer_cached(p: dict, xn: torch.Tensor, cache: dict, positions: torch.Tensor,
                  cfg: ArchConfig, kind: str, fn: str) -> torch.Tensor:
    """The mixer's ``fn`` ("decode" or "prefill") against its cache, which
    it updates in place."""
    if kind in KV_KINDS:
        return getattr(attn, f"gqa_{fn}")(p, xn, cache, positions, cfg,
                                          window=window_of(cfg, kind))[0]
    if kind == "mla":
        return getattr(attn, f"mla_{fn}")(p, xn, cache, positions, cfg)[0]
    mix, new = _ssm(kind, fn)(p, xn, cache, cfg)
    _store(cache, new)
    return mix


def slot_decode(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
                cfg: ArchConfig, kind: str, ffn: str, *, enc_kv=None):
    """One token a row; MoE routes with capacity, as the reference's does.
    ``enc_kv``: the cached encoder rows the cross sub-layer reads."""
    mix = _mixer_cached(p["mixer"], norm(x, p["norm1"], cfg), cache, positions, cfg, kind,
                        "decode")
    return _ffn(p, _cross(p, x + mix, cfg, enc_kv, attn.cross_decode), cfg, ffn)[0], cache


def slot_prefill(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
                 cfg: ArchConfig, kind: str, ffn: str):
    """Chunked-prefill twin of slot_decode: attention batches the chunk's
    queries against the cache with decode-exact masking; recurrent mixers
    run the exact decode recurrence over the chunk; MoE routes with
    ``no_drop``, so no token of the chunk is dropped where its decode step
    would keep it."""
    mix = _mixer_cached(p["mixer"], norm(x, p["norm1"], cfg), cache, positions, cfg, kind,
                        "prefill")
    return _ffn(p, x + mix, cfg, ffn, no_drop=True)[0], cache


def slot_decode_stacked(p: dict, x: torch.Tensor, stacked: dict, g: int,
                        positions: torch.Tensor, cfg: ArchConfig, kind: str, ffn: str, *,
                        enc_kv=None):
    """slot_decode against the layer-stacked cache (a leading group dim):
    it runs on group ``g``'s views, which every mixer updates in place.
    Returns (x, stacked)."""
    return slot_decode(p, x, {k: t[g] for k, t in stacked.items()}, positions, cfg, kind,
                       ffn, enc_kv=enc_kv)[0], stacked


def slot_cache_shape(cfg: ArchConfig, kind: str, batch: int, length: int) -> dict:
    if kind in KV_KINDS:
        return attn.gqa_cache_shape(cfg, batch, length, window=window_of(cfg, kind))
    if kind == "mla":
        return attn.mla_cache_shape(cfg, batch, length)
    return _ssm(kind, "cache_shape")(cfg, batch)


def cache_dtypes(kind: str, compute_dtype: torch.dtype) -> torch.dtype:
    """KV and compressed MLA caches follow the compute dtype; recurrent
    states carry fp32."""
    return compute_dtype if kind in CACHE_KINDS else torch.float32
