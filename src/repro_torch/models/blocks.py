"""Block assembly: per-layer "slots" (mixer + ffn) grouped into phases.

Counterpart of ``repro.models.blocks``.  Each layer is
    x = x + mixer(norm1(x));  x = x + ffn(norm2(x))      (ffn optional)
and layers are grouped by the repeating block pattern; a phase's parameters
are stacked on a leading ``n_groups`` dim, as in the reference.  Ported
mixers: ``global`` and ``local`` (sliding-window, ring-buffer cache) GQA,
``mamba2``, ``mlstm`` and ``slstm``; ffns: ``mlp`` (SwiGLU or a one-matrix
activation such as minitron's squared ReLU) and ``none``.  zamba2's
weight-tied shared attention + MLP block runs after each group of a
``shared_attn`` phase, windowed when the decode budget exceeds 64k and, in
decode, as a ``local`` one (the ring branches of ``attention``) while its
cache is no longer than the window.  A block pattern that asks for another
kind raises ``NotImplementedError`` naming the ROADMAP item that ports it.
The norm sites go through ``ops.rmsnorm`` (the kernel when
``cfg.use_kernels``).  Decode and chunked prefill update their cache in
place: attention writes its rows, recurrent mixers their whole state.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from . import attention as attn
from . import ssm
from .modules import ACTIVATIONS, dense_init, swiglu

# block kinds not ported yet -> ROADMAP.md queue 1 item
PENDING_KINDS = {"mla": "1.7", "moe": "1.6"}
KV_KINDS = ("global", "local")       # every other kind is a recurrent mixer in ``ssm``


def _ssm(kind: str, fn: str):
    """``ssm.<kind>_<fn>``: init, forward, decode, prefill or cache_shape."""
    return getattr(ssm, f"{kind}_{fn}")


@dataclasses.dataclass(frozen=True)
class Phase:
    kinds: tuple          # mixer kind per slot in the group
    ffns: tuple           # ffn kind per slot
    n_groups: int
    shared_attn: bool = False   # zamba2: tied attention block after each group


def _require_ported(kind: str, ffn: str) -> None:
    for k in (kind, ffn):
        if k in PENDING_KINDS:
            raise NotImplementedError(f"block kind {k!r} is not ported yet: "
                                      f"ROADMAP.md queue 1 item {PENDING_KINDS[k]}")


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
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP.md queue 1 item 1.9)")
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
    for phase in phases:
        for kind, f in zip(phase.kinds, phase.ffns):
            _require_ported(kind, f)
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
    h = x @ p["w_up"]
    if cfg.mlp_act == "swiglu":
        h = swiglu(h, x @ p["w_gate"])
    else:
        h = ACTIVATIONS[cfg.mlp_act](h)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Slots
# ---------------------------------------------------------------------------
def slot_init(cfg: ArchConfig, kind: str, ffn: str, dtype: torch.dtype, *,
              generator: torch.Generator, device) -> dict:
    _require_ported(kind, ffn)
    kw = dict(generator=generator, device=device)
    mixer = attn.gqa_init(cfg, dtype, **kw) if kind in KV_KINDS else \
        _ssm(kind, "init")(cfg, dtype, **kw)
    p = {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=device), "mixer": mixer}
    if ffn != "none":
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        p["ffn"] = mlp_init(cfg, dtype, **kw)
    return p


def norm(x: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps=cfg.norm_eps, use_kernel=cfg.use_kernels)


def _ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, ffn: str) -> torch.Tensor:
    if ffn == "none":
        return x
    return x + mlp_forward(p["ffn"], norm(x, p["norm2"], cfg), cfg)


def window_of(cfg: ArchConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


def _store(cache: dict, new: dict) -> None:
    """Write a recurrent mixer's new state into its cache, whole, in place."""
    for name, t in new.items():
        cache[name].copy_(t)


# the slot functions take kind/ffn from a plan that build_plan has checked
def slot_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                 kind: str, ffn: str, *, collect_cache: bool = False):
    """Returns (x, cache or None): {k, v} for attention, the final state for
    recurrent mixers."""
    xn = norm(x, p["norm1"], cfg)
    if kind in KV_KINDS:
        out = attn.gqa_forward(p["mixer"], xn, positions, cfg, window=window_of(cfg, kind),
                               return_kv=collect_cache)
        mix, cache = (out[0], {"k": out[1][0], "v": out[1][1]}) if collect_cache \
            else (out, None)
    elif collect_cache:
        mix, cache = _ssm(kind, "forward")(p["mixer"], xn, cfg, return_state=True)
    else:
        mix, cache = _ssm(kind, "forward")(p["mixer"], xn, cfg), None
    return _ffn(p, x + mix, cfg, ffn), cache


def slot_decode(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
                cfg: ArchConfig, kind: str, ffn: str):
    xn = norm(x, p["norm1"], cfg)
    if kind in KV_KINDS:
        mix, cache = attn.gqa_decode(p["mixer"], xn, cache, positions, cfg,
                                     window=window_of(cfg, kind))
    else:
        mix, new = _ssm(kind, "decode")(p["mixer"], xn, cache, cfg)
        _store(cache, new)
    return _ffn(p, x + mix, cfg, ffn), cache


def slot_prefill(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
                 cfg: ArchConfig, kind: str, ffn: str):
    """Chunked-prefill twin of slot_decode: attention batches the chunk's
    queries against the cache with decode-exact masking; recurrent mixers
    run the exact decode recurrence over the chunk."""
    xn = norm(x, p["norm1"], cfg)
    if kind in KV_KINDS:
        mix, cache = attn.gqa_prefill(p["mixer"], xn, cache, positions, cfg,
                                      window=window_of(cfg, kind))
    else:
        mix, new = _ssm(kind, "prefill")(p["mixer"], xn, cache, cfg)
        _store(cache, new)
    return _ffn(p, x + mix, cfg, ffn), cache


def slot_cache_shape(cfg: ArchConfig, kind: str, batch: int, length: int) -> dict:
    if kind in KV_KINDS:
        return attn.gqa_cache_shape(cfg, batch, length, window=window_of(cfg, kind))
    return _ssm(kind, "cache_shape")(cfg, batch)


def cache_dtypes(kind: str, compute_dtype: torch.dtype) -> torch.dtype:
    """KV caches follow the compute dtype; recurrent states carry fp32."""
    return compute_dtype if kind in KV_KINDS else torch.float32
