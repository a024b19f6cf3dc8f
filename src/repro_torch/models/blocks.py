"""Block assembly: per-layer "slots" (mixer + ffn) grouped into phases.

Counterpart of ``repro.models.blocks``.  Each layer is
    x = x + mixer(norm1(x));  x = x + ffn(norm2(x))
and layers are grouped by the repeating block pattern; a phase's parameters
are stacked on a leading ``n_groups`` dim, as in the reference.  This slice
ports the ``global`` GQA mixer with the ``mlp`` ffn; the other kinds raise
``NotImplementedError`` naming the ROADMAP item that ports them.  The norm
sites go through ``ops.rmsnorm`` (the kernel when ``cfg.use_kernels``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from . import attention as attn
from .modules import ACTIVATIONS, dense_init, swiglu

# mixer / ffn kinds not ported yet -> ROADMAP.md queue 1 item
PENDING_KINDS = {"local": "1.2", "mla": "1.7", "mamba2": "1.8", "mlstm": "1.8",
                 "slstm": "1.8", "moe": "1.6"}


@dataclasses.dataclass(frozen=True)
class Phase:
    kinds: tuple          # mixer kind per slot in the group
    ffns: tuple           # ffn kind per slot
    n_groups: int


def _require_ported(kind: str, ffn: str) -> None:
    for k in (kind, ffn):
        if k in PENDING_KINDS:
            raise NotImplementedError(f"block kind {k!r} is not ported yet: "
                                      f"ROADMAP.md queue 1 item {PENDING_KINDS[k]}")


def build_plan(cfg: ArchConfig) -> list[Phase]:
    """The phase plan of a dense decoder (the reference's non-SSM branch)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP.md queue 1 items 1.8-1.9)")
    ffn = "moe" if cfg.n_experts else "mlp"
    pattern = cfg.block_pattern
    L = cfg.n_layers
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
    return {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "mixer": attn.gqa_init(cfg, dtype, **kw),
            "norm2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "ffn": mlp_init(cfg, dtype, **kw)}


def norm(x: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps=cfg.norm_eps, use_kernel=cfg.use_kernels)


def _ffn(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x + mlp_forward(p["ffn"], norm(x, p["norm2"], cfg), cfg)


# the slot functions take kind/ffn from a plan that build_plan has checked
def slot_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                 kind: str, ffn: str, *, collect_cache: bool = False):
    """Returns (x, {k, v} or None)."""
    xn = norm(x, p["norm1"], cfg)
    if collect_cache:
        mix, (k, v) = attn.gqa_forward(p["mixer"], xn, positions, cfg, return_kv=True)
        cache = {"k": k, "v": v}
    else:
        mix, cache = attn.gqa_forward(p["mixer"], xn, positions, cfg), None
    return _ffn(p, x + mix, cfg), cache


def slot_decode(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
                cfg: ArchConfig, kind: str, ffn: str):
    mix, cache = attn.gqa_decode(p["mixer"], norm(x, p["norm1"], cfg), cache,
                                 positions, cfg)
    return _ffn(p, x + mix, cfg), cache


def slot_prefill(p: dict, x: torch.Tensor, cache: dict, positions: torch.Tensor,
                 cfg: ArchConfig, kind: str, ffn: str):
    mix, cache = attn.gqa_prefill(p["mixer"], norm(x, p["norm1"], cfg), cache,
                                  positions, cfg)
    return _ffn(p, x + mix, cfg), cache


def slot_cache_shape(cfg: ArchConfig, kind: str, batch: int, length: int) -> dict:
    return attn.gqa_cache_shape(cfg, batch, length)


def cache_dtypes(kind: str, compute_dtype: torch.dtype) -> torch.dtype:
    """KV caches follow the compute dtype (recurrent states, once ported,
    carry fp32)."""
    return compute_dtype
