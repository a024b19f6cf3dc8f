"""Mixture-of-Experts layer: top-k router and sort-based capacity dispatch.

Counterpart of ``repro.models.moe``, with its semantics: each batch row
routes its own tokens (GShard-style groups; the reference ``vmap``s over
the rows, here every step carries a leading batch dim); per group the
capacity is C = ceil(cf * S * top_k / E), at least top_k, and an
assignment past its expert's C slots is dropped (contributes zero).  The
tokens are dispatched into dense ``(B, E, C, D)`` buffers in the order of
a stable argsort of the flattened expert ids, every expert computes its
whole buffer (batched products, no kernel: the reference runs these
outside any Pallas kernel too) and the outputs are gathered back and
weighted by the renormalised gates.  The Switch load-balance loss
(generalised to top-k) comes back for the training loss.

Top-k is a stable descending sort of the router probabilities, cut to k:
``jax.lax.top_k`` puts the lower expert index first among equal
probabilities, which ``torch.topk`` does not promise.  Every dropped
assignment writes a zero row into one overflow row past the buffer's end,
which is then cut off; every kept assignment has a slot of its own, so no
write depends on the order in which duplicate indices land.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from . import sharding as msh
from .modules import dense_init, split_mlp, swiglu


class Route(NamedTuple):
    """One dispatch's state, every field with a leading batch dim: the
    stable sort ``order`` of the (S*k,) flattened expert ids, each sorted
    assignment's buffer ``slot`` (E*C for the overflow row), ``keep``
    (within capacity), ``tok_idx`` (its source token), and per token the
    renormalised ``gates`` and expert ``ids`` (B,S,k)."""
    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    tok_idx: torch.Tensor
    gates: torch.Tensor
    ids: torch.Tensor


def _epad(cfg: ArchConfig) -> int:
    """Stored expert count: padded (dead) experts let E divide a mesh."""
    return max(cfg.expert_pad_to, cfg.n_experts)


def moe_init(cfg: ArchConfig, dtype: torch.dtype, *, generator: torch.Generator,
             device) -> dict:
    """The router is fp32 whatever ``dtype`` is, as in the reference; the
    expert weights are stacked ``(E, d, f)`` / ``(E, f, d)``."""
    d, e, f = cfg.d_model, _epad(cfg), cfg.moe_d_ff
    kw = dict(generator=generator, device=device)
    p = {"router": dense_init((d, cfg.n_experts), fan_in=d, dtype=torch.float32, **kw),
         "experts_gate": dense_init((e, d, f), fan_in=d, dtype=dtype, **kw),
         "experts_up": dense_init((e, d, f), fan_in=d, dtype=dtype, **kw),
         "experts_down": dense_init((e, f, d), fan_in=f, dtype=dtype, **kw)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_gate"] = dense_init((d, fs), fan_in=d, dtype=dtype, **kw)
        p["shared_up"] = dense_init((d, fs), fan_in=d, dtype=dtype, **kw)
        p["shared_down"] = dense_init((fs, d), fan_in=fs, dtype=dtype, **kw)
    return p


def capacity(cfg: ArchConfig, group_tokens: int) -> int:
    c = math.ceil(cfg.capacity_factor * group_tokens * cfg.top_k / cfg.n_experts)
    return max(c, cfg.top_k)


def router_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B,S,n_experts) fp32 logits.  The router enters in the compute dtype,
    as the reference's per-call ``cast_tree`` leaves it (its fp32 leaf is
    rounded to bf16 first in a bf16 model), then both operands in fp32."""
    return x.float() @ p["router"].to(x.dtype).float()


def _top_k(probs: torch.Tensor, k: int):
    """(gates, ids), each (B,S,k): the k largest router probabilities, ties
    to the lower expert index."""
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gates[..., :k], ids[..., :k]


def _route(logits: torch.Tensor, cfg: ArchConfig, cap: int):
    """Every row's routing: logits (B,S,n_experts) fp32 -> (Route, router
    probs (B,S,n_experts)).  Padded experts get no router logit, so they
    are never picked."""
    b, s, _ = logits.shape
    e, k = _epad(cfg), cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, k)                                      # (B,S,k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    flat_ids = ids.reshape(b, s * k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, order)
    counts = torch.zeros((b, e), dtype=torch.long, device=logits.device).scatter_add_(
        1, flat_ids, torch.ones_like(flat_ids))                        # bincount per row
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_in_expert = torch.arange(s * k, device=logits.device)[None] - torch.gather(
        starts, 1, sorted_ids)
    keep = pos_in_expert < cap
    slot = torch.where(keep, sorted_ids * cap + pos_in_expert, e * cap)  # overflow row
    return Route(order, slot, keep, order // k, gates, ids), probs


def _dispatch(x: torch.Tensor, route: Route, n_slots: int) -> torch.Tensor:
    """(B,n_slots,D) buffers: each kept assignment's token row of x (B,S,D)
    at its slot, zeros elsewhere (dropped ones land in the overflow row
    ``n_slots``, cut off)."""
    b, sk = route.slot.shape
    d = x.shape[-1]
    rows = torch.gather(x, 1, route.tok_idx[..., None].expand(b, sk, d))
    rows = torch.where(route.keep[..., None], rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))
    flat = (torch.arange(b, device=x.device)[:, None] * (n_slots + 1) + route.slot).reshape(-1)
    buf = torch.zeros((b * (n_slots + 1), d), dtype=x.dtype, device=x.device).index_put(
        (flat,), rows.reshape(-1, d))
    return buf.reshape(b, n_slots + 1, d)[:, :-1]


def _route_group(x: torch.Tensor, logits: torch.Tensor, cfg: ArchConfig, cap: int):
    """Every row's dispatch. x (B,S,D), logits (B,S,n_experts) fp32 ->
    (buffers (B,E,C,D), Route, router probs (B,S,n_experts))."""
    b, _, d = x.shape
    e = _epad(cfg)
    route, probs = _route(logits, cfg, cap)
    return _dispatch(x, route, e * cap).reshape(b, e, cap, d), route, probs


def _own_slots(route: Route, lo: int, n: int) -> Route:
    """``route`` cut to the buffer slots lo .. lo + n - 1 (one rank's
    experts), renumbered from 0; every other assignment is dropped into the
    overflow slot ``n``."""
    own = route.keep & (route.slot >= lo) & (route.slot < lo + n)
    return route._replace(keep=own, slot=torch.where(own, route.slot - lo, n))


def _combine_group(buf_out: torch.Tensor, route: Route, s: int, k: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """(B,E,C,D) expert outputs -> (B,S,D): each kept assignment's row,
    back in (S*k) assignment order, weighted by its gate, summed over k."""
    b, e, cap, d = buf_out.shape
    flat = buf_out.reshape(b, e * cap, d)
    picked = torch.gather(flat, 1, torch.clamp_max(route.slot, e * cap - 1)[..., None]
                          .expand(b, s * k, d))
    picked = torch.where(route.keep[..., None], picked,
                         torch.zeros((), dtype=picked.dtype, device=picked.device))
    # ``order`` is a permutation of each row: every index is written once
    unsorted = torch.zeros((b, s * k, d), dtype=dtype, device=buf_out.device).scatter(
        1, route.order[..., None].expand(b, s * k, d), picked.to(dtype))
    return (unsorted.reshape(b, s, k, d) * route.gates[..., None].to(dtype)).sum(dim=2)


def _aux(logits: torch.Tensor, probs: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The Switch-style load-balance loss, averaged over the rows."""
    b, s, e = logits.shape
    me = probs.mean(dim=1)                                             # (B,E)
    top1 = torch.argmax(logits, dim=-1)
    ce = torch.zeros((b, e), dtype=torch.float32, device=logits.device).scatter_add_(
        1, top1, torch.ones(top1.shape, dtype=torch.float32, device=logits.device)) / s
    return (e * torch.mean(torch.sum(me * ce, dim=-1))).float()


def moe_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, *, no_drop: bool = False):
    """x (B,S,D) -> (y (B,S,D), aux fp32 scalar).

    ``no_drop``: capacity S*k, so no assignment overflows; chunked prefill
    uses it to stay equivalent to one-token decode, where capacity never
    binds.  Under tensor parallelism ``_split_moe``."""
    s, k = x.shape[1], cfg.top_k
    cap = s * k if no_drop else capacity(cfg, s)
    if msh.model_ways() > 1:
        return _split_moe(p, x, cfg, cap)
    logits = router_logits(p, x)
    bufs, route, probs = _route_group(x, logits, cfg, cap)

    h_gate = torch.einsum("becd,edf->becf", bufs, p["experts_gate"])
    h_up = torch.einsum("becd,edf->becf", bufs, p["experts_up"])
    out_buf = torch.einsum("becf,efd->becd", swiglu(h_up, h_gate), p["experts_down"])
    y = _combine_group(out_buf, route, s, k, x.dtype)
    aux = _aux(logits, probs, cfg)

    if cfg.n_shared_experts:
        sh = swiglu(x @ p["shared_up"], x @ p["shared_gate"])
        y = y + sh @ p["shared_down"]
    return y, aux


def _split_moe(p: dict, x: torch.Tensor, cfg: ArchConfig, cap: int):
    """``moe_forward`` under tensor parallelism, on this rank's blocks of the
    expert leaves.  The router is whole, and x is the same bits on every
    rank of the model group, so every rank routes alike (``Route``) and
    takes the whole aux loss, whose gradient is the router's whole one.
    The (B,E,C,D) buffers take the reference's constraint ("batch",
    "expert", None, "model"), fitted without relocation:

    - E divides the model axis: each rank dispatches into its own experts'
      slots only (``_own_slots``), runs their three products and combines
      their kept rows, weighted by their gates, into a (B,S,D) partial sum;
    - else D does: each rank dispatches its block of x's columns, the gate
      and up products are partial sums, reduced together before the
      SwiGLU, ``experts_down`` (split on its output D) gives this rank's
      columns of the buffers, combined into its columns of y, gathered.

    x and the gates enter that rank-local work through ``copy``.  The
    shared experts are ``modules.split_mlp`` on the same ``copy`` of x;
    their partial sum and the routed one are reduced together."""
    b, s, d = x.shape
    e, k, f = _epad(cfg), cfg.top_k, cfg.moe_d_ff
    logits = router_logits(p, x)
    route, probs = _route(logits, cfg, cap)
    route = route._replace(gates=msh.copy(route.gates))
    xc = msh.copy(x)
    layout = msh.fitted_layout((b, e, cap, d), "batch", "expert", None, "model")
    if layout.dim == 1:                                  # this rank's experts
        n = e // msh.model_ways()
        route = _own_slots(route, msh.model_index() * n * cap, n * cap)
        bufs = _dispatch(xc, route, n * cap).reshape(b, n, cap, d)
    else:                                                # this rank's columns, or whole
        src = xc if layout.dim is None else msh.block(xc, -1)
        bufs = _dispatch(src, route, e * cap).reshape(b, e, cap, -1)
    h_gate, hl = msh.project("becd,edf->becf", bufs, layout, p["experts_gate"], (e, d, f))
    h_up, _ = msh.project("becd,edf->becf", bufs, layout, p["experts_up"], (e, d, f))
    if hl.partial:                                       # gate and up on D: one reduce
        h_gate, h_up = msh.reduce(torch.stack([h_gate, h_up])).unbind(0)
        hl = msh.WHOLE
    h = swiglu(h_up, h_gate)
    out_buf, ol = msh.project("becf,efd->becd", h if hl.dim is not None else msh.copy(h), hl,
                              p["experts_down"], (e, f, d))
    y = _combine_group(out_buf, route, s, k, x.dtype)
    yl = msh.Layout(2) if ol.dim == 3 else msh.PARTIAL   # y on this rank's columns, or a part
    if cfg.n_shared_experts:
        sh, sl = split_mlp(p, xc, d, f * cfg.n_shared_experts, "swiglu",
                           ("shared_gate", "shared_up", "shared_down"))
        if yl.partial and sl.partial:
            y = y + sh
        else:
            y = msh.constrain(y, "batch", None, None, layout=yl) + \
                msh.constrain(sh, "batch", None, None, layout=sl)
            yl = msh.WHOLE
    return msh.constrain(y, "batch", None, None, layout=yl), _aux(logits, probs, cfg)
