"""SSM family blocks: Mamba2 (zamba2), mLSTM and sLSTM (xlstm).

Counterpart of ``repro.models.ssm``.  Each block has ``*_init``,
``*_forward`` (full sequence, with ``return_state`` for prefill),
``*_decode`` (one token against the carried state), ``*_prefill`` (a chunk
of tokens through the exact decode recurrence) and ``*_cache_shape``.
States are fp32; activations follow the compute dtype, with the
reference's order of bf16 operations kept where it rounds.

Kernels: Mamba2's scan goes through ``ops.ssm_scan``; the mLSTM
full-sequence forward goes through ``ops.mlstm_scan`` only when no state is
asked for (as the reference dispatches, ``ssm.py:228-237``), and otherwise
through the chunked twin that also returns the carry; sLSTM is a scalar
recurrence and stays a loop.  The block norms go through ``ops.rmsnorm``.
Decode and prefill return new state tensors; ``blocks`` writes them into
the cache.

Under tensor parallelism (``models/sharding``; one code path, whose
layout functions return their input where the model axis is 1) the
projections are column parallel and ``out_proj`` row parallel.  Each scan
runs on the rank's heads where the heads divide the model axis, else on
every head (``_split_heads``), and the states it returns are the rank's
block of the cache under ``cache_shardings``.  Mamba2's conv runs on the
rank's block of its conv_dim channels, which need not line up with its
heads (a head of zamba2 straddles two ranks' blocks), so its output is
gathered whole before the rank takes its heads of x and the whole B and
C; its ``conv`` state stays the rank's channel block.  The norm before
``out_proj`` spans the whole inner row: the row is gathered and normed
whole through ``ops.rmsnorm`` (the kernel stays on the path, on the same
rows as one process), and ``out_proj`` takes the rank's block of it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from . import sharding as msh
from .modules import dense_init


def _norm(x: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps=cfg.norm_eps, use_kernel=cfg.use_kernels)


def _split_heads(h: int) -> bool:
    """Whether this rank runs a block of the ``h`` heads (they divide the
    model axis, and the state caches split on them) or every head."""
    return msh.fitted_layout((h,), "model").dim is not None


def _proj(xc: torch.Tensor, w: torch.Tensor, whole: tuple) -> tuple:
    """(``xc @ w``, its layout) with this rank's block ``w`` of a (D, F)
    weight; ``xc`` is whole and has come through ``copy``."""
    return msh.project("...d,df->...f", xc, msh.WHOLE, w, whole, op=torch.matmul)


def _heads(t: torch.Tensor, layout: msh.Layout, split: bool) -> torch.Tensor:
    """The columns (.., H*hd) of the heads this rank runs, from ``t`` under
    ``layout``: its block where ``split``, else every column."""
    return msh.relayout(t, layout, msh.Layout(t.ndim - 1) if split else msh.WHOLE)


def _bias(b: torch.Tensor, split: bool) -> torch.Tensor:
    """A whole bias on the rank's heads' columns: its block through
    ``copy`` (the ranks' gradients sum) where ``split``, else whole."""
    return msh.block(msh.copy(b), 0) if split else b


def _out(p: dict, y: torch.Tensor, split: bool, scale: torch.Tensor,
         cfg: ArchConfig) -> torch.Tensor:
    """The norm over the whole inner row, then ``out_proj``: ``y`` (the
    rank's heads' columns where ``split``) gathered whole and normed with
    the whole ``scale`` (gathered where it is split), then ``out_proj``
    row parallel on the rank's block of the normed row, made whole."""
    y = msh.gather(y, -1) if split else y
    if scale.shape[0] < y.shape[-1]:
        scale = msh.gather(scale, 0)
    normed = msh.copy(_norm(y, scale, cfg))
    out, layout = _proj(normed, p["out_proj"], (y.shape[-1], cfg.d_model))
    return msh.constrain(out, "batch", None, None, layout=layout)


def _scan_decode(decode, p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """Chunk prefill: the exact one-step recurrence over each token in turn."""
    outs = []
    for t in range(x.shape[1]):
        out, cache = decode(p, x[:, t:t + 1], cache, cfg)
        outs.append(out)
    return torch.cat(outs, dim=1), cache


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================
def mamba2_init(cfg: ArchConfig, dtype: torch.dtype, *, generator: torch.Generator,
                device) -> dict:
    d, inner, n, kconv, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.n_heads
    conv_dim = inner + 2 * n              # x, B, C all pass the causal conv
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "in_proj": dense_init((d, inner), fan_in=d, **kw),                   # gate z
        "xbc_proj": dense_init((d, conv_dim), fan_in=d, **kw),
        "conv_w": dense_init((kconv, conv_dim), fan_in=kconv, **kw),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "dt_proj": dense_init((d, h), fan_in=d, **kw),
        "dt_bias": torch.zeros((h,), dtype=dtype, device=device),
        # fp32 in the reference's init, cast to the compute dtype on every call
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)).to(dtype),
        "D_skip": torch.ones((h,), dtype=dtype, device=device),
        "ssm_norm": torch.zeros((inner,), dtype=dtype, device=device),
        "out_proj": dense_init((inner, d), fan_in=inner, **kw),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d as a shifted sum in u's dtype. u (B,S,C), w (k,C)."""
    k, s = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0))
    return sum(up[:, i:i + s, :] * w[i][None, None, :] for i in range(k)) + b


def _skip(p: dict, cfg: ArchConfig) -> torch.Tensor:
    return p["D_skip"].repeat_interleave(cfg.d_inner // cfg.n_heads)


def _mamba2_in(p: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple:
    """(xc, z on the rank's heads' columns, the conv's input on the
    ``conv`` cache's channel block, heads split) of x (B,S,D)."""
    inner, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_heads
    split = _split_heads(h)
    xc = msh.copy(x)
    z = _heads(*_proj(xc, p["in_proj"], (cfg.d_model, inner)), split)
    xbc, layout = _proj(xc, p["xbc_proj"], (cfg.d_model, inner + 2 * n))
    return xc, z, msh.constrain(xbc, "batch", None, "model", layout=layout), split


def _mamba2_split(xbc: torch.Tensor, cfg: ArchConfig, split: bool) -> tuple:
    """The conv's activated output on the rank's channel block -> (x on
    the rank's heads, the whole B and C), through one ``copy`` of the
    gathered whole (the heads' gradients, partial over the ranks, sum)."""
    inner, n = cfg.d_inner, cfg.ssm_state
    xbc = msh.copy(msh.gather(xbc, -1) if xbc.shape[-1] < inner + 2 * n else xbc)
    xin, Bm, Cm = torch.split(xbc, [inner, n, n], dim=-1)
    return (msh.block(xin, -1) if split else xin), Bm, Cm


def _mamba2_dt(p: dict, xc: torch.Tensor, cfg: ArchConfig, split: bool) -> torch.Tensor:
    """softplus(x @ dt_proj + dt_bias) on the rank's heads."""
    dt = _heads(*_proj(xc, p["dt_proj"], (cfg.d_model, cfg.n_heads)), split)
    return F.softplus(dt + _bias(p["dt_bias"], split).to(xc.dtype))


def mamba2_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, *, return_state: bool = False):
    b, s, _ = x.shape
    k, ph = cfg.ssm_conv, cfg.d_inner // cfg.n_heads
    xc, z, xbc_raw, split = _mamba2_in(p, x, cfg)
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xin, Bm, Cm = _mamba2_split(xbc, cfg, split)
    dt = _mamba2_dt(p, xc, cfg, split)
    A = -torch.exp(p["A_log"])
    y, h_final = ops.ssm_scan(xin.reshape(b, s, -1, ph), dt, A, Bm, Cm,
                              chunk=cfg.ssm_chunk, use_kernel=cfg.use_kernels)
    y = y.reshape(b, s, -1) + xin * _skip(p, cfg)[None, None, :]
    out = _out(p, y * F.silu(z), split, p["ssm_norm"], cfg)
    if return_state:
        # conv tail: the last k-1 pre-activation conv inputs
        tail = xbc_raw[:, -(k - 1):, :] if s >= k - 1 else F.pad(xbc_raw, (0, 0, k - 1 - s, 0))
        return out, {"ssm": h_final, "conv": tail.float()}
    return out


def mamba2_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """x (B,1,D); cache {ssm (B,H,P,N) fp32, conv (B,k-1,conv_dim) fp32}
    (under tensor parallelism the rank's heads and channel block)."""
    b = x.shape[0]
    ph = cfg.d_inner // cfg.n_heads
    xc, z, xbc_new, split = _mamba2_in(p, x, cfg)
    # the window is stored in fp32 and cast back, as the reference does
    window = torch.cat([cache["conv"], xbc_new.float()], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.to(x.dtype), p["conv_w"]) + p["conv_b"]
    xin, Bm, Cm = (t[:, 0] for t in _mamba2_split(F.silu(conv_out)[:, None], cfg, split))
    dt = _mamba2_dt(p, xc, cfg, split)[:, 0]                            # (B,h)
    A = -torch.exp(p["A_log"])
    dtf = dt.float()
    decay = torch.exp(A[None, :] * dtf)                                  # (B,h) fp32
    inject = torch.einsum("bh,bhp,bn->bhpn", dtf, xin.reshape(b, -1, ph).float(), Bm.float())
    hstate = cache["ssm"] * decay[..., None, None] + inject
    y = torch.einsum("bhpn,bn->bhp", hstate, Cm.float()).to(x.dtype)
    y = y.reshape(b, -1) + xin * _skip(p, cfg)[None, :]
    out = _out(p, (y * F.silu(z[:, 0]))[:, None], split, p["ssm_norm"], cfg)
    return out, {"ssm": hstate, "conv": window[:, 1:, :]}


def mamba2_prefill(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """Chunk prefill: the decode recurrence over C tokens (the chunkwise
    ``mamba2_forward`` sums in another order)."""
    return _scan_decode(mamba2_decode, p, x, cache, cfg)


def mamba2_cache_shape(cfg: ArchConfig, batch: int) -> dict:
    inner, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_heads
    return {"ssm": (batch, h, inner // h, n), "conv": (batch, cfg.ssm_conv - 1, inner + 2 * n)}


# ===========================================================================
# mLSTM (xLSTM matrix memory)
# ===========================================================================
def mlstm_init(cfg: ArchConfig, dtype: torch.dtype, *, generator: torch.Generator,
               device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    e = h * (d // h)
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "w_qx": dense_init((d, e), fan_in=d, **kw),
        "w_kx": dense_init((d, e), fan_in=d, **kw),
        "w_vx": dense_init((d, e), fan_in=d, **kw),
        "w_i": dense_init((d, h), fan_in=d, **kw),
        "w_f": dense_init((d, h), fan_in=d, **kw),
        "b_i": torch.zeros((h,), dtype=dtype, device=device),
        "b_f": torch.full((h,), 3.0, dtype=dtype, device=device),   # forget bias ~ remember
        "w_o": dense_init((d, e), fan_in=d, **kw),
        "out_proj": dense_init((e, d), fan_in=d, **kw),
        "scale": torch.zeros((d,), dtype=dtype, device=device),
    }


def _mlstm_in(p: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple:
    """(q, k, v (B,S,h,hd), logi, logf (B,S,h) fp32, o (B,S,h*hd), heads
    split) of x (B,S,D) on the heads this rank runs.  The gates' biases are
    added in the compute dtype first, as the reference does; a gate weight
    whose heads do not divide the model axis is split on D (row parallel),
    its partial sum reduced."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd, split = d // h, _split_heads(h)
    xc = msh.copy(x)
    q, k, v, o = (_heads(*_proj(xc, p[w], (d, h * hd)), split)
                  for w in ("w_qx", "w_kx", "w_vx", "w_o"))
    q, k, v = (t.reshape(b, s, -1, hd) for t in (q, k, v))
    logi, logf = (_heads(*_proj(xc, p[w], (d, h)), split) + _bias(p[bias], split)
                  for w, bias in (("w_i", "b_i"), ("w_f", "b_f")))
    return q, k, v, logi.float(), F.logsigmoid(logf.float()), torch.sigmoid(o), split


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, *, return_state: bool = False):
    b, s, _ = x.shape
    q, k, v, logi, logf, o, split = _mlstm_in(p, x, cfg)
    if return_state:
        y, state = ops.mlstm_chunked(q, k, v, logi, logf, cfg.ssm_chunk)
    else:
        y = ops.mlstm_scan(q, k, v, logi, logf, chunk=cfg.ssm_chunk,
                           use_kernel=cfg.use_kernels)
    out = _out(p, y.reshape(b, s, -1).to(x.dtype) * o, split, p["scale"], cfg)
    if return_state:
        return out, {"C": state[0], "n": state[1], "m": state[2]}
    return out


def mlstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One-step recurrent mLSTM. cache {C (B,H,D,D), n (B,H,D), m (B,H)}
    (under tensor parallelism the heads this rank runs)."""
    b, _, d = x.shape
    hd = d // cfg.n_heads
    q, k, v, logi, logf, o, split = _mlstm_in(p, x, cfg)
    q, k, v = (t[:, 0].float() for t in (q, k, v))
    logi, logf = logi[:, 0], logf[:, 0]
    C, nvec, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(logf + m, logi)
    fe = torch.exp(logf + m - m_new)
    ie = torch.exp(logi - m_new)
    C = C * fe[..., None, None] + ie[..., None, None] * torch.einsum("bhd,bhe->bhde", v, k)
    nvec = nvec * fe[..., None] + ie[..., None] * k
    qs = q * hd ** -0.5
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", nvec, qs).abs(), torch.exp(-m_new))
    y = torch.einsum("bhde,bhe->bhd", C, qs) / denom[..., None]
    out = _out(p, y.reshape(b, 1, -1).to(x.dtype) * o, split, p["scale"], cfg)
    return out, {"C": C, "n": nvec, "m": m_new}


def mlstm_prefill(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    return _scan_decode(mlstm_decode, p, x, cache, cfg)


def mlstm_cache_shape(cfg: ArchConfig, batch: int) -> dict:
    h = cfg.n_heads
    hd = cfg.d_model // h
    return {"C": (batch, h, hd, hd), "n": (batch, h, hd), "m": (batch, h)}


# ===========================================================================
# sLSTM (scalar memory, sequential)
# ===========================================================================
_GATES = ("i", "f", "z", "o")


def slstm_init(cfg: ArchConfig, dtype: torch.dtype, *, generator: torch.Generator,
               device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    kw = dict(generator=generator, dtype=dtype, device=device)
    p = {"out_proj": dense_init((h * hd, d), fan_in=d, **kw),
         "scale": torch.zeros((d,), dtype=dtype, device=device)}
    for g in _GATES:
        p[f"w_{g}"] = dense_init((d, h * hd), fan_in=d, **kw)
    for g in _GATES:
        # block-diagonal recurrent weights: per head (hd, hd)
        p[f"r_{g}"] = dense_init((h, hd, hd), fan_in=hd, **kw)
    p["b_i"] = torch.zeros((h * hd,), dtype=dtype, device=device)
    p["b_f"] = torch.full((h * hd,), 3.0, dtype=dtype, device=device)
    return p


def _slstm_in(p: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple:
    """(the four gates' preacts (B,S,h*hd): x @ w_g (+ b_g where the block
    has one) in the compute dtype, the recurrent weights {g: (h,hd,hd)},
    heads split) on the heads this rank runs: each rank adds its block of
    a whole bias, and takes its heads of the whole ``r_*`` through
    ``copy``."""
    d, h = x.shape[-1], cfg.n_heads
    split = _split_heads(h)
    xc = msh.copy(x)
    pre = []
    for g in _GATES:
        t = _heads(*_proj(xc, p[f"w_{g}"], (d, h * (d // h))), split)
        pre.append(t + _bias(p[f"b_{g}"], split) if f"b_{g}" in p else t)
    r = {g: msh.block(msh.copy(p[f"r_{g}"]), 0) if split else p[f"r_{g}"] for g in _GATES}
    return tuple(pre), r, split


def _slstm_step(r: dict, carry: tuple, xt: tuple) -> tuple:
    """carry (c, n, m, h), each (B,h,hd); xt the four (B, h*hd) preacts;
    ``r`` the recurrent weights of those heads."""
    c, n, m, hprev = carry
    b, heads, hd = hprev.shape

    def pre(g, xg):
        # the reference's einsum promotes the compute-dtype weights to hprev's fp32
        return xg.reshape(b, heads, hd) + torch.einsum(
            "bhe,hef->bhf", hprev, r[g].to(hprev.dtype))

    i_pre, f_pre, z_pre, o_pre = (pre(g, xg) for g, xg in zip(_GATES, xt))
    logf = F.logsigmoid(f_pre.float())
    logi = i_pre.float()
    m_new = torch.maximum(logf + m, logi)
    fe, ie = torch.exp(logf + m - m_new), torch.exp(logi - m_new)
    c_new = fe * c + ie * torch.tanh(z_pre.float())
    n_new = fe * n + ie
    h_new = torch.sigmoid(o_pre.float()) * c_new / n_new.clamp_min(1e-6)
    return c_new, n_new, m_new, h_new.to(hprev.dtype)


def _slstm_loop(r: dict, pre: tuple, carry: tuple) -> tuple:
    """The time loop over the preacts (B,S,h*hd): (every step's hidden
    state (B,S,h,hd), the last carry).  ``launch/dryrun.py`` cuts it to its
    first step."""
    hs = []
    for t in range(pre[0].shape[1]):
        carry = _slstm_step(r, carry, tuple(g[:, t] for g in pre))
        hs.append(carry[3])
    return torch.stack(hs, dim=1), carry


def slstm_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, *, return_state: bool = False):
    b, s, d = x.shape
    pre, r, split = _slstm_in(p, x, cfg)
    hd = d // cfg.n_heads
    zeros = torch.zeros((b, pre[0].shape[-1] // hd, hd), dtype=torch.float32, device=x.device)
    hs, carry = _slstm_loop(r, pre, (zeros, zeros, torch.full_like(zeros, -1e30), zeros))
    out = _out(p, hs.reshape(b, s, -1).to(x.dtype), split, p["scale"], cfg)
    if return_state:
        return out, dict(zip(("c", "n", "m", "h"), carry))
    return out


def slstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    pre, r, split = _slstm_in(p, x, cfg)
    carry = (cache["c"], cache["n"], cache["m"], cache["h"])
    c, n, m, hnew = _slstm_step(r, carry, tuple(g[:, 0] for g in pre))
    out = _out(p, hnew.reshape(x.shape[0], 1, -1).to(x.dtype), split, p["scale"], cfg)
    return out, {"c": c, "n": n, "m": m, "h": hnew}


def slstm_prefill(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    return _scan_decode(slstm_decode, p, x, cache, cfg)


def slstm_cache_shape(cfg: ArchConfig, batch: int) -> dict:
    shp = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return {"c": shp, "n": shp, "m": shp, "h": shp}
