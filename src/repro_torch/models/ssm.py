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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from .modules import dense_init


def _norm(x: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps=cfg.norm_eps, use_kernel=cfg.use_kernels)


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


def mamba2_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, *, return_state: bool = False):
    b, s, _ = x.shape
    inner, n, h, k = cfg.d_inner, cfg.ssm_state, cfg.n_heads, cfg.ssm_conv
    z = x @ p["in_proj"]
    xbc_raw = x @ p["xbc_proj"]
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xin, Bm, Cm = torch.split(xbc, [inner, n, n], dim=-1)
    dt = F.softplus(x @ p["dt_proj"] + p["dt_bias"].to(x.dtype))
    A = -torch.exp(p["A_log"])
    y, h_final = ops.ssm_scan(xin.reshape(b, s, h, inner // h), dt, A, Bm, Cm,
                              chunk=cfg.ssm_chunk, use_kernel=cfg.use_kernels)
    y = y.reshape(b, s, inner) + xin * _skip(p, cfg)[None, None, :]
    out = _norm(y * F.silu(z), p["ssm_norm"], cfg) @ p["out_proj"]
    if return_state:
        # conv tail: the last k-1 pre-activation conv inputs
        tail = xbc_raw[:, -(k - 1):, :] if s >= k - 1 else F.pad(xbc_raw, (0, 0, k - 1 - s, 0))
        return out, {"ssm": h_final, "conv": tail.float()}
    return out


def mamba2_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """x (B,1,D); cache {ssm (B,H,P,N) fp32, conv (B,k-1,conv_dim) fp32}."""
    b = x.shape[0]
    inner, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_heads
    z = (x @ p["in_proj"])[:, 0]
    xbc_new = (x @ p["xbc_proj"])[:, 0]                                   # (B,C)
    # the window is stored in fp32 and cast back, as the reference does
    window = torch.cat([cache["conv"], xbc_new[:, None, :].float()], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.to(x.dtype), p["conv_w"]) + p["conv_b"]
    xin, Bm, Cm = torch.split(F.silu(conv_out), [inner, n, n], dim=-1)
    dt = F.softplus((x @ p["dt_proj"])[:, 0] + p["dt_bias"].to(x.dtype))  # (B,H)
    A = -torch.exp(p["A_log"])
    dtf = dt.float()
    decay = torch.exp(A[None, :] * dtf)                                  # (B,H) fp32
    inject = torch.einsum("bh,bhp,bn->bhpn", dtf, xin.reshape(b, h, inner // h).float(),
                          Bm.float())
    hstate = cache["ssm"] * decay[..., None, None] + inject
    y = torch.einsum("bhpn,bn->bhp", hstate, Cm.float()).to(x.dtype)
    y = y.reshape(b, inner) + xin * _skip(p, cfg)[None, :]
    out = (_norm(y * F.silu(z), p["ssm_norm"], cfg) @ p["out_proj"])[:, None, :]
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


def _mlstm_gates(p: dict, x: torch.Tensor):
    """Log-space gates in fp32; the biases are added in the compute dtype
    first, as the reference does."""
    logi = (x @ p["w_i"] + p["b_i"]).float()
    logf = F.logsigmoid((x @ p["w_f"] + p["b_f"]).float())
    return logi, logf


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, *, return_state: bool = False):
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    q = (x @ p["w_qx"]).reshape(b, s, h, hd)
    k = (x @ p["w_kx"]).reshape(b, s, h, hd)
    v = (x @ p["w_vx"]).reshape(b, s, h, hd)
    logi, logf = _mlstm_gates(p, x)
    if return_state:
        y, state = ops.mlstm_chunked(q, k, v, logi, logf, cfg.ssm_chunk)
    else:
        y = ops.mlstm_scan(q, k, v, logi, logf, chunk=cfg.ssm_chunk,
                           use_kernel=cfg.use_kernels)
    o = torch.sigmoid(x @ p["w_o"])
    y = y.reshape(b, s, h * hd).to(x.dtype) * o
    out = _norm(y, p["scale"], cfg) @ p["out_proj"]
    if return_state:
        return out, {"C": state[0], "n": state[1], "m": state[2]}
    return out


def mlstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One-step recurrent mLSTM. cache {C (B,H,D,D), n (B,H,D), m (B,H)}."""
    b, _, d = x.shape
    h = cfg.n_heads
    hd = d // h
    q, k, v = ((x @ p[w])[:, 0].reshape(b, h, hd).float() for w in ("w_qx", "w_kx", "w_vx"))
    logi, logf = (g[:, 0] for g in _mlstm_gates(p, x))
    C, nvec, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(logf + m, logi)
    fe = torch.exp(logf + m - m_new)
    ie = torch.exp(logi - m_new)
    C = C * fe[..., None, None] + ie[..., None, None] * torch.einsum("bhd,bhe->bhde", v, k)
    nvec = nvec * fe[..., None] + ie[..., None] * k
    qs = q * hd ** -0.5
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", nvec, qs).abs(), torch.exp(-m_new))
    y = torch.einsum("bhde,bhe->bhd", C, qs) / denom[..., None]
    o = torch.sigmoid((x @ p["w_o"])[:, 0])
    y = y.reshape(b, h * hd).to(x.dtype) * o
    out = (_norm(y, p["scale"], cfg) @ p["out_proj"])[:, None, :]
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


def _slstm_preacts(p: dict, x: torch.Tensor) -> tuple:
    """x @ w_g (+ b_g where the block has one), in the compute dtype."""
    return tuple(x @ p[f"w_{g}"] + p[f"b_{g}"] if f"b_{g}" in p else x @ p[f"w_{g}"]
                 for g in _GATES)


def _slstm_step(p: dict, carry: tuple, xt: tuple) -> tuple:
    """carry (c, n, m, h), each (B,H,hd); xt the four (B, H*hd) preacts."""
    c, n, m, hprev = carry
    b, heads, hd = hprev.shape

    def pre(g, xg):
        # the reference's einsum promotes the compute-dtype weights to hprev's fp32
        return xg.reshape(b, heads, hd) + torch.einsum(
            "bhe,hef->bhf", hprev, p[f"r_{g}"].to(hprev.dtype))

    i_pre, f_pre, z_pre, o_pre = (pre(g, xg) for g, xg in zip(_GATES, xt))
    logf = F.logsigmoid(f_pre.float())
    logi = i_pre.float()
    m_new = torch.maximum(logf + m, logi)
    fe, ie = torch.exp(logf + m - m_new), torch.exp(logi - m_new)
    c_new = fe * c + ie * torch.tanh(z_pre.float())
    n_new = fe * n + ie
    h_new = torch.sigmoid(o_pre.float()) * c_new / n_new.clamp_min(1e-6)
    return c_new, n_new, m_new, h_new.to(hprev.dtype)


def slstm_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, *, return_state: bool = False):
    b, s, d = x.shape
    h, hd = cfg.n_heads, d // cfg.n_heads
    pre = _slstm_preacts(p, x)
    zeros = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
    carry = (zeros, zeros, torch.full_like(zeros, -1e30), zeros)
    hs = []
    for t in range(s):
        carry = _slstm_step(p, carry, tuple(g[:, t] for g in pre))
        hs.append(carry[3])
    y = torch.stack(hs, dim=1).reshape(b, s, h * hd).to(x.dtype)
    out = _norm(y, p["scale"], cfg) @ p["out_proj"]
    if return_state:
        return out, dict(zip(("c", "n", "m", "h"), carry))
    return out


def slstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    carry = (cache["c"], cache["n"], cache["m"], cache["h"])
    c, n, m, hnew = _slstm_step(p, carry, tuple(g[:, 0] for g in _slstm_preacts(p, x)))
    y = hnew.reshape(x.shape[0], -1).to(x.dtype)
    out = (_norm(y, p["scale"], cfg) @ p["out_proj"])[:, None, :]
    return out, {"c": c, "n": n, "m": m, "h": hnew}


def slstm_prefill(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig):
    return _scan_decode(slstm_decode, p, x, cache, cfg)


def slstm_cache_shape(cfg: ArchConfig, batch: int) -> dict:
    shp = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return {"c": shp, "n": shp, "m": shp, "h": shp}
