"""Dispatch layer: the entry points model code calls.

Counterpart of ``repro.kernels.ops``.  ``use_kernel`` comes from
``ArchConfig.use_kernels``.  This is the one place that chooses between a
kernel and its plain twin: the twin runs when ``use_kernel`` is false or
the tensor lies on the CPU (where no kernel exists); otherwise the call goes
to the kernel's wrapper and nothing else, which launches the kernel or
raises.  No path catches a build or launch error.

The attention and norm twins live in ``ref``.  ``flash_attention``,
``rmsnorm`` and ``ssm_scan`` are differentiable on both sides: the twins
by autograd, the kernels through their ``autograd.Function`` and backward
kernels, which ``flash_attention_bwd``, ``rmsnorm_bwd`` and
``ssm_scan_bwd`` below also expose (the twins:
``ref.flash_attention_bwd_ref``, ``ref.rmsnorm_bwd_ref``,
``ref.ssm_scan_bwd_ref``).  Decode attention and ``mlstm_scan`` raise
under grad.  ``flash_chunked`` is the reference's
"fused attention" twin (``ops.flash_chunked_jnp``): plain code that the
plain path runs when ``chunked`` is asked for (``cfg.fused_attention``), so
that a long prefill counted on the plain path (``launch/count.py``) never
holds the whole score matrix; on the card the kernel runs whatever
``chunked`` says.  The two scans' twins are the chunked forms below
(``ssd_chunked``, ``mlstm_chunked``), counterparts of the reference's
``ops.ssd_chunked_jnp`` and ``models/ssm._mlstm_chunked``; ``ref`` holds
their sequential oracles.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .flash_attention import flash_attention_bwd as _flash_bwd_kernel
from .mlstm_scan import mlstm_scan as _mlstm_kernel
from .rmsnorm import rmsnorm as _rmsnorm_kernel
from .rmsnorm import rmsnorm_bwd as _rmsnorm_bwd_kernel
from .ssm_scan import ssm_scan as _ssm_kernel
from .ssm_scan import ssm_scan_bwd as _ssm_bwd_kernel

NEG_INF = ref.NEG_INF


def _plain(use_kernel: bool, x: torch.Tensor) -> bool:
    return not use_kernel or x.device.type == "cpu"


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            use_kernel: bool = False) -> torch.Tensor:
    if _plain(use_kernel, x):
        return ref.rmsnorm_ref(x, scale, eps)
    return _rmsnorm_kernel(x, scale, eps=eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: float | None = None,
                    use_kernel: bool = False, chunked: bool = False,
                    chunk_k: int = 1024) -> torch.Tensor:
    if _plain(use_kernel, q):
        if chunked:
            return flash_chunked(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                 chunk_k=chunk_k, scale=scale)
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale, q_offset=q_offset)
    return _flash_kernel(q, k, v, causal=causal, window=window,
                         scale=scale, q_offset=q_offset)


def flash_chunked(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                  chunk_k: int = 1024, scale: float | None = None) -> torch.Tensor:
    """Online-softmax attention, one loop step per chunk of ``chunk_k`` keys,
    in fp32: the (Sq, Skv) score matrix never exists whole, only (Sq,
    chunk_k) of it.  q (B,Sq,Hq,D); k (B,Skv,Hkv,D); v (B,Skv,Hkv,Dv), Dv may
    differ from D (MLA) -> (B,Sq,Hq,Dv) in q's dtype.  Twin of the
    reference's ``flash_chunked_jnp``, with its finite mask value, so a row
    whose keys are all masked averages uniformly."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = max(hq // hkv, 1)
    t = min(chunk_k, skv)
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset              # (Sq,1)
    acc = torch.zeros((b, hq, sq, v.shape[-1]), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, t):
        kb = k[:, c0:c0 + t].float().repeat_interleave(group, dim=2)          # (B,t,Hq,D)
        vb = v[:, c0:c0 + t].float().repeat_interleave(group, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        kpos = torch.arange(c0, c0 + kb.shape[1], device=q.device)[None, :]
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def rmsnorm_bwd(x, scale, g, rstd, *, eps: float = 1e-6, use_kernel: bool = False):
    """(dx, dscale) of ``rmsnorm`` for the output gradient ``g``; ``rstd``
    is the kernel forward's fp32 1/rms per row (the twin recomputes it)."""
    if _plain(use_kernel, x):
        return ref.rmsnorm_bwd_ref(x, scale, g, eps)
    return _rmsnorm_bwd_kernel(x, scale, g, rstd, eps=eps)


def flash_attention_bwd(q, k, v, do, lse, o32=None, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, use_kernel: bool = False):
    """(dq, dk, dv) of ``flash_attention`` (``q_offset`` 0) for the output
    gradient ``do``; ``lse`` and ``o32`` are the kernel training forward's
    fp32 log-sum-exp and output (``flash_attention.forward_for_training``;
    the twin recomputes the softmax and needs neither)."""
    if _plain(use_kernel, q):
        return ref.flash_attention_bwd_ref(q, k, v, do, causal=causal, window=window,
                                           scale=scale)
    return _flash_bwd_kernel(q, k, v, do, lse, o32, causal=causal, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, cache_len, *, scale: float | None = None,
                     use_kernel: bool = False) -> torch.Tensor:
    if _plain(use_kernel, q):
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len, scale=scale)
    return _decode_kernel(q, k_cache, v_cache, cache_len, scale=scale)


# ---------------------------------------------------------------------------
# Mamba2 SSD scan
# ---------------------------------------------------------------------------
def ssm_scan(x, dt, A, Bm, Cm, *, chunk: int = 256, use_kernel: bool = False):
    """x (B,S,H,P); dt (B,S,H); A (H,); Bm, Cm (B,S,N) -> (y (B,S,H,P) in
    x.dtype, h_final (B,H,P,N) fp32).  ``chunk`` is the twin's chunk length;
    the kernel's result does not depend on it."""
    if _plain(use_kernel, x):
        return ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    return _ssm_kernel(x, dt, A, Bm, Cm)


def ssm_scan_bwd(x, dt, A, Bm, Cm, dy, dh_final=None, *, chunk: int = 256,
                 use_kernel: bool = False):
    """(dx, ddt, dA, dB, dC) of ``ssm_scan`` for the output gradients ``dy``
    and ``dh_final`` (None: zero).  ``chunk`` is the twin's chunk length
    (autograd of ``ssd_chunked`` in fp32); the kernel's result does not
    depend on it."""
    if _plain(use_kernel, x):
        return ref.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dh_final, chunk=chunk)
    return _ssm_bwd_kernel(x, dt, A, Bm, Cm, dy, dh_final)


def _pad_seq(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """Pad dim 1 (the sequence) at its end."""
    return torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad), value=value)


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """Chunked SSD, one loop step per chunk: within a chunk the recurrence is
    dense (T,T) and (T,N) products, and the fp32 (P,N) state is carried
    across chunks.  Padding uses dt = 0 (identity steps)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    t = min(chunk, s)
    pad = (-s) % t
    if pad:
        x, dt, Bm, Cm = (_pad_seq(a, pad) for a in (x, dt, Bm, Cm))
    nc = x.shape[1] // t
    xf = x.float().reshape(b, nc, t, h, p)
    dtf = dt.float().reshape(b, nc, t, h)
    bf = Bm.float().reshape(b, nc, t, n)
    cf = Cm.float().reshape(b, nc, t, n)
    af = A.float()
    tri = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    hprev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc = xf[:, c], dtf[:, c], bf[:, c], cf[:, c]
        cum = torch.cumsum(af[None, None, :] * dtc, dim=1)                 # (B,t,H)
        # mask the exponent BEFORE exp: the dead upper triangle would overflow
        delta = torch.where(tri[None, :, :, None],
                            cum[:, :, None, :] - cum[:, None, :, :], NEG_INF)
        L = torch.exp(delta)
        G = torch.einsum("btn,bsn->bts", cc, bc)
        M = G[:, :, :, None] * L * dtc[:, None, :, :]                    # (B,t,s,H)
        y_intra = torch.einsum("btsh,bshp->bthp", M, xc)
        y_state = torch.exp(cum)[..., None] * torch.einsum("btn,bhpn->bthp", cc, hprev)
        w = dtc * torch.exp(cum[:, -1:, :] - cum)                        # (B,t,H)
        hprev = hprev * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bthp,btn,bth->bhpn", xc, bc, w)
        ys.append(y_intra + y_state)
    y = torch.stack(ys, dim=1).reshape(b, nc * t, h, p)[:, :s]
    return y.to(x.dtype), hprev


# ---------------------------------------------------------------------------
# mLSTM scan
# ---------------------------------------------------------------------------
def mlstm_scan(q, k, v, logi, logf, *, chunk: int = 256, use_kernel: bool = False):
    """q, k, v (B,S,H,D); logi, logf (B,S,H) log-space gates -> y (B,S,H,D)
    in q.dtype.  ``chunk`` is the twin's chunk length.  Emits no state: a
    caller that needs the carry calls ``mlstm_chunked``, as the
    reference's ``mlstm_forward`` does."""
    if _plain(use_kernel, q):
        return mlstm_chunked(q, k, v, logi, logf, chunk)[0].to(q.dtype)
    return _mlstm_kernel(q, k, v, logi, logf)


def mlstm_chunked(q, k, v, logi, logf, chunk: int):
    """Stabilised chunkwise mLSTM.  q, k, v (B,S,H,D); logi/logf (B,S,H) fp32.

    Returns (y (B,S,H,D) fp32, state (C (B,H,D,D), n (B,H,D), m (B,H)), all
    fp32).  Matches ``ref.mlstm_scan_ref`` (y is stabiliser-invariant)."""
    b, s, h, d = q.shape
    t = min(chunk, s)
    pad = (-s) % t
    if pad:
        q, k, v, logf = (_pad_seq(a, pad) for a in (q, k, v, logf))
        logi = _pad_seq(logi, pad, NEG_INF)
    nc = q.shape[1] // t
    qf = (q.float() * d ** -0.5).reshape(b, nc, t, h, d)
    kf = k.float().reshape(b, nc, t, h, d)
    vf = v.float().reshape(b, nc, t, h, d)
    li = logi.float().reshape(b, nc, t, h)
    lf = logf.float().reshape(b, nc, t, h)
    tri = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    nvec = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nc):
        qc, kc, vc, lic, lfc = qf[:, c], kf[:, c], vf[:, c], li[:, c], lf[:, c]
        bcum = torch.cumsum(lfc, dim=1)                                  # (B,t,H)
        # intra-chunk log weights w[t,s] = bcum_t - bcum_s + li_s  (s <= t)
        wlog = bcum[:, :, None, :] - bcum[:, None, :, :] + lic[:, None, :, :]
        wlog = torch.where(tri[None, :, :, None], wlog, -torch.inf)
        glog = bcum + m[:, None, :]                                      # state decay
        m_row = torch.maximum(wlog.amax(dim=2), glog).clamp_min(NEG_INF)  # (B,t,H)
        wexp = torch.exp(wlog - m_row[:, :, None, :])                    # (B,t,s,H)
        gexp = torch.exp(glog - m_row)
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * wexp
        y_intra = torch.einsum("btsh,bshd->bthd", scores, vc)
        y_state = gexp[..., None] * torch.einsum("bhde,bthe->bthd", C, qc)
        nq = (torch.einsum("btsh,bshd->bthd", wexp, kc) * qc).sum(-1) \
            + gexp * torch.einsum("bthd,bhd->bth", qc, nvec)
        denom = torch.maximum(nq.abs(), torch.exp(-m_row))
        ys.append((y_intra + y_state) / denom[..., None])
        # carry update (end of chunk), restabilised at m_new
        tail = lic + (bcum[:, -1:] - bcum)                               # (B,t,H)
        m_new = torch.maximum(bcum[:, -1] + m, tail.amax(dim=1))
        c_decay = torch.exp(bcum[:, -1] + m - m_new)                     # (B,H)
        inj = torch.exp(tail - m_new[:, None])
        C = C * c_decay[..., None, None] + torch.einsum("bthd,bthe,bth->bhde", vc, kc, inj)
        nvec = nvec * c_decay[..., None] + torch.einsum("bthd,bth->bhd", kc, inj)
        m = m_new
    y = torch.stack(ys, dim=1).reshape(b, nc * t, h, d)[:, :s]
    return y, (C, nvec, m)
