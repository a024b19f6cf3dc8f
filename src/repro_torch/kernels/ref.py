"""Plain PyTorch twins of the kernels: the same function, no kernel.

Counterpart of ``repro.kernels.ref``.  Every product takes its operands in
their own dtype and accumulates in fp32 (``preferred_element_type=f32`` in
the reference): the operands are widened to fp32 first, which is exact for
bf16.  Masks use the finite ``NEG_INF`` the reference uses, so a row whose
keys are all masked averages uniformly instead of producing NaN.

The CPU path runs the attention and norm twins; on the card only
``chip_smoke.py`` and the tests call them, to hold each kernel against its
twin.  ``ssm_scan_ref`` and ``mlstm_scan_ref`` are the sequential oracles
of the two scans, whose plain twins are the chunked forms in ``ops``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def _gqa_expand(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """(B,S,Hkv,D) -> (B,S,Hq,D) by repeating kv heads."""
    group = n_q_heads // k.shape[2]
    return k.repeat_interleave(group, dim=2) if group > 1 else k


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Masked GQA attention. q (B,Sq,Hq,D); k, v (B,Skv,Hkv,D) -> (B,Sq,Hq,D)."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _gqa_expand(k, hq)
    v = _gqa_expand(v, hq)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                         scale: float | None = None) -> torch.Tensor:
    """One query token per row against a padded cache.
    q (B,Hq,D); caches (B,S,Hkv,D); cache_len (B,) valid lengths -> (B,Hq,D)."""
    b, hq, d = q.shape
    s = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = _gqa_expand(k_cache, hq)
    v = _gqa_expand(v_cache, hq)
    logits = torch.einsum("bhd,bkhd->bhk", q.to(k.dtype).float(), k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < cache_len.to(q.device)[:, None]
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor):
    """Sequential Mamba2 / SSD oracle, one token at a time.

    h_t = exp(A dt_t) h_{t-1} + dt_t (x_t outer B_t);  y_t = h_t . C_t
    x (B,S,H,P); dt (B,S,H); A (H,); Bm, Cm (B,S,N); the state starts at zero.
    Returns (y (B,S,H,P) in x.dtype, h_final (B,H,P,N) fp32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf, dtf, bf, cf, af = x.float(), dt.float(), Bm.float(), Cm.float(), A.float()
    hs = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(af[None, :] * dtf[:, t])                          # (B,H)
        inject = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], bf[:, t])
        hs = hs * decay[..., None, None] + inject
        ys.append(torch.einsum("bhpn,bn->bhp", hs, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf[:, :0]
    return y.to(x.dtype), hs


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_gate: torch.Tensor, f_gate: torch.Tensor) -> torch.Tensor:
    """Sequential stabilised mLSTM oracle (xLSTM matrix memory).

    C_t = f_t C_{t-1} + i_t v_t k_t^T;  n_t = f_t n_{t-1} + i_t k_t;
    y_t = C~_t q_t / max(|n~_t . q_t|, exp(-m_t)),  m_t = max(log f_t + m_{t-1}, log i_t).
    q, k, v (B,S,H,D); i_gate (B,S,H) log-space input gate; f_gate (B,S,H)
    forget-gate preactivation (log-sigmoid applied here).  Returns y in q.dtype."""
    b, s, h, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    logf = torch.nn.functional.logsigmoid(f_gate.float())
    logi = i_gate.float()
    C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    nv = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        m_new = torch.maximum(logf[:, t] + m, logi[:, t])
        fe = torch.exp(logf[:, t] + m - m_new)
        ie = torch.exp(logi[:, t] - m_new)
        C = C * fe[..., None, None] + ie[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", vf[:, t], kf[:, t])
        nv = nv * fe[..., None] + ie[..., None] * kf[:, t]
        qt = qf[:, t] * d ** -0.5
        denom = torch.maximum(torch.einsum("bhd,bhd->bh", nv, qt).abs(), torch.exp(-m_new))
        ys.append(torch.einsum("bhde,bhe->bhd", C, qt) / denom[..., None])
        m = m_new
    y = torch.stack(ys, dim=1) if ys else qf[:, :0]
    return y.to(q.dtype)
