"""Plain PyTorch twins of the kernels: the same function, no kernel.

Counterpart of ``repro.kernels.ref``.  Every product takes its operands in
their own dtype and accumulates in fp32 (``preferred_element_type=f32`` in
the reference): the operands are widened to fp32 first, which is exact for
bf16.  Masks use the finite ``NEG_INF`` the reference uses, so a row whose
keys are all masked averages uniformly instead of producing NaN.

The CPU path runs these; on the card only ``chip_smoke.py`` calls them, to
hold each kernel against its twin.
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
