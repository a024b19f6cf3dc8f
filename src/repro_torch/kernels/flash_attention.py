"""Blocked causal / windowed GQA attention, forward (prefill and training)
and backward (training).

Wrappers of the CUDA kernels in ``csrc/flash_attention.cu``, which
replaces the Pallas kernel ``repro/kernels/flash_attention.py:flash_attention``,
and ``csrc/flash_attention_bwd.cu``, which the reference does not have (it
differentiates plain code, ``jax.value_and_grad`` at
``repro/models/steps.py:44``).  The sources' headers say how they are laid
out and what bounds them.

Under autograd (grad enabled and q, k or v requiring it) ``flash_attention``
goes through ``FlashAttentionFunction``: its forward launches the forward
kernel's variant that also writes each row's fp32 log-sum-exp and, in
bf16 up to head dim 128, the fp32 output before its rounding (O32), and
its backward launches ``flash_attention_bwd``, which recomputes the
probabilities from the log-sum-exp and takes each row's Delta =
rowsum(dO o O32) (on short bands, and past head dim 128 on every band,
sum_j P dP from its own first sweep instead, so no O32 is made there).
Both take every head dim the serving forward takes (up to 320: gemma3's
320 and MLA's 192 past 128 on tiles of their own,
``csrc/flash_attention_bwd.cu`` says how) and ``q_offset`` 0, with or
without a causal mask (whisper's encoder and cross-attention train without
one); a ``q_offset`` raises under grad.  Without grad the serving forward
runs, as before.  The wrappers launch the kernels on CUDA tensors and
raise on anything else;
``ops.flash_attention`` chooses the plain twin where no kernel runs.
"""
from __future__ import annotations

import ctypes

import torch

from . import native

SOURCE = "flash_attention.cu"
SOURCE_BWD = "flash_attention_bwd.cu"
MAX_HEAD_DIM = 320                      # gemma3: 2560 / 8; both kernels
O32_MAX_HEAD_DIM = 128                  # bf16 past it: Delta from the backward's own sweep
_ENTRY = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}
_ENTRY_LSE = {torch.bfloat16: "flash_attention_lse_bf16",
              torch.float32: "flash_attention_lse_f32"}
_ENTRY_BWD = {torch.bfloat16: "flash_attention_bwd_bf16",
              torch.float32: "flash_attention_bwd_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_ARGTYPES_LSE = {torch.bfloat16: ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
                                  + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
                 torch.float32: ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
                                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])}
_ARGTYPES_BWD = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float]
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, skv, hkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads are not a multiple "
                         f"of {hkv} kv heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} unsupported; the kernel "
                         f"takes 1..{MAX_HEAD_DIM}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "the kernel takes bfloat16 or float32, all alike")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")


def _forward(q, k, v, causal: bool, window: int, scale: float, q_offset: int,
             with_lse: bool):
    """The forward kernel; with ``with_lse`` its training variant (``q_offset``
    0), which also returns the fp32 log-sum-exp of each row's scaled scores,
    (B,Hq,Sq)."""
    return _launch(q, k, v, causal, window, scale, q_offset, with_lse)[:2]


def forward_for_training(q, k, v, causal: bool, window: int, scale: float):
    """The training forward (``q_offset`` 0): (out, lse, O32).  O32 is the
    fp32 output before its rounding to the input dtype (the output itself
    in fp32), normalised as ``csrc/flash_attention.cu`` says; the backward
    takes each row's Delta from it.  None in bf16 past ``O32_MAX_HEAD_DIM``,
    where the backward reads none."""
    return _launch(q, k, v, causal, window, scale, 0, True)


def _launch(q, k, v, causal, window, scale, q_offset, training):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = o32 = None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if training:
            lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
            bf16 = q.dtype == torch.bfloat16
            if not bf16:
                o32 = out
            elif d <= O32_MAX_HEAD_DIM:
                o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
            o32_arg = [None if o32 is None else o32.data_ptr()] if bf16 else []
            fn = native.function(SOURCE, _ENTRY_LSE[q.dtype], _ARGTYPES_LSE[q.dtype])
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     *o32_arg, b, sq, skv, hq, hkv, d, scale, int(causal), int(window), stream)
        else:
            fn = native.function(SOURCE, _ENTRY[q.dtype], _ARGTYPES)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, sq, skv, hq, hkv, d, scale, int(causal), int(window),
                     int(q_offset), skv, stream)
    native.check(SOURCE, err, "flash_attention")
    native.count_launch("flash_attention")
    return out, lse, o32


class FlashAttentionFunction(torch.autograd.Function):
    """The forward kernel's training variant; the backward kernel for the
    gradients.  In bf16 up to head dim 128 it keeps O32 for the backward, 4
    bytes an output element (64 MiB a layer at granite's 4 x 1024 tokens)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse, o32 = forward_for_training(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, lse, o32)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse, o32 = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, o32, causal=ctx.causal,
                                         window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,Hq,D); k, v (B,Skv,Hkv,D) -> (B,Sq,Hq,D); differentiable
    (through ``FlashAttentionFunction``) when grad is enabled and an input
    needs it."""
    _check(q, k, v)
    d = q.shape[-1]
    scale_ = scale if scale is not None else d ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q_offset:
            raise ValueError(f"flash_attention under grad: q_offset {q_offset}; the "
                             "backward kernel takes 0 (a training forward starts at 0)")
        return FlashAttentionFunction.apply(q, k, v, bool(causal), int(window), scale_)
    return _forward(q, k, v, causal, window, scale_, q_offset, False)[0]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor, o32: torch.Tensor, *, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """The gradients of ``flash_attention`` (``q_offset`` 0) at (q, k, v):
    ``do`` is the output's gradient, ``lse`` (B,Hq,Sq) fp32 the forward's
    log-sum-exp and ``o32`` (B,Sq,Hq,D) fp32 its output before rounding
    (``forward_for_training``; not read, and may be None, in bf16 past
    ``O32_MAX_HEAD_DIM``).  Returns (dq, dk, dv) in the inputs' dtype,
    summed in fp32; dk and dv sum over each kv head's query heads."""
    _check(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    o32_read = q.dtype != torch.bfloat16 or d <= O32_MAX_HEAD_DIM
    if (do.shape != q.shape or lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or (o32_read and (o32 is None or o32.shape != q.shape
                              or o32.dtype != torch.float32))):
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"{lse.dtype}, o32 "
                         f"{None if o32 is None else (tuple(o32.shape), o32.dtype)} do not "
                         f"match q {tuple(q.shape)}")
    if not (b and sq and skv):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do, lse = do.to(q.dtype).contiguous(), lse.contiguous()
    o32 = o32.contiguous() if o32_read else None
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)  # rowsum(dO o O32)
    scale_ = scale if scale is not None else d ** -0.5
    fn = native.function(SOURCE_BWD, _ENTRY_BWD[q.dtype], _ARGTYPES_BWD)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 o32.data_ptr() if o32_read else None, delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq, hkv, d, scale_, int(causal),
                 int(window), torch.cuda.current_stream().cuda_stream)
    native.check(SOURCE_BWD, err, "flash_attention_bwd")
    native.count_launch("flash_attention_bwd")
    return dq, dk, dv
