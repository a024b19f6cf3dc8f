"""Blocked causal / windowed GQA attention forward, for prefill.

Wrapper of the CUDA kernel in ``csrc/flash_attention.cu``, which replaces
the Pallas kernel ``repro/kernels/flash_attention.py:flash_attention``.  The
source's header says how it is laid out and what bounds it.  The wrapper
launches the kernel on CUDA tensors and raises on anything else;
``ops.flash_attention`` chooses the plain twin where no kernel runs.
"""
from __future__ import annotations

import ctypes

import torch

from . import native

SOURCE = "flash_attention.cu"
MAX_HEAD_DIM = 128
_ENTRY = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,Hq,D); k, v (B,Skv,Hkv,D) -> (B,Sq,Hq,D)."""
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    scale_ = scale if scale is not None else d ** -0.5
    fn = native.function(SOURCE, _ENTRY[q.dtype], _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, skv, hq, hkv, d, scale_, int(causal), int(window),
                 int(q_offset), skv, torch.cuda.current_stream().cuda_stream)
    native.check(SOURCE, err, "flash_attention")
    native.count_launch("flash_attention")
    return out
