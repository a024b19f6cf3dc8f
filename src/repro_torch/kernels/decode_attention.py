"""Single-token GQA decode attention over a padded KV cache.

Wrapper of the CUDA kernel in ``csrc/decode_attention.cu``, which replaces
the Pallas kernel ``repro/kernels/decode_attention.py:decode_attention``.
The source's header says how it is laid out and what bounds it.  The
wrapper launches the kernel on CUDA tensors (caches longer than
``SPLIT_KEYS`` rows are split across blocks and merged by a second, small
kernel: one call, one count) and raises on anything else;
``ops.decode_attention`` chooses the plain twin where no kernel runs.
Under grad it raises (``native.refuse_grad``): it has no backward kernel,
and no training path decodes.
"""
from __future__ import annotations

import ctypes

import torch

from . import native

SOURCE = "decode_attention.cu"
MAX_HEAD_DIM = 320                      # gemma3: 2560 / 8
MAX_GROUP = 16
# keys per split: a block of the kernel walks at most this many keys of one
# row; caches longer than this are split and merged by a second kernel
SPLIT_KEYS = 512
_ENTRY = {torch.bfloat16: "decode_attention_bf16", torch.float32: "decode_attention_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_void_p])


def n_splits(s: int) -> int:
    """Splits of a cache of S rows: from S alone, never from the lengths,
    so the wrapper reads nothing back from the card."""
    return max(1, -(-s // SPLIT_KEYS))


def _row_heads(t: torch.Tensor) -> int | None:
    """The heads a row of the cache ``t`` (B,S,Hkv,D) holds in memory, Hs:
    Hkv for a contiguous cache, more for a range of a larger cache's heads
    (a ``narrow`` on dim 2, which the kernel reads in place).  None for any
    other layout (the wrapper makes it contiguous)."""
    b, s, hkv, d = t.shape
    if t.stride(3) != 1 or t.stride(2) != d or t.stride(1) % d:
        return None
    hs = t.stride(1) // d
    return hs if hs >= hkv and (b == 1 or t.stride(0) == s * hs * d) else None


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """q (B,Hq,D); caches (B,S,Hkv,D); cache_len (B,) valid lengths, each
    >= 1 -> (B,Hq,D).  The caches are read in place where each is a range
    of a contiguous cache's heads (``_row_heads``), alike for k and v."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    b, hq, d = q.shape
    native.refuse_grad("decode_attention", "2.4", q, k_cache, v_cache)
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (b, s, hkv, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)} do not match")
    if cache_len.shape != (b,):
        raise ValueError(f"decode_attention: cache_len shape {tuple(cache_len.shape)}, "
                         f"want ({b},)")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {hq} query heads over {hkv} kv heads; "
                         f"the kernel takes whole groups of at most {MAX_GROUP}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {d} unsupported; the kernel "
                         f"takes 1..{MAX_HEAD_DIM}")
    if q.dtype not in _ENTRY or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}; the kernel takes bfloat16 or float32, all alike")
    if not (k_cache.device == v_cache.device == cache_len.device == q.device):
        raise ValueError("decode_attention: inputs on different devices")
    hs = _row_heads(k_cache)
    if hs is None or _row_heads(v_cache) != hs:
        k_cache, v_cache, hs = k_cache.contiguous(), v_cache.contiguous(), hkv
    q = q.contiguous()
    lens = cache_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    n = n_splits(s)
    scratch = (None, None)          # one split writes the output directly
    if n > 1:                       # per split and query head: acc[D]; m, l
        part_acc = torch.empty((b, hq, n, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b, hq, n, 2), dtype=torch.float32, device=q.device)
        scratch = (part_acc.data_ptr(), part_ml.data_ptr())
    scale_ = scale if scale is not None else d ** -0.5
    fn = native.function(SOURCE, _ENTRY[q.dtype], _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), *scratch, b, s, hq, hkv, hs, d, SPLIT_KEYS, scale_,
                 torch.cuda.current_stream().cuda_stream)
    native.check(SOURCE, err, "decode_attention")
    native.count_launch("decode_attention")
    return out
