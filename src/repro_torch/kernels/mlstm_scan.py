"""Chunked, stabilised mLSTM scan, for the xlstm full-sequence forward.

Wrapper of the CUDA kernel in ``csrc/mlstm_scan.cu``, which replaces the
Pallas kernel ``repro/kernels/mlstm_scan.py:mlstm_scan``.  The source's
header says how it is laid out and what bounds it: bf16 inputs take the
tensor-core path (three launches, with scratch this wrapper allocates),
fp32 inputs the CUDA-core kernel.  Like the TPU kernel it
returns y only, no carried state.  The wrapper launches the kernel on CUDA
tensors and raises on anything else; ``ops.mlstm_scan`` chooses the plain
twin (``ops.mlstm_chunked``) where no kernel runs.
"""
from __future__ import annotations

import ctypes

import torch

from . import native

SOURCE = "mlstm_scan.cu"
MAX_HEAD_DIM = 1024
_ENTRY = {torch.bfloat16: "mlstm_scan_bf16", torch.float32: "mlstm_scan_f32"}
_ARGTYPES = {torch.float32: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p],
             torch.bfloat16: [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p]}


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logi: torch.Tensor,
               logf: torch.Tensor) -> torch.Tensor:
    """q, k, v (B,S,H,D); logi, logf (B,S,H) log-space gates (taken in fp32,
    as the reference casts them) -> y (B,S,H,D) in q.dtype.

    The kernels take no chunk length: they use their own (64 rows), and y is
    exact for every chunk length and invariant to the stabiliser (the
    config's chunk is a TPU tile size that only the twin uses)."""
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan: no kernel for device {q.device}")
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or logi.shape != (b, s, h) \
            or logf.shape != (b, s, h):
        raise ValueError(f"mlstm_scan: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, logi {tuple(logi.shape)}, "
                         f"logf {tuple(logf.shape)} do not match")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"mlstm_scan: head_dim {d} unsupported; the kernel takes "
                         f"1..{MAX_HEAD_DIM}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"mlstm_scan: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
                        "takes bfloat16 or float32 q, k, v, all alike")
    if not logi.is_floating_point() or not logf.is_floating_point():
        raise TypeError("mlstm_scan: the gates must be floating point")
    if not all(t.device == q.device for t in (k, v, logi, logf)):
        raise ValueError("mlstm_scan: inputs on different devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    li, lf = logi.float().contiguous(), logf.float().contiguous()
    y = torch.empty_like(q)
    fn = native.function(SOURCE, _ENTRY[q.dtype], _ARGTYPES[q.dtype])
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(), lf.data_ptr(), y.data_ptr()]
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            size = native.function(SOURCE, "mlstm_scan_bf16_scratch", [ctypes.c_int] * 3,
                                   ctypes.c_longlong)(b, s, h)
            scratch = torch.empty(size, dtype=torch.float32, device=q.device)
            ptrs.append(scratch.data_ptr())
        err = fn(*ptrs, b, s, h, d, d ** -0.5, torch.cuda.current_stream().cuda_stream)
    native.check(SOURCE, err, "mlstm_scan")
    native.count_launch("mlstm_scan")
    return y
