"""Chunked Mamba2 SSD scan (one B/C group), for the zamba2 prefill.

Wrapper of the CUDA kernel in ``csrc/ssm_scan.cu``, which replaces the
Pallas kernel ``repro/kernels/ssm_scan.py:ssm_scan``.  The source's header
says how it is laid out and what bounds it: bf16 inputs take the
tensor-core path (three launches, with scratch this wrapper allocates),
fp32 inputs the CUDA-core kernel.  The wrapper launches the kernels on
CUDA tensors and raises on anything else; ``ops.ssm_scan`` chooses the
plain twin (``ops.ssd_chunked``) where no kernel runs.
Under grad it raises (``native.refuse_grad``): its backward kernel is
not written yet, so zamba2 trains on the card only with
``use_kernels=False``.
"""
from __future__ import annotations

import ctypes

import torch

from . import native

SOURCE = "ssm_scan.cu"
MAX_STATE = 128
MAX_HEAD_P_BF16 = 256                   # the bf16 path stages a chunk's x rows whole
_ENTRY = {torch.bfloat16: "ssm_scan_bf16", torch.float32: "ssm_scan_f32"}
_ARGTYPES = {torch.float32: [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
             torch.bfloat16: [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor):
    """x (B,S,H,P); dt (B,S,H); A (H,); Bm, Cm (B,S,N) -> (y (B,S,H,P) in
    x.dtype, h_final (B,H,P,N) fp32).

    The kernels take no chunk length: they use their own (64 rows), and the
    chunked form is exact for every chunk length (the config's chunk is a
    TPU tile size that only the twin uses)."""
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for device {x.device}")
    b, s, h, p = x.shape
    native.refuse_grad("ssm_scan", "2.2", x, dt, A, Bm, Cm)
    n = Bm.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or Bm.shape != (b, s, n) or Cm.shape != Bm.shape:
        raise ValueError(f"ssm_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)} "
                         "do not match")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssm_scan: state size {n} unsupported; the kernel takes "
                         f"1..{MAX_STATE}")
    if x.dtype not in _ENTRY or any(t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise TypeError(f"ssm_scan: dtypes {x.dtype}/{dt.dtype}/{Bm.dtype}/{Cm.dtype}; the "
                        "kernel takes bfloat16 or float32 x, dt, B, C, all alike")
    if x.dtype == torch.bfloat16 and p > MAX_HEAD_P_BF16:
        raise ValueError(f"ssm_scan: head width P {p} unsupported in bfloat16; the kernel "
                         f"takes 1..{MAX_HEAD_P_BF16}")
    if not all(t.device == x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("ssm_scan: inputs on different devices")
    x, dt, Bm, Cm = x.contiguous(), dt.contiguous(), Bm.contiguous(), Cm.contiguous()
    a32 = A.float().contiguous()            # the reference casts A to fp32 too
    y = torch.empty_like(x)
    h_final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    fn = native.function(SOURCE, _ENTRY[x.dtype], _ARGTYPES[x.dtype])
    ptrs = [x.data_ptr(), dt.data_ptr(), a32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), h_final.data_ptr()]
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            size = native.function(SOURCE, "ssm_scan_bf16_scratch", [ctypes.c_int] * 5,
                                   ctypes.c_longlong)(b, s, h, p, n)
            scratch = torch.empty(size, dtype=torch.float32, device=x.device)
            ptrs.append(scratch.data_ptr())
        err = fn(*ptrs, b, s, h, p, n, torch.cuda.current_stream().cuda_stream)
    native.check(SOURCE, err, "ssm_scan")
    native.count_launch("ssm_scan")
    return y, h_final
