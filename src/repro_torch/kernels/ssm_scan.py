"""Chunked Mamba2 SSD scan (one B/C group), for zamba2, both ways.

Wrapper of the CUDA kernel in ``csrc/ssm_scan.cu``, which replaces the
Pallas kernel ``repro/kernels/ssm_scan.py:ssm_scan``, and of its backward
in ``csrc/ssm_scan_bwd.cu`` (no TPU kernel: the reference differentiates
its plain chunked form).  The sources' headers say how they are laid out
and what bounds them: bf16 inputs take the tensor-core paths (three
launches forward on ``mma.sync``; three backward on ``wgmma``: the state
walks, the chunk pass over head groups, the sums; four, the mma.sync
passes, past P 128), with scratch this wrapper allocates, fp32 inputs the
CUDA-core kernels.  The wrappers launch the kernels on
CUDA tensors and raise on anything else; ``ops.ssm_scan`` and
``ops.ssm_scan_bwd`` choose the plain twins (``ops.ssd_chunked`` and
autograd of it, ``ref.ssm_scan_bwd_ref``) where no kernel runs.  Under
grad the forward runs through ``SsmScanFunction``, whose backward is the
backward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import native

SOURCE = "ssm_scan.cu"
SOURCE_BWD = "ssm_scan_bwd.cu"
MAX_STATE = 128
MAX_HEAD_P_BF16 = 256                   # the bf16 path stages a chunk's x rows whole
_ENTRY = {torch.bfloat16: "ssm_scan_bf16", torch.float32: "ssm_scan_f32"}
_ARGTYPES = {torch.float32: [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
             torch.bfloat16: [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
_ENTRY_BWD = {torch.bfloat16: "ssm_scan_bwd_bf16", torch.float32: "ssm_scan_bwd_f32"}
_ARGTYPES_BWD = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(x, dt, A, Bm, Cm) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for device {x.device}")
    b, s, h, p = x.shape
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


def _forward(x, dt, A, Bm, Cm):
    b, s, h, p = x.shape
    n = Bm.shape[-1]
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


class SsmScanFunction(torch.autograd.Function):
    """The forward kernel; the backward kernel for the gradients of both
    outputs (``h_final``'s may be None).  Saves the inputs only: the
    backward reruns the forward's states (``csrc/ssm_scan_bwd.cu``)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return _forward(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssm_scan_bwd(x, dt, A, Bm, Cm, dy, dh_final)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor):
    """x (B,S,H,P); dt (B,S,H); A (H,); Bm, Cm (B,S,N) -> (y (B,S,H,P) in
    x.dtype, h_final (B,H,P,N) fp32); differentiable (through
    ``SsmScanFunction``) when grad is enabled and an input needs it.

    The kernels take no chunk length: they use their own (64 rows), and the
    chunked form is exact for every chunk length (the config's chunk is a
    TPU tile size that only the twin uses)."""
    _check(x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return SsmScanFunction.apply(x, dt, A, Bm, Cm)
    return _forward(x, dt, A, Bm, Cm)


def ssm_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, dy: torch.Tensor, dh_final: torch.Tensor | None = None):
    """The gradients of ``ssm_scan`` at (x, dt, A, Bm, Cm): ``dy`` is y's
    gradient, ``dh_final`` (B,H,P,N) h_final's (None: zero).  Returns (dx,
    ddt, dA, dB, dC), each in its input's dtype (dA in A's), summed in fp32;
    dB and dC sum over the heads, dA over rows and positions.  One launch
    counted, whatever passes the kernel runs."""
    _check(x, dt, A, Bm, Cm)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if dy.shape != x.shape or (dh_final is not None and dh_final.shape != (b, h, p, n)):
        raise ValueError(f"ssm_scan_bwd: dy {tuple(dy.shape)}, dh_final "
                         f"{None if dh_final is None else tuple(dh_final.shape)} do not match "
                         f"x {tuple(x.shape)}, N {n}")
    bf16 = int(x.dtype == torch.bfloat16)
    if not native.function(SOURCE_BWD, "ssm_scan_bwd_supported", [ctypes.c_int] * 3)(p, n, bf16):
        raise ValueError(f"ssm_scan_bwd: head width P {p} with state size {n} unsupported in "
                         f"{x.dtype}: the chunk pass's tiles exceed a block's shared memory")
    if not (b and s):
        return (torch.zeros_like(x), torch.zeros_like(dt), torch.zeros_like(A),
                torch.zeros_like(Bm), torch.zeros_like(Cm))
    x, dt, Bm, Cm = x.contiguous(), dt.contiguous(), Bm.contiguous(), Cm.contiguous()
    dy = dy.to(x.dtype).contiguous()
    dhf = None if dh_final is None else dh_final.float().contiguous()
    a32 = A.float().contiguous()
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (x, dt, Bm, Cm))
    dA = torch.empty(h, dtype=torch.float32, device=x.device)
    fn = native.function(SOURCE_BWD, _ENTRY_BWD[x.dtype], _ARGTYPES_BWD)
    with torch.cuda.device(x.device):
        size = native.function(SOURCE_BWD, "ssm_scan_bwd_scratch", [ctypes.c_int] * 6,
                               ctypes.c_longlong)(b, s, h, p, n, bf16)
        scratch = torch.empty(size, dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), dt.data_ptr(), a32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 dy.data_ptr(), None if dhf is None else dhf.data_ptr(), dx.data_ptr(),
                 ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), scratch.data_ptr(),
                 b, s, h, p, n, torch.cuda.current_stream().cuda_stream)
    native.check(SOURCE_BWD, err, "ssm_scan_bwd")
    native.count_launch("ssm_scan_bwd")
    return dx, ddt, dA.to(A.dtype), dB, dC
