"""Chunked, stabilised mLSTM scan, for the xlstm full-sequence forward, both ways.

Wrapper of the CUDA kernel in ``csrc/mlstm_scan.cu``, which replaces the
Pallas kernel ``repro/kernels/mlstm_scan.py:mlstm_scan``, and of its
backward in ``csrc/mlstm_scan_bwd.cu`` (no TPU kernel: the reference
differentiates its plain chunked form).  The sources' headers say how they
are laid out and what bounds them: bf16 inputs take the tensor-core paths
(three launches forward, with scratch this wrapper allocates; backward
five launches on ``wgmma`` at head dim 512, eight on ``mma.sync`` at every
other head dim), fp32 inputs the CUDA-core kernel forward and fp32
products backward.  Like the TPU kernel the forward returns y only, no carried
state.  The wrappers launch the kernels on CUDA tensors and raise on
anything else; ``ops.mlstm_scan`` and ``ops.mlstm_scan_bwd`` choose the
plain twins (``ops.mlstm_chunked`` and autograd of it,
``ref.mlstm_scan_bwd_ref``) where no kernel runs.  Under grad the forward
runs through ``MlstmScanFunction``, whose backward is the backward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import native

SOURCE = "mlstm_scan.cu"
SOURCE_BWD = "mlstm_scan_bwd.cu"
MAX_HEAD_DIM = 1024
_ENTRY = {torch.bfloat16: "mlstm_scan_bf16", torch.float32: "mlstm_scan_f32"}
_ARGTYPES = {torch.float32: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p],
             torch.bfloat16: [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p]}
_ENTRY_BWD = {torch.bfloat16: "mlstm_scan_bwd_bf16", torch.float32: "mlstm_scan_bwd_f32"}
_ARGTYPES_BWD = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def _check(q, k, v, logi, logf, what: str = "mlstm_scan") -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or logi.shape != (b, s, h) \
            or logf.shape != (b, s, h):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, logi {tuple(logi.shape)}, "
                         f"logf {tuple(logf.shape)} do not match")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {d} unsupported; the kernel takes "
                         f"1..{MAX_HEAD_DIM}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
                        "takes bfloat16 or float32 q, k, v, all alike")
    if not logi.is_floating_point() or not logf.is_floating_point():
        raise TypeError(f"{what}: the gates must be floating point")
    if not all(t.device == q.device for t in (k, v, logi, logf)):
        raise ValueError(f"{what}: inputs on different devices")


def _forward(q, k, v, logi, logf):
    b, s, h, d = q.shape
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


class MlstmScanFunction(torch.autograd.Function):
    """The forward kernel; the backward kernel for y's gradient.  Saves the
    inputs only: the backward reruns the forward's states
    (``csrc/mlstm_scan_bwd.cu``)."""

    @staticmethod
    def forward(ctx, q, k, v, logi, logf):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, logi, logf)
        return _forward(q, k, v, logi, logf)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return (None,) * 5
        grads = mlstm_scan_bwd(*ctx.saved_tensors, dy)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logi: torch.Tensor,
               logf: torch.Tensor) -> torch.Tensor:
    """q, k, v (B,S,H,D); logi, logf (B,S,H) log-space gates (taken in fp32,
    as the reference casts them) -> y (B,S,H,D) in q.dtype; differentiable
    (through ``MlstmScanFunction``) when grad is enabled and an input needs
    it.

    The kernels take no chunk length: they use their own (64 rows), and y is
    exact for every chunk length and invariant to the stabiliser (the
    config's chunk is a TPU tile size that only the twin uses)."""
    _check(q, k, v, logi, logf)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, logi, logf)):
        return MlstmScanFunction.apply(q, k, v, logi, logf)
    return _forward(q, k, v, logi, logf)


def mlstm_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logi: torch.Tensor,
                   logf: torch.Tensor, dy: torch.Tensor):
    """The gradients of ``mlstm_scan`` at (q, k, v, logi, logf) for y's
    gradient ``dy``.  Returns (dq, dk, dv, dlogi, dlogf), each in its input's
    dtype, summed in fp32.  One launch counted, whatever passes the kernel
    runs.  The passes follow from the shape alone: bf16 at head dim 512
    (xlstm's) takes the ``wgmma`` passes (``mlstm_bwd_tc_*``), every other
    bf16 head dim and fp32 the mma.sync / FMA passes (``mlstm_bwd_*``); an input whose
    storage is not 16-byte aligned is copied first."""
    _check(q, k, v, logi, logf, "mlstm_scan_bwd")
    b, s, h, d = q.shape
    if dy.shape != q.shape:
        raise ValueError(f"mlstm_scan_bwd: dy {tuple(dy.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not (b and s):
        return (torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v),
                torch.zeros_like(logi), torch.zeros_like(logf))
    q, k, v, dy = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q.contiguous(), k.contiguous(), v.contiguous(),
                             dy.to(q.dtype).contiguous()))
    li, lf = logi.float().contiguous(), logf.float().contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dli, dlf = torch.empty_like(li), torch.empty_like(lf)
    fn = native.function(SOURCE_BWD, _ENTRY_BWD[q.dtype], _ARGTYPES_BWD)
    with torch.cuda.device(q.device):
        size = native.function(SOURCE_BWD, "mlstm_scan_bwd_scratch", [ctypes.c_int] * 5,
                               ctypes.c_longlong)(b, s, h, d, int(q.dtype == torch.bfloat16))
        scratch = torch.empty(size, dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(), lf.data_ptr(),
                 dy.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dli.data_ptr(),
                 dlf.data_ptr(), scratch.data_ptr(), b, s, h, d, d ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
    native.check(SOURCE_BWD, err, "mlstm_scan_bwd")
    native.count_launch("mlstm_scan_bwd")
    return dq, dk, dv, dli.to(logi.dtype), dlf.to(logf.dtype)
