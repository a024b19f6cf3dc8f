"""Fused RMSNorm: ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in fp32.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py:rmsnorm``
(``_rmsnorm_kernel``, pallas_call at :36).  The reference's models call the
same math as plain code (``repro/models/modules.py:rms_norm``); the port
sends every model norm (the block norms, the one before the head, and the
SSM blocks' inner norms) through this kernel when ``use_kernels`` is set.

The kernels are Triton (``_rmsnorm_triton.py``).  Forward: one program per
row loads the whole row in fp32, reduces, scales and stores.  It is a
single pass with no reuse, so it is bound by bytes (each row read once and
written once), and one program per row keeps the row in registers between
the two.

Under autograd (grad enabled and x or scale requiring it) the call goes
through ``RMSNormFunction``: the forward also stores each row's fp32
``1/rms``, and the backward launches ``rmsnorm_bwd``, which the reference
does not have (it differentiates the plain code, ``jax.value_and_grad`` at
``repro/models/steps.py:44``).  It is a row reduction (dx) plus a column
reduction (dscale), both bound by bytes: one pass over the rows writes dx
and one fp32 partial row of dscale per program, and a second pass sums the
partials, with no atomics, so the result repeats run to run.  The wrappers
launch the kernels on CUDA tensors and raise on anything else;
``ops.rmsnorm`` chooses the plain twin where no kernel runs.
"""
from __future__ import annotations

import torch

from . import native


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)}, want ({d},)")
    if scale.device != x.device:
        raise ValueError("rmsnorm: x and scale on different devices")
    return d


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float, with_rstd: bool):
    d = _check(x, scale)
    # imported here: triton exists only where the card is
    from ._rmsnorm_triton import launch

    x2 = x.reshape(-1, d).contiguous()
    out = torch.empty_like(x2)
    rstd = torch.empty(x2.shape[0], dtype=torch.float32, device=x.device) if with_rstd else None
    if x2.shape[0]:
        with torch.cuda.device(x.device):
            launch(x2, scale.contiguous(), out, eps, rstd)
        native.count_launch("rmsnorm")
    return out.reshape(x.shape), rstd


class RMSNormFunction(torch.autograd.Function):
    """The forward kernel, keeping each row's fp32 ``1/rms``; the backward
    kernel for the gradients."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        out, rstd = _forward(x, scale, eps, True)
        ctx.save_for_backward(x, scale, rstd)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g, rstd, eps=ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D), scale (D,) -> same shape and dtype as x; differentiable
    (through ``RMSNormFunction``) when grad is enabled and an input needs it."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFunction.apply(x, scale, eps)
    return _forward(x, scale, eps, False)[0]


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, rstd: torch.Tensor,
                *, eps: float = 1e-6):
    """The gradients of ``rmsnorm`` at (x, scale) for the output gradient
    ``g``, given the forward's fp32 ``rstd`` (one per row; ``eps`` is in it
    already) -> (dx like x, dscale like scale)."""
    d = _check(x, scale)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"rmsnorm_bwd: gradient {tuple(g.shape)} on {g.device}, "
                         f"want {tuple(x.shape)} on {x.device}")
    from ._rmsnorm_triton import launch_bwd

    x2 = x.reshape(-1, d).contiguous()
    g2 = g.to(x.dtype).reshape(-1, d).contiguous()
    if rstd.shape != (x2.shape[0],) or rstd.dtype != torch.float32:
        raise ValueError(f"rmsnorm_bwd: rstd {tuple(rstd.shape)} {rstd.dtype}, "
                         f"want ({x2.shape[0]},) float32")
    dx = torch.empty_like(x2)
    # the column pass writes every entry of dscale; no rows, no launch: zero
    dscale = (torch.empty if x2.shape[0] else torch.zeros)(d, dtype=scale.dtype,
                                                          device=x.device)
    if x2.shape[0]:
        with torch.cuda.device(x.device):
            launch_bwd(x2, scale.contiguous(), g2, rstd.contiguous(), dx, dscale)
        native.count_launch("rmsnorm_bwd")
    return dx.reshape(x.shape), dscale
