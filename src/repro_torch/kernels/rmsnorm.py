"""Fused RMSNorm: ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in fp32.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py:rmsnorm``
(``_rmsnorm_kernel``, pallas_call at :36).  The reference's models call the
same math as plain code (``repro/models/modules.py:rms_norm``); the port
sends every model norm (the block norms, the one before the head, and the
SSM blocks' inner norms) through this kernel when ``use_kernels`` is set.

The kernel is Triton (``_rmsnorm_triton.py``): one program per row loads the
whole row in fp32, reduces, scales and stores.  It is a single pass with no
reuse, so it is bound by bytes (each row read once and written once), and
one program per row keeps the row in registers between the two.  The
wrapper launches the kernel on CUDA tensors and raises on anything else;
``ops.rmsnorm`` chooses the plain twin where no kernel runs.
"""
from __future__ import annotations

import torch

from . import native


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D), scale (D,) -> same shape and dtype as x."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)}, want ({d},)")
    if scale.device != x.device:
        raise ValueError("rmsnorm: x and scale on different devices")
    # imported here: triton exists only where the card is
    from ._rmsnorm_triton import launch

    x2 = x.reshape(-1, d).contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0]:
        with torch.cuda.device(x.device):
            launch(x2, scale.contiguous(), out, eps)
        native.count_launch("rmsnorm")
    return out.reshape(x.shape)
