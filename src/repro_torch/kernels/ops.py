"""Dispatch layer: the entry points model code calls.

Counterpart of ``repro.kernels.ops``.  ``use_kernel`` comes from
``ArchConfig.use_kernels``.  This is the one place that chooses between a
kernel and its plain twin in ``ref``: the twin runs when ``use_kernel`` is
false or the tensor lies on the CPU (where no kernel exists); otherwise the
call goes to the kernel's wrapper and nothing else, which launches the
kernel or raises.  No path catches a build or launch error.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .rmsnorm import rmsnorm as _rmsnorm_kernel


def _plain(use_kernel: bool, x: torch.Tensor) -> bool:
    return not use_kernel or x.device.type == "cpu"


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            use_kernel: bool = False) -> torch.Tensor:
    if _plain(use_kernel, x):
        return ref.rmsnorm_ref(x, scale, eps)
    return _rmsnorm_kernel(x, scale, eps=eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: float | None = None,
                    use_kernel: bool = False) -> torch.Tensor:
    if _plain(use_kernel, q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale, q_offset=q_offset)
    return _flash_kernel(q, k, v, causal=causal, window=window,
                         scale=scale, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_len, *, scale: float | None = None,
                     use_kernel: bool = False) -> torch.Tensor:
    if _plain(use_kernel, q):
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len, scale=scale)
    return _decode_kernel(q, k_cache, v_cache, cache_len, scale=scale)
