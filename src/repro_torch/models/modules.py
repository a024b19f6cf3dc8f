"""Initialisers and elementwise pieces shared by the model modules.

Counterpart of ``repro.models.modules``.  ``dense_init`` draws from a
``torch.Generator`` and therefore never reproduces the reference's JAX
random stream: parity with the reference goes through
``models.transplant``, which loads the reference's own parameters.
``split_mlp`` is the MLP under tensor parallelism, shared by the dense
MLP (``blocks``) and the MoE layer's shared experts (``moe``).
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from . import sharding as msh


def dense_init(shape: Sequence[int], *, generator: torch.Generator | None,
               fan_in: int | None = None, dtype: torch.dtype = torch.float32,
               device="cuda") -> torch.Tensor:
    """Normal truncated at +-2 std, scaled by 1/sqrt(fan_in) (LeCun-ish).

    The draw happens in fp32 on ``device`` (the generator must live there
    too) and is cast to ``dtype`` afterwards.  On ``meta``, which draws
    nothing, ``generator`` is None."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, computed in fp32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def swiglu(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * x


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = F.relu(x)
    return r * r


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Callable] = {
    "swiglu": swiglu,  # handled specially (two-input) in layers
    "gelu": gelu,
    "squared_relu": squared_relu,
    "silu": F.silu,
}


def split_mlp(p: dict, x: torch.Tensor, d: int, f: int, act: str,
              names: Sequence[str] = ("w_gate", "w_up", "w_down")) -> tuple:
    """(out, its layout on the model axis): an MLP of width ``f`` under
    tensor parallelism on this rank's blocks of its leaves ``names`` (gate,
    up, down; the gate only under ``swiglu``).  ``x`` (.., d) is whole and
    has come through ``copy``.  Up and gate are column parallel and down
    row parallel, which gives a partial sum; a block split on D instead
    gives a partial sum, reduced before the activation, or a split
    output."""
    gate, up_name, down = names
    spec = ("batch", None, "model")

    def up(name):
        t, layout = msh.project("...d,df->...f", x, msh.WHOLE, p[name], (d, f), op=torch.matmul)
        return msh.constrain(t, *spec, layout=layout)

    h = up(up_name)
    h = swiglu(h, up(gate)) if act == "swiglu" else ACTIVATIONS[act](h)
    layout = msh.fitted_layout((*h.shape[:-1], f), *spec)
    h = msh.constrain(h, *spec, layout=layout)
    split = layout.dim is not None                       # h on this rank's block of f
    return msh.project("...f,fd->...d", h if split else msh.copy(h), layout, p[down], (f, d),
                       op=torch.matmul)


def require_device(device) -> torch.device:
    """Resolve ``device``; a CUDA device on a host without one raises here
    rather than deep inside a kernel wrapper (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not "
                           "available; pass device='cpu' to run the plain path")
    return dev
