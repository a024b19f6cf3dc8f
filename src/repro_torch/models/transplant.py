"""Load the reference package's parameters into the port.

The reference keeps parameters as a nested dict of arrays.  ``transplant``
takes that tree with every leaf already converted to a numpy array (the
caller does ``jax.tree_util.tree_map(np.asarray, params)``; this module
imports no JAX) and returns the same tree of torch tensors: the same key
paths, the same einsum layouts (``wq (d,h,k)``, ``wo (h,k,d)``,
``w_gate``/``w_up (d,f)``, ``w_down (f,d)``; Mamba2's ``conv_w (k,C)``,
sLSTM's per-head ``r_* (h,hd,hd)``; MoE's fp32 ``router (d,E)``,
``experts_gate``/``experts_up (E,d,f)``, ``experts_down (E,f,d)``,
``shared_gate``/``shared_up (d,fs)``, ``shared_down (fs,d)``; MLA's
``w_uq (d,h,dn)``, ``w_qr (d,h,dr)``, ``w_dkv (d,r+dr)``, ``w_uk (r,h,dn)``,
``w_uv (r,h,dv)``, ``wo (h,dv,d)``) and the same leading stacked
``n_groups`` dimension on every ``phase*`` leaf (zamba2's tied ``shared``
block has none; deepseek's dense layer 0 is ``phase0`` with one group).
A tree with tied embeddings (gemma3) carries ``embed`` and no
``lm_head``, as the reference's does.  Whisper's tree carries, in each
decoder slot, ``norm_x (d,)`` and ``cross`` (``wq``/``wk``/``wv``/``wo`` in
the GQA layouts above), stacked like the slot, and ``encoder``: its
``encoder_layers`` global/MLP slots (``norm1``, ``mixer``, ``norm2``,
``ffn``) stacked on a leading dimension of that size.  Qwen2-VL's tree is a
dense one; its vision tower is a stub in both packages.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .modules import require_device


def transplant(tree: Mapping[str, Any], *, device="cuda",
               dtype: torch.dtype | None = None) -> dict:
    """numpy tree -> torch tree on ``device``; floating leaves are cast to
    ``dtype`` when given (casting once at load gives the same numbers as
    the reference's per-call ``cast_tree``)."""
    dev = require_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a))       # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return {k: (transplant(v, device=dev, dtype=dtype) if isinstance(v, Mapping)
                else leaf(v)) for k, v in tree.items()}


def transplant_lenet(tree: Mapping[str, Any], *, device="cuda") -> dict:
    """The reference's LeNet tree (numpy leaves) -> the port's: conv ``w``
    goes from HWIO to OIHW (``permute(3, 2, 0, 1)``); every other leaf,
    ``fc*.w`` included, keeps its layout and key path (``models/lenet.py``
    flattens in the reference's NHWC order)."""
    out = transplant(tree, device=device)
    for name in ("conv1", "conv2"):
        out[name]["w"] = out[name]["w"].permute(3, 2, 0, 1).contiguous()
    return out
