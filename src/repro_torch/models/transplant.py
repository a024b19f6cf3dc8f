"""Load the reference package's parameters into the port.

The reference keeps parameters as a nested dict of arrays.  ``transplant``
takes that tree with every leaf already converted to a numpy array (the
caller does ``jax.tree_util.tree_map(np.asarray, params)``; this module
imports no JAX) and returns the same tree of torch tensors: the same key
paths, the same einsum layouts (``wq (d,h,k)``, ``wo (h,k,d)``,
``w_gate``/``w_up (d,f)``, ``w_down (f,d)``; Mamba2's ``conv_w (k,C)``,
sLSTM's per-head ``r_* (h,hd,hd)``) and the same leading stacked
``n_groups`` dimension on every ``phase*`` leaf (zamba2's tied ``shared``
block has none).  A tree with tied embeddings (gemma3) carries ``embed``
and no ``lm_head``, as the reference's does.
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
