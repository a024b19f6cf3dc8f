"""Input, cache and optimizer sharding specs, counterpart of
``repro.launch.shardings``.

Params and decode caches use ``models.sharding``'s rule tables (the cache
rule, ``cache_shardings``, is re-exported here: batch over pod+data,
heads/state over model); this module covers the rest: data batches (batch
dim over pod+data) and optimizer state (params' spec, optionally ZeRO-1
sharded over data).  Each function returns a fitted
``P`` per leaf of the tree it is given (any leaf with a ``shape``).

A rank takes its block of a leaf under such a spec, and rebuilds the
whole leaf, through ``models.sharding.local_slice`` and ``gather_leaf``.
"""
from __future__ import annotations

from typing import Any

from ..models import sharding as msh
from ..models.sharding import P, cache_shardings  # noqa: F401  (the cache rule)
from ..optim import adamw


def _axes(mesh, logical) -> Any:
    mesh_axes = msh.axis_table().get(logical, (logical,) if logical else None)
    if mesh_axes is None:
        return None
    present = tuple(a for a in mesh_axes if a in mesh.axis_names)
    return present if len(present) > 1 else (present[0] if present else None)


def _batch_ways(mesh) -> int:
    return msh.axis_size(mesh, _axes(mesh, "batch"))


def batch_shardings(batch_spec: Any, mesh) -> Any:
    """Every batch leaf: dim0 = batch over (pod, data); a batch whose dim 0
    the batch ways do not divide (long_500k's b=1) stays unsharded."""
    ways = _batch_ways(mesh)

    def f(leaf):
        shape = tuple(leaf.shape)
        ax = _axes(mesh, "batch") if shape and shape[0] % ways == 0 else None
        return P(*((ax,) + (None,) * (len(shape) - 1)))
    return msh.map_with_path(lambda path, leaf: f(leaf), batch_spec)


def opt_shardings(opt_spec: Any, params_spec_tree: Any, mesh, *, zero1: bool = False) -> dict:
    """mu/nu follow the param sharding; ZeRO-1 additionally shards the first
    unsharded dim that the data axis divides (and is no shorter than) over
    it.  ``opt_spec`` is unused, as in the reference: the moments mirror
    the parameters."""
    param_sh = msh.param_shardings(params_spec_tree, mesh)

    def zero_ify(spec: P, leaf):
        if not zero1 or "data" not in mesh.axis_names:
            return spec
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        data_n = mesh.shape["data"]
        for i, (ax, dim) in enumerate(zip(entries, leaf.shape)):
            if ax is None and dim >= data_n and dim % data_n == 0:
                entries[i] = "data"
                return P(*entries)
        return spec

    mu = adamw.tree_map(zero_ify, param_sh, params_spec_tree)
    return {"mu": mu, "nu": mu, "step": P()}
