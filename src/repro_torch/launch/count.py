"""Operation and traffic counts of one eager call: the port's stand-in for
XLA's ``cost_analysis``.

    count(fn, *args, **kw) -> {"flops", "bytes", "ops", "bytes_by_device"}

- ``flops``: what ``torch.utils.flop_counter.FlopCounterMode`` counts, the
  matrix products (``mm``, ``bmm``, ``addmm``, convolutions, and every
  ``einsum`` through the products it lowers to), forward and, under
  autograd, backward.  Elementwise work is not counted, as the MODEL_FLOPS
  convention leaves it out too.
- ``bytes``: the input and output bytes of every aten op that is not a
  view and allocates no uninitialised memory, summed: the traffic of the
  eager program with no fusion, an upper bound of the same kind as XLA's
  raw "bytes accessed".  An indexed write into a tensor (``t[idx] = v``,
  a decode step's cache row) moves the indices and ``v`` in and ``v``'s
  bytes out, not the whole tensor.
- ``ops``: how many such aten ops ran (each is one kernel launch on the
  card, give or take a library's internal ones).

It counts on ``meta``, ``cpu`` and ``cuda`` tensors alike; on ``meta`` it
allocates nothing and needs no card.  It sees only what runs through aten:
the port's CUDA kernels are ``ctypes`` calls that it cannot look into, so
run the counted function on the plain path (``use_kernels=False``), which
computes the same function with the kernels' plain twins.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

_aten = torch.ops.aten
# ops that only allocate: nothing is read and nothing written
_ALLOCATE = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default}
# in-place indexed writes: self's untouched rows are neither read nor written
_WRITE_ROWS = {_aten.index_put_.default, _aten._index_put_impl_.default}


class _Traffic(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.by_device: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in _ALLOCATE:
            return out
        self.ops += 1
        moved = (args[1:], kwargs, args[2]) if func in _WRITE_ROWS else (args, kwargs, out)
        for t in tree_leaves(moved):
            if isinstance(t, torch.Tensor):
                n = t.numel() * t.element_size()
                self.bytes += n
                self.by_device[t.device.type] = self.by_device.get(t.device.type, 0) + n
        return out


def count(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once under both counters; returns the counts
    (the function's result is dropped)."""
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    with flops, traffic:
        fn(*args, **kw)
    return {"flops": float(flops.get_total_flops()), "bytes": float(traffic.bytes),
            "ops": traffic.ops, "bytes_by_device": dict(traffic.by_device)}
