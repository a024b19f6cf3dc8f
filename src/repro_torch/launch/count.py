"""Operation and traffic counts of one eager call: the port's stand-in for
XLA's ``cost_analysis``.

    count(fn, *args, **kw) -> {"flops", "bytes", "ops", "bytes_by_device", "collectives"}

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
- ``collectives``: the ``torch.distributed`` collectives the call ran
  (the ``c10d`` ops: ``c10d.allreduce_``, ``c10d.allgather_`` ...), kept
  out of ``bytes`` and ``ops``.  By kind, in the reference's names
  (``all-reduce``, ``all-gather`` ...): the calls and the bytes, in the
  reference's convention (``repro/launch/roofline.py`` ``collective_bytes``):
  each call's output buffer bytes, so an all-gather counts its whole
  output; and the same by the mesh axes of the group each ran over
  (``"model"``, ``"pod+data"``; the axes along which the group's ranks'
  coordinates differ on the active ``launch.mesh.Mesh``).  Barriers move
  no data and are left out.  A collective runs on real ranks (a ``gloo``
  or ``nccl`` group) or on ``meta`` tensors over a ``fake`` group that
  lives in one process (``launch/dryrun.py``'s counting mesh): both reach
  the same ``c10d`` ops.

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


# c10d op -> the reference's name of its kind (any other op keeps its own
# name); a barrier moves no data
_KINDS = {"allreduce_": "all-reduce", "allgather_": "all-gather",
          "_allgather_base_": "all-gather", "reduce_scatter_": "reduce-scatter",
          "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
          "alltoall_base_": "all-to-all", "broadcast_": "broadcast"}


def _group_axes(pg, mesh, memo: dict) -> str:
    """The mesh axes the group ``pg`` (a ``c10d`` op's boxed process
    group) spans: those on which its ranks' coordinates differ, joined by
    ``+`` in the mesh's order; ``"world"`` with no mesh to read."""
    import torch.distributed as dist
    group = dist.ProcessGroup.unbox(pg)
    name = group.group_name
    if name not in memo:
        layout = getattr(getattr(mesh, "device_mesh", None), "mesh", None)
        if layout is None:
            memo[name] = "world"
        else:
            coords = [torch.nonzero(layout == r)[0].tolist()
                      for r in dist.get_process_group_ranks(group)]
            memo[name] = "+".join(a for i, a in enumerate(mesh.axis_names)
                                  if len({c[i] for c in coords}) > 1) or "none"
    return memo[name]


class _Traffic(TorchDispatchMode):
    def __init__(self, mesh=None):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.by_device: dict = {}
        self.collectives: dict = {}
        self.mesh = mesh
        self._axes: dict = {}

    def _collective(self, func, args) -> None:
        op = func.__name__.split(".")[0]
        if op == "barrier":
            return
        kind = _KINDS.get(op, op)
        pg = next(a for a in args if isinstance(a, torch.ScriptObject)
                  and "ProcessGroup" in str(a._type()))
        axes = _group_axes(pg, self.mesh, self._axes)
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(args[0])
                     if isinstance(t, torch.Tensor))
        rec = self.collectives.setdefault(kind, {"calls": 0, "bytes": 0, "by_axis": {}})
        rec["calls"] += 1
        rec["bytes"] += nbytes
        ax = rec["by_axis"].setdefault(axes, {"calls": 0, "bytes": 0})
        ax["calls"] += 1
        ax["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
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
    (the function's result is dropped).  Collectives are read against the
    active mesh (``models.sharding.current_mesh``)."""
    from ..models.sharding import current_mesh
    flops = FlopCounterMode(display=False)
    traffic = _Traffic(current_mesh())
    with flops, traffic:
        fn(*args, **kw)
    return {"flops": float(flops.get_total_flops()), "bytes": float(traffic.bytes),
            "ops": traffic.ops, "bytes_by_device": dict(traffic.by_device),
            "collectives": traffic.collectives}


def collective_bytes(collectives: dict) -> float:
    """The bytes of every kind of ``count``'s ``collectives``, summed: the
    roofline's collective term's numerator."""
    return float(sum(rec["bytes"] for rec in collectives.values()))
