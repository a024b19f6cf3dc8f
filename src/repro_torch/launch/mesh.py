"""Meshes, counterpart of ``repro.launch.mesh``.  Functions, not module
constants: importing this module joins no process group.

A :class:`Mesh` lays the ranks of the ``torch.distributed`` group out on
named axes (``torch.distributed.device_mesh.init_device_mesh``, rank r at
its row-major position, as ``jax.make_mesh`` lays out devices) and is read
by the sharding rules like an ``AbstractMesh``: ``shape`` (name -> size)
and ``axis_names``; ``coordinate`` is this rank's index on each axis.
``make_production_mesh`` is abstract: it names the reference's 256- and
512-chip meshes for the rules and starts no process.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist

from ..models.sharding import AbstractMesh, abstract_mesh


class Mesh:
    """The ranks of the current process group on named axes."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.coordinate = dict(zip(self.axis_names, device_mesh.get_coordinate()))
        self._groups: dict = {}

    def group(self, axes):
        """The process group of the ranks that differ from this one on
        ``axes`` alone (one axis name, or a tuple of them: ``"batch"``'s
        ("pod", "data"), in the mesh's order), ordered by their coordinate
        there, the first axis the major one.  A tuple's groups are made
        (``new_group``) at its first use, which every rank of the mesh must
        reach in the same order."""
        if isinstance(axes, str) or len(axes) == 1:
            return self.device_mesh.get_group(axes if isinstance(axes, str) else axes[0])
        axes = tuple(axes)
        if axes not in self._groups:
            # the mesh's ranks with ``axes`` last, in their order: each row
            # is one group; every rank makes every group, as new_group asks
            dims = [self.axis_names.index(a) for a in axes]
            rest = [d for d in range(len(self.axis_names)) if d not in dims]
            rows = self.device_mesh.mesh.permute(*rest, *dims).reshape(-1, math.prod(
                self.shape[a] for a in axes)).tolist()
            me = dist.get_rank()
            for row in rows:
                group = dist.new_group(row)
                if me in row:
                    self._groups[axes] = group
        return self._groups[axes]


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda") -> Mesh:
    """``shape`` over ``axes``, on the ranks of the current process group
    (their product must be its world size)."""
    from torch.distributed.device_mesh import init_device_mesh
    return Mesh(init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes)))


def make_local_mesh(device_type: str = "cuda") -> Mesh:
    """Every rank of the group on the data axis: (world size, 1) over
    ("data", "model"), the reference's local mesh."""
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)
