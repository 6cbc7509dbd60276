"""Meshes over the ranks of ``torch.distributed``.

The counterpart of the JAX package's ``launch/mesh.py``.  One process is
one rank, and on the card one rank is one device.  ``make_mesh(shape,
axis_names)`` lays the first ``prod(shape)`` ranks (or the given ones)
out row-major over the axes, as JAX lays devices out, and gives each rank
the process group of its line of every axis — the ranks that share all
coordinates but that axis; one group per line — so a collective along an
axis talks only inside its line.  Rank i of the mesh is rank i of the
torus twin (``Torus(shape)``), so this rank's coordinates are
``Torus.coords``.

Groups are made with ``use_local_synchronization``: only their members
take part, so ranks outside a mesh (dropped by an elastic re-mesh) need
not call in, and a group of the same ranks is made once and reused.
Every process may call ``make_mesh`` with the same arguments; one outside
the mesh gets ``coords`` None.  The production meshes of the JAX module (a
16x16 TPU pod) have no counterpart here.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.core.topology import Torus

# (default group, ranks) -> process group: one group per rank set
_GROUPS: dict = {}


def _group(ranks: tuple[int, ...]):
    """The process group of ``ranks`` (this rank must be one of them),
    made on first use with a members-only rendezvous."""
    key = (id(dist.distributed_c10d._get_default_group()), ranks)
    group = _GROUPS.get(key)
    if group is None:
        group = dist.new_group(list(ranks), use_local_synchronization=True)
        _GROUPS[key] = group
    return group


class Mesh:
    """A row-major layout of ranks over named axes, with a process group
    for each axis line through this rank."""

    def __init__(self, shape, axis_names, ranks) -> None:
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError("mesh shape/axis arity mismatch")
        if len(ranks) != math.prod(shape):
            raise ValueError(f"{len(ranks)} ranks for mesh shape {shape}")
        self.axis_names = axis_names
        # name -> size, in axis order (as JAX's Mesh.shape)
        self.shape = dict(zip(axis_names, shape))
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.torus = Torus(shape)
        me = dist.get_rank()
        self.coords = (self.torus.coords(self.ranks.index(me))
                       if me in self.ranks else None)
        self._lines: dict[str, tuple[int, ...]] = {}
        self._groups: dict[str, object] = {}
        self.all_group = None          # every rank of the mesh
        if self.coords is None:
            return
        self.all_group = _group(self.ranks)
        for ax_i, ax in enumerate(axis_names):
            line = []
            for pos in range(shape[ax_i]):
                c = list(self.coords)
                c[ax_i] = pos
                line.append(self.ranks[self.torus.rank(tuple(c))])
            self._lines[ax] = tuple(line)
            self._groups[ax] = _group(tuple(line))

    def __contains__(self, rank: int) -> bool:
        return rank in self.ranks

    def axis_index(self, axis: str) -> int:
        """This rank's position along ``axis`` (JAX: ``lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]

    def line(self, axis: str) -> tuple[int, ...]:
        """Global ranks of this rank's line along ``axis``, by position."""
        return self._lines[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self._groups[axis]


def make_mesh(shape, axis_names, *, ranks=None) -> Mesh:
    """A mesh over ``ranks`` (default: the first ``prod(shape)`` ranks of
    the default group, as JAX takes the first devices)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(init_process_group first)")
    need = math.prod(tuple(shape))
    if ranks is None:
        if dist.get_world_size() < need:
            raise ValueError(f"mesh {tuple(shape)} needs {need} ranks, the "
                             f"world has {dist.get_world_size()}")
        ranks = range(need)
    return Mesh(shape, axis_names, list(ranks))
