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
the mesh gets ``coords`` None.  A collective over several axes at once (a
spec entry such as ``("data", "model")``) runs on ``group(axes)``: the
ranks that share every coordinate but those axes, made for every set of
axes when the mesh is.

``make_production_mesh`` is the JAX module's production mesh (16x16
("data", "model"), or 2x16x16 with "pod"), over the world's first 256 or
512 ranks; ``production_torus`` its topology twin; ``host_test_mesh`` its
small test mesh, here over the first ranks.

JAX's dry run builds the production mesh over 512 forced host devices;
torch has no such devices, so ``make_production_mesh(abstract=True)``
gives an abstract mesh: the same layout, playing one given rank
(``rank``), with no process group and no ``torch.distributed`` call.  Its
lines' groups are ``AbstractGroup``s, and the collectives of
``parallel/spmd.py`` take only meta tensors on them (the dry run's,
``launch/dryrun.py``): a real tensor on an abstract mesh is an error.
"""
from __future__ import annotations

import itertools
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


class AbstractGroup:
    """The ranks of one line of an abstract mesh, in the line's order: the
    group a collective would run on, with no process group behind it."""

    def __init__(self, ranks) -> None:
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)


class Mesh:
    """A row-major layout of ranks over named axes, with a process group
    for each axis line through this rank; with ``abstract_rank`` (an index
    into ``ranks``) an abstract mesh that plays that rank, its groups
    ``AbstractGroup``s."""

    def __init__(self, shape, axis_names, ranks, *,
                 abstract_rank: int | None = None) -> None:
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
        self.abstract = abstract_rank is not None
        me = self.ranks[abstract_rank] if self.abstract else dist.get_rank()
        make_group = AbstractGroup if self.abstract else _group
        self.coords = (self.torus.coords(self.ranks.index(me))
                       if me in self.ranks else None)
        self._lines: dict[str, tuple[int, ...]] = {}
        self._groups: dict[str, object] = {}
        self.all_group = None          # every rank of the mesh
        if self.coords is None:
            return
        self.all_group = make_group(self.ranks)
        # every set of axes, in axis order: its line through this rank,
        # row-major over those axes (the first the major one)
        for k in range(1, len(axis_names) + 1):
            for sub in itertools.combinations(range(len(axis_names)), k):
                line = []
                for pos in itertools.product(*(range(shape[i])
                                               for i in sub)):
                    c = list(self.coords)
                    for i, v in zip(sub, pos):
                        c[i] = v
                    line.append(self.ranks[self.torus.rank(tuple(c))])
                key = tuple(axis_names[i] for i in sub)
                self._lines[key] = tuple(line)
                self._groups[key] = make_group(tuple(line))
                if k == 1:
                    self._lines[key[0]] = tuple(line)
                    self._groups[key[0]] = self._groups[key]

    def __contains__(self, rank: int) -> bool:
        return rank in self.ranks

    def axis_index(self, axis: str) -> int:
        """This rank's position along ``axis`` (JAX: ``lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]

    def line(self, axis) -> tuple[int, ...]:
        """Global ranks of this rank's line along ``axis`` (a name, or a
        tuple of names in axis order), by position."""
        return self._lines[axis if isinstance(axis, str) else tuple(axis)]

    def group(self, axis):
        """The process group of this rank's line along ``axis`` (a name,
        or a tuple of names in axis order); its ranks run in the line's
        order, since the mesh's ranks ascend."""
        return self._groups[axis if isinstance(axis, str) else tuple(axis)]


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


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = False,
                         rank: int = 0) -> Mesh:
    """The graded production mesh: 16x16 ("data", "model") single pod, or
    2x16x16 ("pod", "data", "model") multi-pod.  Over the world's first
    256 or 512 ranks (raises when the world is smaller); with ``abstract``
    an abstract mesh of that layout playing rank ``rank``, which needs no
    process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if abstract:
        return Mesh(shape, axes, range(math.prod(shape)), abstract_rank=rank)
    return make_mesh(shape, axes)


def production_torus(*, multi_pod: bool = False) -> Torus:
    """Topology twin of the JAX package's production mesh: 16x16 ("data",
    "model"), or 2x16x16 with "pod" (rank i of the torus is device i of
    the mesh, both row-major)."""
    return Torus((2, 16, 16) if multi_pod else (16, 16))


def host_test_mesh(shape=(8,), axes=("x",)) -> Mesh:
    """Small mesh over the first ranks (tests / demos only)."""
    return make_mesh(shape, axes)
