"""Torus collectives — thin lowering wrappers over ``core.fabric``.

The counterpart of the JAX package's ``core/collectives.py``.  APEnet+
moves data exclusively over first-neighbour torus links with
dimension-ordered routing (§1), and hides latency by keeping *two* DMA
engines per link in flight (§2.1, Fig 1).  Here a neighbour RDMA-put is a
``torch.distributed`` point-to-point round inside the line's process group
(gloo on the CPU, NCCL on cards).

Every collective is *lowered* to an explicit ``fabric.CollectiveSchedule``
(which hop moves which bytes when) and then executed by
``fabric.execute`` — the same schedule object the cost estimator prices
and the LO|FA|MO fault rewriter detours.  Each function accepts an
optional pre-lowered ``schedule`` (e.g. a fault-rewritten one); without it
the schedule is lowered on the fly against the ring implied by the mesh
axis.

  * ``ring_reduce_scatter`` / ``ring_all_gather`` / ``ring_all_reduce`` —
    k-ary ring algorithms along one named mesh axis, built purely from
    neighbour puts; **bidirectional** by default (each round ships two
    half-chunks in opposite directions in one batch: the dual DMA engines);
  * multi-axis, **dimension-ordered** wrappers — reduce-scatter along X,
    then Y, then Z, and all-gather back in reverse order: the collective
    analogue of APEnet+'s X->Y->Z router policy;
  * ``ring_all_to_all`` — store-and-forward ring all-to-all (MoE dispatch
    on the torus);
  * ``halo_exchange`` — the one-sided neighbour put used by stencil demos
    and the LO|FA|MO status exchange.

All functions here are *per-rank* code over a ``Mesh``
(``repro_torch.launch.mesh``).  JAX's ``fast_all_to_all`` (XLA's own
all-to-all) has no counterpart: the port's collectives are the fabric's.

Numerics note: ring reductions accumulate in fp32 when inputs are lower
precision (bf16/fp16), matching production all-reduce behaviour.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import fabric
from repro_torch.core.fabric import CollectiveSchedule
from repro_torch.core.topology import Torus


def _axis_torus(axis_names: Sequence[str], mesh) -> Torus:
    """The ring/torus implied by the mesh axes."""
    return Torus(tuple(mesh.shape[ax] for ax in axis_names))


# ----------------------------------------------------------------------------
# single-axis ring primitives (per-rank code)
# ----------------------------------------------------------------------------

def ring_reduce_scatter(x: torch.Tensor, axis_name: str, mesh, *,
                        bidirectional: bool = True, mean: bool = False,
                        schedule: CollectiveSchedule | None = None
                        ) -> torch.Tensor:
    """Reduce-scatter along a mesh-axis ring; ring slot r returns chunk r.

    Input: the full local array (reduced across ranks elementwise, then
    scattered).  Output: flat fp32-accumulated chunk of size ceil(|x|/N)
    (zero-padded); see ``ring_all_reduce`` for the unpadded composite.
    """
    if schedule is None:
        schedule = fabric.lower_reduce_scatter(
            _axis_torus((axis_name,), mesh), (axis_name,),
            bidirectional=bidirectional, mean=mean)
    chunk, _ = fabric.execute_reduce_scatter(schedule, x, mesh)
    return chunk


def ring_all_gather(x: torch.Tensor, axis_name: str, mesh, *,
                    bidirectional: bool = True,
                    schedule: CollectiveSchedule | None = None
                    ) -> torch.Tensor:
    """All-gather chunks along a ring: slot r contributes x, returns the
    concatenation ordered by ring slot, shape (n, *x.shape)."""
    if schedule is None:
        schedule = fabric.lower_all_gather(
            _axis_torus((axis_name,), mesh), (axis_name,),
            bidirectional=bidirectional)
    return fabric.execute_all_gather(schedule, x, mesh)


def ring_all_reduce(x: torch.Tensor, axis_name: str, mesh, *,
                    bidirectional: bool = True, mean: bool = False,
                    schedule: CollectiveSchedule | None = None
                    ) -> torch.Tensor:
    """Ring all-reduce = reduce-scatter + all-gather (the classic 2(N-1)/N
    bytes-optimal schedule), preserving ``x``'s shape/dtype."""
    if schedule is None:
        schedule = fabric.lower_all_reduce(
            _axis_torus((axis_name,), mesh), (axis_name,),
            bidirectional=bidirectional, mean=mean)
    return fabric.execute_all_reduce(schedule, x, mesh)


# ----------------------------------------------------------------------------
# multi-axis, dimension-ordered composites (APEnet+ X->Y->Z routing)
# ----------------------------------------------------------------------------

def dim_ordered_all_reduce(x: torch.Tensor, axis_names: Sequence[str], mesh,
                           *, bidirectional: bool = True, mean: bool = False,
                           schedule: CollectiveSchedule | None = None
                           ) -> torch.Tensor:
    """All-reduce over several mesh axes: reduce-scatter X,Y,...,Z then
    all-gather Z,...,Y,X.  Each phase only ever talks to first neighbours
    along one torus dimension — bytes-optimal on a torus."""
    if schedule is None:
        schedule = fabric.lower_all_reduce(
            _axis_torus(axis_names, mesh), tuple(axis_names),
            bidirectional=bidirectional, mean=mean)
    return fabric.execute_all_reduce(schedule, x, mesh)


def dim_ordered_reduce_scatter(x: torch.Tensor, axis_names: Sequence[str],
                               mesh, *, bidirectional: bool = True,
                               mean: bool = False,
                               schedule: CollectiveSchedule | None = None
                               ) -> tuple[torch.Tensor, list[int]]:
    """Multi-axis RS; also returns per-stage pre-pad sizes for the inverse
    ``dim_ordered_all_gather`` (ZeRO-1 shard/unshard round trip)."""
    if schedule is None:
        schedule = fabric.lower_reduce_scatter(
            _axis_torus(axis_names, mesh), tuple(axis_names),
            bidirectional=bidirectional, mean=mean)
    return fabric.execute_reduce_scatter(schedule, x, mesh)


def dim_ordered_all_gather(x: torch.Tensor, axis_names: Sequence[str],
                           stage_sizes: Sequence[int], mesh, *,
                           bidirectional: bool = True,
                           schedule: CollectiveSchedule | None = None
                           ) -> torch.Tensor:
    """Inverse of ``dim_ordered_reduce_scatter`` given its stage sizes."""
    if schedule is None:
        axes = tuple(reversed(tuple(axis_names)))
        dims = tuple(reversed(range(len(axes))))
        schedule = fabric.lower_all_gather(_axis_torus(axis_names, mesh),
                                           axes, axis_dims=dims,
                                           bidirectional=bidirectional)
    return fabric.execute_all_gather(schedule, x, mesh, list(stage_sizes))


# ----------------------------------------------------------------------------
# all-to-all
# ----------------------------------------------------------------------------

def ring_all_to_all(x: torch.Tensor, axis_name: str, mesh, *,
                    schedule: CollectiveSchedule | None = None
                    ) -> torch.Tensor:
    """Store-and-forward ring all-to-all along one torus axis.

    ``x`` has shape (n, ...): row j is this rank's block destined for rank j.
    Returns shape (n, ...): row j is the block received from rank j.  Pure
    first-neighbour traffic: the full buffer circulates n-1 hops and every
    rank picks out its addressed row at each stop.
    """
    if schedule is None:
        schedule = fabric.lower_all_to_all(
            _axis_torus((axis_name,), mesh), axis_name)
    return fabric.execute_all_to_all(schedule, x, mesh)


# ----------------------------------------------------------------------------
# halo exchange / neighbour put
# ----------------------------------------------------------------------------

def halo_exchange(x: torch.Tensor, axis_name: str, mesh, halo: int = 1,
                  dim: int = 0, *,
                  schedule: CollectiveSchedule | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange ``halo``-wide boundary slabs with both ring neighbours.

    Returns (from_prev, from_next): the neighbours' facing edges — a pair of
    one-sided RDMA puts in APEnet+ terms.
    """
    if schedule is None:
        schedule = fabric.lower_halo_exchange(
            _axis_torus((axis_name,), mesh), axis_name)
    return fabric.execute_halo_exchange(schedule, x, mesh, halo, dim)


# ----------------------------------------------------------------------------
# per-rank wrappers (tests / demos / the apex DP layer)
# ----------------------------------------------------------------------------

def make_stacked_all_reduce(mesh, axis_names: Sequence[str], *,
                            bidirectional: bool = True, mean: bool = False,
                            schedule: CollectiveSchedule | None = None):
    """Per-rank all-reduce for tests/demos.

    The returned function takes the stacked array of shape (n_0, ..., n_k,
    *payload) — every (i, ..., j) slot one rank's contribution, the same
    array on every rank — and returns this rank's result: the
    (mean-)reduction of all slots, of shape ``payload``, so correctness is
    checkable against ``x.sum(axis=lead)``.  (JAX: one jitted shard_map
    over the stacked array.)
    """
    axes = tuple(axis_names)

    def per_rank(x: torch.Tensor) -> torch.Tensor:
        idx = tuple(mesh.axis_index(ax) for ax in axes)
        return dim_ordered_all_reduce(x[idx], axes, mesh,
                                      bidirectional=bidirectional, mean=mean,
                                      schedule=schedule)

    return per_rank


def tree_all_reduce(tree: dict, axis_names: Sequence[str], mesh, *,
                    bidirectional: bool = True, mean: bool = True,
                    schedule: CollectiveSchedule | None = None) -> dict:
    """Per-rank: all-reduce every leaf of a dict of tensors (gradient
    sync)."""
    return {k: dim_ordered_all_reduce(g, axis_names, mesh,
                                      bidirectional=bidirectional, mean=mean,
                                      schedule=schedule)
            for k, g in tree.items()}
