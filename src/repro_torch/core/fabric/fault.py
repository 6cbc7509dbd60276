"""Fault-aware schedule rewriting — LO|FA|MO awareness turned into action.

The LO|FA|MO protocol (paper §4, and the companion work arXiv:2201.01088)
gives the master node global knowledge of dead hosts, dead NICs and dead
links.  This module closes the loop: given that fault map, an existing
``CollectiveSchedule`` is re-lowered against the surviving fabric —

  * **shrunk rings**: dead axis positions drop out of every ring pass, so
    live ranks keep exchanging with their nearest live neighbours;
  * **detour hops**: a transfer whose direct link died is priced (and
    annotated) with its BFS detour over the surviving graph;
  * **axis reordering**: for multi-axis all-reduce, fault-free axes are
    processed first in the reduce-scatter leg — the faulted (per-byte more
    expensive) axes then only carry the already-shrunk working set, which
    is free to do because the all-reduce result is axis-order invariant.

The rewriter only *re-lowers*; all ring/hop derivation stays in
``fabric.lower`` and execution stays in ``fabric.execute`` — a rewritten
schedule is indistinguishable, structurally, from a freshly lowered one.
"""
from __future__ import annotations

from repro_torch.core.fabric import lower as L
from repro_torch.core.fabric.schedule import (
    A2A, AG, AR, HALO, P2P, RS, CollectiveSchedule, FaultMap)
from repro_torch.core.topology import Torus

UnroutableError = L.UnroutableError


def fault_map_from_lofamo(sim) -> FaultMap:
    """The master node's current view of the fabric, as a ``FaultMap``.

    Works with any object exposing ``detected_at_master()`` (dead ranks)
    and optionally ``detected_links_at_master()`` (dead (a, b) pairs) —
    i.e. ``core.lofamo.LofamoSim``.
    """
    nodes = set(sim.detected_at_master())
    links = set(getattr(sim, "detected_links_at_master", lambda: ())())
    return FaultMap.normalized(nodes, links)


def _ordered_axes(schedule: CollectiveSchedule, torus: Torus,
                  faults: FaultMap) -> list[tuple[str, int]]:
    """Fault-free axes first (they carry the most reduce-scatter bytes),
    faulted axes last — stable for equally clean axes."""
    entries = list(zip(schedule.axes, schedule.axis_dims))
    return sorted(entries,
                  key=lambda e: L.axis_fault_penalty(torus, e[1], faults))


def rewrite(schedule: CollectiveSchedule, faults: FaultMap, *,
            reorder_axes: bool = True) -> CollectiveSchedule:
    """Re-lower ``schedule`` against the surviving fabric.

    Raises ``UnroutableError`` when the fault map partitions the fabric (or
    kills a rank an all-to-all must deliver to) — the caller should fall
    back to checkpoint-restart on a re-meshed machine, exactly like the
    trainer's elastic re-mesh path.
    """
    if not faults:
        return schedule
    torus = Torus(schedule.torus_dims)
    axes, dims = schedule.axes, schedule.axis_dims
    if schedule.collective == AR and reorder_axes and len(axes) > 1:
        entries = _ordered_axes(schedule, torus, faults)
        axes = tuple(a for a, _ in entries)
        dims = tuple(d for _, d in entries)
    if schedule.collective == RS:
        return L.lower_reduce_scatter(
            torus, axes, axis_dims=dims, bidirectional=schedule.bidirectional,
            mean=schedule.mean, faults=faults)
    if schedule.collective == AG:
        return L.lower_all_gather(
            torus, axes, axis_dims=dims, bidirectional=schedule.bidirectional,
            faults=faults)
    if schedule.collective == AR:
        return L.lower_all_reduce(
            torus, axes, axis_dims=dims, bidirectional=schedule.bidirectional,
            mean=schedule.mean, faults=faults)
    if schedule.collective == A2A:
        return L.lower_all_to_all(torus, axes[0], axis_dims=dims,
                                  faults=faults)
    if schedule.collective == HALO:
        return L.lower_halo_exchange(torus, axes[0], axis_dims=dims,
                                     faults=faults)
    if schedule.collective == P2P:
        # the route annotation carries the endpoints: first rank of the
        # first phase's ring, last rank of the last phase's ring
        route_src = schedule.phases[0].ring[0]
        route_dst = schedule.phases[-1].ring[-1]
        return L.lower_p2p(torus, route_src, route_dst, faults=faults)
    raise ValueError(f"unknown collective {schedule.collective!r}")
