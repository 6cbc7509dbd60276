"""Lowering: collective + ``Torus`` + axis spec -> ``CollectiveSchedule``.

This is the single place in the repo where ring orderings, chunk fractions
and physical hop counts are derived.  The executor, the cost estimator and
the fault rewriter all consume the schedules produced here; none of them
re-derives hop math.

Lowering is fault-aware: given a ``FaultMap`` it

  * drops dead axis positions from every ring ("shrunk rings" — a position
    is dead when any rank in its hyperplane is dead, exact for 1D meshes
    and conservative for wider ones, since one ppermute perm is shared by
    every lane of the axis);
  * prices each surviving (src, dst) pair by BFS over the surviving fabric
    graph, so a transfer whose direct link died carries ``hops > 1`` — the
    dimension-ordered router's detour around the failure.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Sequence

from repro_torch.core.fabric.schedule import (
    A2A, AG, AR, HALO, P2P, RS, Bucket, BucketPlan, CollectiveSchedule,
    FaultMap, Phase, Step, Transfer)
from repro_torch.core.topology import Torus


class UnroutableError(RuntimeError):
    """The fault map partitions the fabric: no detour exists."""


# ----------------------------------------------------------------------------
# fabric graph helpers (the only hop math in the repo)
# ----------------------------------------------------------------------------

def _bfs_path(torus: Torus, src: int, dst: int,
              faults: FaultMap) -> list[int] | None:
    """Shortest surviving rank path src -> dst inclusive, else None — the
    ONE fault-aware BFS (collective detour pricing and p2p routing both
    ride it, so their views of the surviving graph can never diverge)."""
    if src == dst:
        return [src]
    prev = {src: src}
    frontier = deque([src])
    while frontier:
        r = frontier.popleft()
        for n in torus.neighbors(r):
            if n in prev or not faults.link_ok(r, n):
                continue
            prev[n] = r
            if n == dst:
                path = [dst]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                return path[::-1]
            frontier.append(n)
    return None


def _bfs_hops(torus: Torus, src: int, dst: int, faults: FaultMap) -> int | None:
    """Shortest surviving-path length between two live ranks, else None."""
    path = _bfs_path(torus, src, dst, faults)
    return None if path is None else len(path) - 1


def _lanes(torus: Torus, dim: int):
    """All coordinate assignments of the dims orthogonal to ``dim``."""
    ranges = [range(torus.dims[i]) if i != dim else (None,)
              for i in range(torus.ndims)]
    return itertools.product(*ranges)


def _pair_hops(torus: Torus, dim: int, a: int, b: int,
               faults: FaultMap) -> int:
    """Physical hops for an axis-position pair a -> b, worst lane wins."""
    n = torus.dims[dim]
    if not faults:
        delta = abs(a - b)
        return max(1, min(delta, n - delta))
    worst = 0
    routable_lane = False
    for lane in _lanes(torus, dim):
        ca = tuple(a if c is None else c for c in lane)
        cb = tuple(b if c is None else c for c in lane)
        ra, rb = torus.rank(ca), torus.rank(cb)
        if ra in faults.dead_nodes or rb in faults.dead_nodes:
            continue  # a dead endpoint's lane carries no live payload
        hops = _bfs_hops(torus, ra, rb, faults)
        if hops is None:
            raise UnroutableError(
                f"no surviving route {ca} -> {cb} (dim {dim})")
        routable_lane = True
        worst = max(worst, hops)
    if not routable_lane:
        raise UnroutableError(
            f"every lane of axis positions {a} -> {b} (dim {dim}) is dead")
    return max(1, worst)


def live_ring(torus: Torus, dim: int, faults: FaultMap) -> tuple[int, ...]:
    """Participating axis positions in cyclic order (shrunk under faults)."""
    dead = {torus.coords(r)[dim] for r in faults.dead_nodes}
    ring = tuple(p for p in range(torus.dims[dim]) if p not in dead)
    if not ring:
        raise UnroutableError(f"all positions of dim {dim} are dead")
    return ring


def axis_fault_penalty(torus: Torus, dim: int,
                       faults: FaultMap) -> tuple[int, int]:
    """(max detour hops, dead positions) for one axis — the fault rewriter's
    axis-ordering key."""
    ring = live_ring(torus, dim, faults)
    m = len(ring)
    if m <= 1:
        return (0, torus.dims[dim] - m)
    worst = max(_pair_hops(torus, dim, ring[i], ring[(i + 1) % m], faults)
                for i in range(m))
    return (worst, torus.dims[dim] - m)


# ----------------------------------------------------------------------------
# phase construction
# ----------------------------------------------------------------------------

def _dir_transfer(torus: Torus, dim: int, ring: tuple[int, ...], sgn: int,
                  frac: float, faults: FaultMap, combine: str) -> Transfer:
    m = len(ring)
    perm = tuple((ring[i], ring[(i + sgn) % m]) for i in range(m))
    hops = max(_pair_hops(torus, dim, s, d, faults) for s, d in perm)
    return Transfer(perm=perm, frac=frac, hops=hops, combine=combine)


def _ring_phase(kind: str, torus: Torus, axis: str, dim: int, *,
                scale: float, bidirectional: bool, faults: FaultMap,
                frac_per_dir: float, combine: str,
                mean: bool = False) -> Phase:
    ring = live_ring(torus, dim, faults)
    m = len(ring)
    if m <= 1:
        return Phase(kind, axis, ring, steps=(), scale=scale, mean=mean)
    sgns = (+1, -1) if bidirectional else (+1,)
    transfers = tuple(_dir_transfer(torus, dim, ring, sgn, frac_per_dir,
                                    faults, combine) for sgn in sgns)
    steps = tuple(Step(transfers) for _ in range(m - 1))
    return Phase(kind, axis, ring, steps, scale=scale, mean=mean)


def _entries(torus: Torus, axes: Sequence[str],
             axis_dims: Sequence[int] | None) -> list[tuple[str, int]]:
    axes = tuple(axes)
    dims = tuple(axis_dims) if axis_dims is not None else tuple(
        range(len(axes)))
    if len(axes) != len(dims):
        raise ValueError("axes/axis_dims arity mismatch")
    if not axes:
        raise ValueError("need at least one axis")
    for d in dims:
        if not 0 <= d < torus.ndims:
            raise ValueError(f"axis dim {d} out of range for {torus.dims}")
    if len(set(dims)) != len(dims):
        raise ValueError(f"repeated torus dims {dims}")
    return list(zip(axes, dims))


# ----------------------------------------------------------------------------
# public lowerings
# ----------------------------------------------------------------------------

def lower_reduce_scatter(torus: Torus, axes: Sequence[str], *,
                         axis_dims: Sequence[int] | None = None,
                         bidirectional: bool = True, mean: bool = False,
                         faults: FaultMap | None = None) -> CollectiveSchedule:
    """Dimension-ordered reduce-scatter: one ring pass per axis, the working
    set shrinking by the (live) ring size at every phase."""
    faults = faults or FaultMap()
    entries = _entries(torus, axes, axis_dims)
    phases, scale = [], 1.0
    for name, dim in entries:
        m = len(live_ring(torus, dim, faults))
        ndir = 2 if (bidirectional and m > 1) else 1
        ph = _ring_phase(RS, torus, name, dim, scale=scale,
                         bidirectional=bidirectional, faults=faults,
                         frac_per_dir=scale / (max(m, 1) * ndir),
                         combine="sum", mean=mean)
        phases.append(ph)
        scale /= max(m, 1)
    return CollectiveSchedule(RS, tuple(a for a, _ in entries),
                              tuple(d for _, d in entries), torus.dims,
                              tuple(phases), faults, bidirectional, mean)


def lower_all_gather(torus: Torus, axes: Sequence[str], *,
                     axis_dims: Sequence[int] | None = None,
                     bidirectional: bool = True,
                     faults: FaultMap | None = None) -> CollectiveSchedule:
    """All-gather, walking ``axes`` in the given order (callers inverting a
    reduce-scatter pass the reversed axis list); fractions are relative to
    the *input chunk* at each rank, which grows by the ring size per phase."""
    faults = faults or FaultMap()
    entries = _entries(torus, axes, axis_dims)
    phases, scale = [], 1.0
    for name, dim in entries:
        m = len(live_ring(torus, dim, faults))
        ndir = 2 if (bidirectional and m > 1) else 1
        ph = _ring_phase(AG, torus, name, dim, scale=scale,
                         bidirectional=bidirectional, faults=faults,
                         frac_per_dir=scale / ndir, combine="write")
        phases.append(ph)
        scale *= max(m, 1)
    return CollectiveSchedule(AG, tuple(a for a, _ in entries),
                              tuple(d for _, d in entries), torus.dims,
                              tuple(phases), faults, bidirectional, False)


def lower_all_reduce(torus: Torus, axes: Sequence[str], *,
                     axis_dims: Sequence[int] | None = None,
                     bidirectional: bool = True, mean: bool = False,
                     faults: FaultMap | None = None) -> CollectiveSchedule:
    """The bytes-optimal torus all-reduce: reduce-scatter X,Y,..,Z then
    all-gather Z,..,Y,X — 2(Ni-1)/Ni of the live working set per axis, all
    of it first-neighbour traffic (APEnet+ dimension-ordered routing)."""
    faults = faults or FaultMap()
    entries = _entries(torus, axes, axis_dims)
    phases, scale = [], 1.0
    for name, dim in entries:
        m = len(live_ring(torus, dim, faults))
        ndir = 2 if (bidirectional and m > 1) else 1
        phases.append(_ring_phase(
            RS, torus, name, dim, scale=scale, bidirectional=bidirectional,
            faults=faults, frac_per_dir=scale / (max(m, 1) * ndir),
            combine="sum", mean=mean))
        scale /= max(m, 1)
    for name, dim in reversed(entries):
        m = len(live_ring(torus, dim, faults))
        ndir = 2 if (bidirectional and m > 1) else 1
        phases.append(_ring_phase(
            AG, torus, name, dim, scale=scale, bidirectional=bidirectional,
            faults=faults, frac_per_dir=scale / ndir, combine="write"))
        scale *= max(m, 1)
    return CollectiveSchedule(AR, tuple(a for a, _ in entries),
                              tuple(d for _, d in entries), torus.dims,
                              tuple(phases), faults, bidirectional, mean)


def lower_all_to_all(torus: Torus, axis: str, *,
                     axis_dims: Sequence[int] | None = None,
                     faults: FaultMap | None = None) -> CollectiveSchedule:
    """Store-and-forward ring all-to-all: the full buffer circulates n-1
    hops, every rank peeling off its addressed row at each stop — how the
    torus router forwards non-local packets.  Node faults are unroutable
    (rows addressed to a dead rank have nowhere to land); link faults only
    raise the hop count."""
    faults = faults or FaultMap()
    [(name, dim)] = _entries(torus, (axis,), axis_dims)
    ring = live_ring(torus, dim, faults)
    n = torus.dims[dim]
    if len(ring) != n:
        raise UnroutableError(
            "all-to-all cannot shrink its ring: rows addressed to dead "
            f"positions {sorted(set(range(n)) - set(ring))} are undeliverable")
    if n == 1:
        steps: tuple[Step, ...] = ()
    else:
        tr = _dir_transfer(torus, dim, ring, +1, 1.0, faults, "shift")
        steps = tuple(Step((tr,)) for _ in range(n - 1))
    return CollectiveSchedule(
        A2A, (name,), (dim,), torus.dims,
        (Phase(A2A, name, ring, steps),), faults, False, False)


def lower_halo_exchange(torus: Torus, axis: str, *,
                        axis_dims: Sequence[int] | None = None,
                        faults: FaultMap | None = None) -> CollectiveSchedule:
    """One round, both directions: each rank puts its facing slab into both
    ring neighbours (a pair of one-sided RDMA puts).  Under faults the ring
    shrinks, so live ranks exchange halos with their nearest live
    neighbours at the detour's hop cost."""
    faults = faults or FaultMap()
    [(name, dim)] = _entries(torus, (axis,), axis_dims)
    ring = live_ring(torus, dim, faults)
    if len(ring) <= 1:
        phase = Phase(HALO, name, ring, steps=())
    else:
        transfers = tuple(_dir_transfer(torus, dim, ring, sgn, 1.0, faults,
                                        "write") for sgn in (+1, -1))
        phase = Phase(HALO, name, ring, (Step(transfers),))
    return CollectiveSchedule(HALO, (name,), (dim,), torus.dims, (phase,),
                              faults, True, False)


def lower_p2p(torus: Torus, src: int, dst: int, *,
              faults: FaultMap | None = None) -> CollectiveSchedule:
    """Point-to-point lowering: one multi-hop unicast as a schedule.

    An RDMA PUT from rank ``src`` to rank ``dst`` is a single fabric
    message forwarded hop-by-hop by the routers along the dimension-ordered
    (X then Y then Z) minimal path — the endpoints pay injection/reception
    once, every intermediate router adds ``t_hop`` (paper §1).  The
    schedule therefore carries ONE transfer whose ``hops`` is the route
    length; ``fabric.estimate`` prices it exactly like a collective's
    detour transfer.

    Unlike the axis-wise collectives, a unicast is a *global* route: the
    phase ``ring`` lists the fabric **ranks** visited in forwarding order
    (route annotation, not axis positions) and the transfer perm is the
    single (src, dst) rank pair.  ``fault.rewrite`` re-lowers from that
    annotation: under a ``FaultMap`` the route becomes the BFS shortest
    path over the surviving fabric — the dimension-ordered router's detour
    — and ``UnroutableError`` is raised when src/dst are separated (or an
    endpoint itself is dead).
    """
    faults = faults or FaultMap()
    for r in (src, dst):
        if not 0 <= r < torus.size:
            raise ValueError(f"rank {r} out of range for torus {torus.dims}")
        if r in faults.dead_nodes:
            raise UnroutableError(f"p2p endpoint rank {r} is dead")
    if not faults:
        route = torus.route(src, dst)
    else:
        path = _bfs_path(torus, src, dst, faults)
        if path is None:
            raise UnroutableError(
                f"no surviving route {src} -> {dst}: the fault map "
                "partitions the fabric")
        route = path
    return lower_route(torus, route, faults=faults)


def lower_route(torus: Torus, route: Sequence[int], *,
                faults: FaultMap | None = None) -> CollectiveSchedule:
    """Lower an *explicit* unicast route (ranks in forwarding order) to a
    P2P schedule — same shape ``lower_p2p`` produces, but the caller picks
    the path.  This is the congestion-aware router's entry point: the
    serving cluster probes ``fabric.sim.candidate_routes`` by simulated
    completion time and lowers the winner here.  Every consecutive pair
    must be a live first-neighbour link of the torus."""
    faults = faults or FaultMap()
    route = tuple(route)
    if not route:
        raise ValueError("empty route")
    for r in route:
        if not 0 <= r < torus.size:
            raise ValueError(f"rank {r} out of range for torus {torus.dims}")
    for a, b in zip(route, route[1:]):
        if b not in torus.neighbors(a):
            raise ValueError(f"route hop {a} -> {b} is not a torus link")
        if not faults.link_ok(a, b):
            raise UnroutableError(f"route hop {a} -> {b} is dead")
    src, dst = route[0], route[-1]
    hops = len(route) - 1
    if hops == 0:
        steps: tuple[Step, ...] = ()
    else:
        steps = (Step((Transfer(perm=((src, dst),), frac=1.0, hops=hops,
                                combine="write"),)),)
    phase = Phase(P2P, "route", route, steps)
    return CollectiveSchedule(P2P, ("route",), (0,), torus.dims, (phase,),
                              faults, False, False)


# ----------------------------------------------------------------------------
# gradient bucketing (the overlap engine's lowering)
# ----------------------------------------------------------------------------

def _key_sorted(tree):
    """Dicts with their keys sorted, recursively: the JAX package's
    ``jax.tree.leaves`` walks dict keys in sorted order, torch's pytree in
    insertion order, and bucket plans must come out the same."""
    if isinstance(tree, dict):
        return {k: _key_sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_key_sorted(t) for t in tree]
    return tree


def _leaf_sizes(tree_or_sizes) -> list[int]:
    import math

    from torch.utils._pytree import tree_leaves

    leaves = [leaf for leaf in tree_leaves(_key_sorted(tree_or_sizes))
              if leaf is not None]
    sizes = []
    for leaf in leaves:
        if isinstance(leaf, (int, float)):
            sizes.append(int(leaf))
        elif hasattr(leaf, "shape"):
            sizes.append(int(math.prod(leaf.shape)))
        else:
            raise TypeError(f"cannot size bucket leaf {type(leaf)}")
    return sizes


def plan_buckets(tree_or_sizes, bucket_bytes: int, *, itemsize: int = 4,
                 reverse: bool = True) -> BucketPlan:
    """Lower a param tree (or flat leaf-size list) to a ``BucketPlan``.

    Greedy packing in gradient-readiness order: during backward the *last*
    parameters of the forward produce their gradients first, so leaves are
    walked in reverse tree order by default and a bucket closes as soon as
    it holds at least ``bucket_bytes`` of wire payload (``itemsize`` bytes
    per element — 4 for the fp32 gradient wire the apex trainer uses).
    One undersized trailing bucket absorbs the remainder.
    """
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    if itemsize <= 0:
        raise ValueError(f"itemsize must be > 0, got {itemsize}")
    sizes = _leaf_sizes(tree_or_sizes)
    if not sizes:
        raise ValueError("empty param tree: nothing to bucket")
    order = range(len(sizes) - 1, -1, -1) if reverse else range(len(sizes))
    buckets: list[Bucket] = []
    cur: list[int] = []
    cur_bytes = 0
    for i in order:
        cur.append(i)
        cur_bytes += sizes[i] * itemsize
        if cur_bytes >= bucket_bytes:
            buckets.append(Bucket(len(buckets), tuple(cur), cur_bytes))
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(Bucket(len(buckets), tuple(cur), cur_bytes))
    return BucketPlan(tuple(buckets), bucket_bytes, len(sizes))


_LOWERERS = {
    RS: lower_reduce_scatter,
    AG: lower_all_gather,
    AR: lower_all_reduce,
}


def lower(collective: str, torus: Torus, axes: Sequence[str],
          **kw) -> CollectiveSchedule:
    """Generic entry point; see the per-collective lowerings."""
    if collective in _LOWERERS:
        return _LOWERERS[collective](torus, axes, **kw)
    if collective in (A2A, HALO):
        axes = tuple(axes)
        if len(axes) != 1:
            raise ValueError(f"{collective} is single-axis, got {axes}")
        fn = lower_all_to_all if collective == A2A else lower_halo_exchange
        return fn(torus, axes[0], **kw)
    if collective == P2P:
        raise ValueError(
            "p2p is rank-addressed, not axis-addressed; "
            "use lower_p2p(torus, src, dst)")
    raise ValueError(f"unknown collective {collective!r}")
