"""The ``CollectiveSchedule`` IR — "which hop moves which bytes when".

APEnet+ moves every payload as a sequence of first-neighbour, dimension-
ordered hops on the 3D torus, with the two DMA engines of each link keeping
both directions in flight (paper §1, §2.1).  This module reifies that
structure: a collective *lowered* against a ``Torus`` + axis spec becomes an
explicit, inspectable schedule that three independent consumers walk:

  * ``fabric.execute``  — emits the shard_map/ppermute program (the fabric's
    RDMA puts), fusing the two link directions of every round;
  * ``fabric.cost``     — prices each step with ``apelink.NetModel`` (hops,
    bytes, per-direction bandwidth) into a predicted completion time;
  * ``fabric.fault``    — rewrites the schedule around a LO|FA|MO fault map
    (shrunk rings, detour hops, axis reordering).

Vocabulary (outer to inner):

  ``CollectiveSchedule`` — one collective over one or more mesh axes;
  ``Phase``    — one ring pass along one axis (e.g. the reduce-scatter leg
                 along X); carries the ring ordering of participating axis
                 positions and the fraction of the original working set that
                 is still live when the phase starts;
  ``Step``     — one wall-clock round: its transfers fire *concurrently*
                 (the dual-DMA trick — one per link direction);
  ``Transfer`` — one ppermute's worth of messages: a (src, dst) position
                 permutation along the phase axis, the per-rank byte
                 fraction it moves, and the physical link hops each message
                 traverses (1 on a healthy ring; >1 when detouring).

Everything is a frozen dataclass: schedules are values, safe to hash, cache
and compare, and a rewritten schedule never aliases the original.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator


RS = "reduce_scatter"
AG = "all_gather"
AR = "all_reduce"
A2A = "all_to_all"
HALO = "halo_exchange"
P2P = "p2p"

PHASE_KINDS = (RS, AG, A2A, HALO, P2P)
COLLECTIVES = (RS, AG, AR, A2A, HALO, P2P)


@dataclasses.dataclass(frozen=True)
class FaultMap:
    """Fabric faults as LO|FA|MO's master node sees them.

    ``dead_nodes`` are torus ranks; ``dead_links`` are undirected first-
    neighbour links as (lo, hi) rank pairs.  An empty map is falsy.
    """

    dead_nodes: frozenset[int] = frozenset()
    dead_links: frozenset[tuple[int, int]] = frozenset()

    def __bool__(self) -> bool:
        return bool(self.dead_nodes or self.dead_links)

    def link_ok(self, a: int, b: int) -> bool:
        return (a not in self.dead_nodes and b not in self.dead_nodes
                and (min(a, b), max(a, b)) not in self.dead_links)

    @staticmethod
    def normalized(nodes=(), links=()) -> "FaultMap":
        return FaultMap(frozenset(nodes),
                        frozenset((min(a, b), max(a, b)) for a, b in links))


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One directed ppermute: every listed src position sends one message."""

    perm: tuple[tuple[int, int], ...]   # (src, dst) positions along the axis
    frac: float                         # bytes per rank / collective input
    hops: int = 1                       # worst-case physical hops per message
    combine: str = "sum"                # "sum" | "write" | "shift"

    def __post_init__(self) -> None:
        if self.hops < 1:
            raise ValueError(f"hops must be >= 1, got {self.hops}")
        if self.frac < 0:
            raise ValueError(f"negative frac {self.frac}")


@dataclasses.dataclass(frozen=True)
class Step:
    """One wall-clock round; transfers fire concurrently (full duplex)."""

    transfers: tuple[Transfer, ...]


@dataclasses.dataclass(frozen=True)
class Phase:
    """One ring pass along one mesh axis.

    ``ring`` lists the *participating* axis positions in ring order — the
    identity ``(0..n-1)`` on a healthy fabric, a shrunk/reordered tuple
    after a fault rewrite.  ``scale`` is the working-set size entering this
    phase as a fraction of the collective's input (dimension-ordered
    reduce-scatter shrinks it by the axis size per phase; all-gather legs
    grow it back).
    """

    kind: str
    axis: str
    ring: tuple[int, ...]
    steps: tuple[Step, ...]
    scale: float = 1.0
    mean: bool = False

    def __post_init__(self) -> None:
        if self.kind not in PHASE_KINDS:
            raise ValueError(f"unknown phase kind {self.kind!r}")
        if len(set(self.ring)) != len(self.ring):
            raise ValueError(f"ring has repeats: {self.ring}")

    @property
    def ring_size(self) -> int:
        return len(self.ring)

    @property
    def directions(self) -> int:
        """1 = unidirectional, 2 = dual-DMA bidirectional."""
        return max((len(s.transfers) for s in self.steps), default=1)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One size-targeted group of gradient leaves issued as a unit.

    ``leaves`` are flat param-tree leaf indices in *issue order* (the order
    their gradients materialise during backward); ``nbytes`` is the wire
    payload the bucket injects per rank when its schedule fires.
    """

    index: int
    leaves: tuple[int, ...]
    nbytes: int

    def __post_init__(self) -> None:
        if not self.leaves:
            raise ValueError("empty bucket")
        if self.nbytes < 0:
            raise ValueError(f"negative bucket bytes {self.nbytes}")


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Gradient bucketing for compute-overlapped collective issue.

    The software analogue of the APEnet+ dual-DMA prefetchable command
    queue (paper §2.1, Fig 1): instead of one monolithic post-backward
    collective, the payload is split into ``buckets`` whose schedules are
    issued as soon as their gradients exist, so the fabric rounds of bucket
    i overlap the remaining backward compute.  Lowered by
    ``fabric.plan_buckets``; consumed by the executor's bucket grad hook,
    the overlap cost model (``fabric.estimate_overlapped``) and the
    trainer's apex path.
    """

    buckets: tuple[Bucket, ...]
    bucket_bytes: int            # the size target each bucket was packed to
    n_leaves: int                # leaves of the source param tree

    def __post_init__(self) -> None:
        seen: set[int] = set()
        for b in self.buckets:
            dup = seen.intersection(b.leaves)
            if dup:
                raise ValueError(f"leaves {sorted(dup)} in multiple buckets")
            seen.update(b.leaves)

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_bytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)

    @property
    def bucket_nbytes(self) -> tuple[int, ...]:
        """Per-bucket wire bytes in issue order (the overlap model's input)."""
        return tuple(b.nbytes for b in self.buckets)

    def describe(self) -> str:
        lines = [f"BucketPlan: {self.n_buckets} buckets over "
                 f"{self.n_leaves} leaves, target {self.bucket_bytes} B"]
        for b in self.buckets:
            lines.append(f"  bucket {b.index}: {len(b.leaves)} leaves, "
                         f"{b.nbytes / 1e6:.3f} MB")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class CollectiveSchedule:
    """A collective lowered to explicit neighbour transfers.

    ``axes`` are mesh axis names in lowering order; ``axis_dims[i]`` is the
    torus dimension backing ``axes[i]``; ``torus_dims`` records the fabric
    shape so consumers (cost, fault rewrite) can rebuild the ``Torus``
    without re-deriving hop math anywhere else.
    """

    collective: str
    axes: tuple[str, ...]
    axis_dims: tuple[int, ...]
    torus_dims: tuple[int, ...]
    phases: tuple[Phase, ...]
    faults: FaultMap = dataclasses.field(default_factory=FaultMap)
    bidirectional: bool = True   # dual-DMA: both link directions per round
    mean: bool = False           # reduce phases divide by the live ring size

    def __post_init__(self) -> None:
        if self.collective not in COLLECTIVES:
            raise ValueError(f"unknown collective {self.collective!r}")
        if len(self.axes) != len(self.axis_dims):
            raise ValueError("axes/axis_dims arity mismatch")

    # -- walkers -------------------------------------------------------------
    def steps(self) -> Iterator[tuple[Phase, Step]]:
        for ph in self.phases:
            for st in ph.steps:
                yield ph, st

    @property
    def rounds(self) -> int:
        """Sequential wall-clock rounds (the executor's ppermute depth)."""
        return sum(len(ph.steps) for ph in self.phases)

    @property
    def n_messages(self) -> int:
        """Total directed ppermutes issued (2 per round when bidirectional)."""
        return sum(len(st.transfers) for _, st in self.steps())

    @property
    def max_hops(self) -> int:
        return max((tr.hops for _, st in self.steps()
                    for tr in st.transfers), default=0)

    def bytes_per_rank(self, nbytes: int) -> float:
        """Payload bytes each participating rank injects into the fabric."""
        return sum(tr.frac * nbytes for _, st in self.steps()
                   for tr in st.transfers)

    @property
    def route(self) -> tuple[int, ...]:
        """The rank-by-rank forwarding route of a P2P (unicast) schedule —
        the phase ring annotation ``lower_p2p``/``lower_route`` wrote.
        Consumers (the fabric simulator, ``RdmaEndpoint``) replay the
        unicast along exactly these links."""
        if self.collective != P2P:
            raise ValueError(
                f"{self.collective} schedules are axis-addressed; only p2p "
                "schedules carry a rank route")
        return self.phases[0].ring

    def describe(self) -> str:
        lines = [f"{self.collective} over axes {self.axes} "
                 f"on torus {self.torus_dims}"
                 + (f"  [faults: {sorted(self.faults.dead_nodes)} nodes, "
                    f"{sorted(self.faults.dead_links)} links]"
                    if self.faults else "")]
        for ph in self.phases:
            hops = max((tr.hops for st in ph.steps for tr in st.transfers),
                       default=0)
            lines.append(
                f"  {ph.kind:<15s} axis={ph.axis:<6s} ring={ph.ring} "
                f"rounds={len(ph.steps)} dirs={ph.directions} "
                f"scale={ph.scale:.4g} max_hops={hops}")
        return "\n".join(lines)
