"""Discrete-event, link-level fabric simulator — the shared timeline every
time model in the repo can price against.

The analytic estimator (``fabric.cost``) prices each transfer in isolation:
one ``NetModel.latency`` message over its hops.  That is exact for a single
flow, but APElink is a *shared-resource* design — per-channel credit-based
flow control with a ~40 KB footprint (paper §2.3) and dimension-ordered
routing over links that many in-flight packets compete for.  The companion
works arXiv:1102.3796 and arXiv:1307.8276 measure exactly that regime:
aggregate traffic on shared links.  ``FabricSim`` closes the gap:

  * every directed first-neighbour link carries one **virtual channel per
    traffic class** (``fabric.qos.TrafficClass``) at the APElink sustained
    payload bandwidth; a weighted arbiter (start-time-fair virtual-time
    scheduling — the router's class-weighted round-robin) drains the
    channels, so under contention each backlogged class holds a
    weight-proportional share of the link and no class can be starved.
    The default ``QosPolicy(single_class=True)`` collapses this to ONE
    FIFO channel — bitwise the pre-QoS simulator;
  * **credit-based flow control**: each directed link's downstream buffer
    holds ``credit_bytes`` (default: ``apelink.channel_footprint_bytes`` —
    the paper's ~40 KB bandwidth-delay product), partitioned per class by
    the ``QosPolicy``.  A packet only starts crossing a link when its
    class's partition of the far buffer has room; credits return when the
    packet leaves that buffer (consumed at the endpoint, or started on the
    next link).  Congestion therefore backpressures upstream hop by hop —
    but only within its own class: a saturated BULK stream cannot exhaust
    DECODE's credits;
  * **dimension-ordered packet walks**: a flow's route defaults to
    ``Torus.route`` (X then Y then Z), or the BFS detour over the
    surviving graph under a ``FaultMap`` — the same one BFS the lowering
    and fault-rewrite layers use (``lower._bfs_path``);
  * endpoint costs match the analytic model: ``t_inject`` before the first
    link, ``t_receive`` after the last, ``t_hop`` per router transit, GPU
    touch overheads and the GPU-outbound read cap as source pacing.

Consumers:

  * ``fabric.estimate(..., backend="sim")`` — ``simulate_schedule`` walks a
    ``CollectiveSchedule`` round by round (each round's flows barrier on
    the previous round, exactly the analytic model's sequential-rounds
    rule), so the sim and the analytic estimate must agree on single-flow
    schedules — that differential validates both models;
  * ``RdmaEndpoint`` (``sim=`` attached) — ``put_pages``/``get_time``
    inject their DMA drain (a host-interface FIFO resource per rank) and
    wire legs as flows instead of summing closed-form terms; bulk PUTs
    ride the BULK class, GET descriptors ride CONTROL;
  * ``ServingCluster``/``Engine`` — one cluster-wide sim; decode-step TP
    collectives (DECODE class) and migration PUTs (BULK) ride the same
    links and contend — by policy, not free-for-all;
  * ``ServingCluster.migrate`` — congestion-aware path selection probes
    candidate routes (``candidate_routes``, the fault BFS machinery) by
    simulated completion time; ``striped_routes`` splits one bulk
    transfer across the k best candidates (multi-path striping).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Hashable, Sequence

from repro_torch.core import apelink
from repro_torch.core.apelink import NetModel
from repro_torch.core.fabric.cost import CostEstimate
from repro_torch.core.fabric.lower import UnroutableError, _bfs_path, _lanes
from repro_torch.core.fabric.qos import SINGLE_CLASS, QosPolicy, TrafficClass
from repro_torch.core.fabric.schedule import (
    P2P, CollectiveSchedule, FaultMap, Phase, Transfer)
from repro_torch.core.fabric.telemetry import ordered_link_items
from repro_torch.core.topology import Torus

# flows bigger than max_packets * packet_bytes coarsen their packets so the
# event count stays bounded — up to the credit constraint: a packet must
# fit its class's credit window (a packet larger than the far buffer could
# never be granted credit), so under a multi-class policy coarsening stops
# at half the class's credit partition and a bulk flow's event count is
# bounded by nbytes / (partition / 2) instead of max_packets.  That is the
# price of partitioned virtual-channel buffers (real VC routers have the
# same packet-size bound); sims that only need FIFO semantics keep the
# default single-class policy and the full-pool cap.
DEFAULT_PACKET_BYTES = 4096
DEFAULT_MAX_PACKETS = 256


def link_key(torus: Torus, u: int, v: int, channel: int) -> tuple:
    """Physical cable identity of the hop u -> v.

    Every node wires BOTH ports of each dimension (6 links per node on a
    3D torus), so the +1 and -1 traversal directions are distinct cables
    even when they join the same rank pair — which happens exactly on
    2-rings, where the dual-DMA round's two transfers ride the two
    parallel cables concurrently (the analytic model's disjoint-directions
    rule).  For rings > 2 the direction is implied by the coordinates; on
    a 2-ring the flow's ``channel`` hint disambiguates.  Shared by the
    packet tier (``FabricSim``) and the fluid tier (``fluid.FluidSim``) so
    both fidelity tiers agree on what "one link" is.
    """
    cu, cv = torus.coords(u), torus.coords(v)
    for d, (a, b) in enumerate(zip(cu, cv)):
        if a != b:
            n = torus.dims[d]
            if n == 2:
                return (u, v, channel & 1)
            return (u, v, 0 if (b - a) % n == 1 else 1)
    return (u, v, 0)   # self-link (unused)


def packetize(nbytes: float, cap: float, packet_bytes: float,
              max_packets: int) -> tuple[float, int]:
    """Packet size/count for a flow whose class credit partition is
    ``cap`` — a packet larger than its partition could never be granted
    credit.  The fluid tier reuses this to derive its per-flow arbiter
    weight and store-and-forward tail, so the two tiers price the same
    packetization."""
    if nbytes <= 0:
        return 0.0, 1
    pkt = float(min(packet_bytes, int(cap) or 1))
    npkts = -(-nbytes // pkt)
    if npkts > max_packets:
        pkt = min(nbytes / max_packets, cap)
    return pkt, int(-(-nbytes // pkt))


# ----------------------------------------------------------------------------
# fault-epoch route caching
#
# Repeated probes, re-striping and schedule injections recompute identical
# BFS detours: the fault map only changes at fault *epochs* (fail_link /
# clear_faults), yet every ``probe_route`` -> ``candidate_routes`` walk and
# every fault-routed ``inject`` re-ran the BFS from scratch.  Both caches
# key on the full (torus dims, src, dst, FaultMap) value — FaultMap is a
# frozen dataclass of frozensets, so a *new* epoch is a new key and stale
# hits are impossible; ``clear_route_cache`` (called by the serving
# cluster's fail_link/clear_faults) drops the dead epoch's entries so the
# caches stay bounded by the live epoch's working set.
# ----------------------------------------------------------------------------

_ROUTE_CACHE_CAP = 65536
_bfs_cache: dict = {}
_candidates_cache: dict = {}
_MISS = object()

# Cumulative hit/miss tallies for the module-level route caches.  The
# caches are free functions shared by every sim, so their stats live
# here; a ``Telemetry`` hub copies them in as gauges on an explicit
# ``collect()`` — never on the hot path, so probe-invariance tests stay
# clean.  Plain int increments: invisible to any replay metric.
ROUTE_CACHE_STATS = {"bfs_hits": 0, "bfs_misses": 0,
                     "cand_hits": 0, "cand_misses": 0}


def clear_route_cache() -> None:
    """Invalidate the per-fault-epoch route caches (BFS paths and
    candidate detour families).  Callers that mutate the fault world —
    ``ServingCluster.fail_link``/``clear_faults`` — invoke this so the
    previous epoch's entries are released."""
    _bfs_cache.clear()
    _candidates_cache.clear()


def _cached_bfs(torus: Torus, src: int, dst: int,
                faults: FaultMap) -> list[int] | None:
    key = (torus.dims, src, dst, faults)
    hit = _bfs_cache.get(key, _MISS)
    if hit is _MISS:
        ROUTE_CACHE_STATS["bfs_misses"] += 1
        if len(_bfs_cache) >= _ROUTE_CACHE_CAP:
            _bfs_cache.clear()
        hit = _bfs_cache[key] = _bfs_path(torus, src, dst, faults)
    else:
        ROUTE_CACHE_STATS["bfs_hits"] += 1
    return hit


class _Link:
    """One directed link (or host-IF resource): per-class virtual-channel
    FIFOs + partitioned credit windows, drained by the weighted arbiter."""

    __slots__ = ("free_at", "queues", "credits", "vtime", "vfloor",
                 "busy_s", "bytes_carried", "class_bytes", "retry_at")

    def __init__(self, credits: Sequence[float]) -> None:
        self.free_at = 0.0
        self.queues = tuple([] for _ in credits)  # per-class FIFO of _Pkt
        self.credits = list(credits)  # downstream buffer bytes, per class
        # start-time-fair arbiter state: a class's virtual time advances by
        # cost/weight per service; the backlogged class with the least
        # virtual time transmits next (single class: always channel 0)
        self.vtime = [0.0 for _ in credits]
        self.vfloor = 0.0            # service frontier for re-activations
        self.busy_s = 0.0
        self.bytes_carried = 0.0
        # carried bytes per traffic-class TAG (not per channel): stays
        # meaningful under single_class, where every tag shares channel 0
        self.class_bytes = [0.0] * len(TrafficClass)
        self.retry_at: float | None = None   # pending retry event (dedup)


class _Pkt:
    __slots__ = ("fid", "idx", "hop", "nbytes", "prev", "route")

    def __init__(self, fid: int, idx: int, hop: int, nbytes: float,
                 prev: tuple | None,
                 route: tuple[int, ...] = ()) -> None:
        self.fid = fid
        self.idx = idx           # packet index within the flow
        self.hop = hop           # index of the link being traversed
        self.nbytes = nbytes
        self.prev = prev         # upstream link key owed a credit return
        # per-packet route tag: the flow's route at FEED time.  In-flight
        # packets keep walking the path they were launched on even after
        # ``restripe`` re-points the flow, so a half-sent striped PUT can
        # re-split its unsent remainder without corrupting the packets
        # already committed to the old path (§2.1's per-packet header
        # routing, as opposed to per-flow circuit state).
        self.route = route


class _Flow:
    __slots__ = ("fid", "route", "nbytes", "pkt_bytes", "npkts", "sent",
                 "arrived", "req_start", "start_s", "finish_s", "pending",
                 "dependents", "src_over", "dst_over", "pace_s", "service_s",
                 "resource", "channel", "label", "cls", "cidx")

    def __init__(self, fid: int) -> None:
        self.fid = fid
        self.route: tuple[int, ...] = ()
        self.nbytes = 0.0
        self.pkt_bytes = 0.0
        self.npkts = 0
        self.sent = 0
        self.arrived = 0
        self.req_start = 0.0
        self.start_s: float | None = None
        self.finish_s: float | None = None
        self.pending = 0                 # unfinished dependencies
        self.dependents: list[int] = []
        self.src_over = 0.0
        self.dst_over = 0.0
        self.pace_s = 0.0                # source pacing gap (GPU read cap)
        self.service_s: float | None = None   # resource occupancy duration
        self.resource: Hashable | None = None
        self.channel = 0                 # cable pick on 2-rings (see below)
        self.label = ""
        self.cls: TrafficClass | None = None  # traffic class tag
        self.cidx = 0                    # virtual-channel index under policy


class _Journal:
    """Copy-on-write undo log for ``probe_route``: instead of snapshotting
    the whole sim up front, the probe records each link/flow/packet's
    state the FIRST time the ghost traffic touches it.  Rolling back
    therefore costs O(state the probe actually perturbed) — the candidate
    route's links plus the flows crossing them — not O(resident sim),
    which is the difference between O(k · route) and O(k · cluster) when
    probing k candidates on a 512-node serving timeline."""

    __slots__ = ("links", "flows", "pkts", "heap", "frontier", "seq_n",
                 "fid_n", "stale")

    def __init__(self, heap: list, frontier: float, seq_n: int, fid_n: int,
                 stale: int) -> None:
        self.links: dict = {}        # key -> saved field tuple | None (new)
        self.flows: dict = {}        # fid -> saved mutable fields
        self.pkts: dict = {}         # id(pkt) -> (pkt, hop, prev)
        self.heap = heap             # heap list copied eagerly (events are
        self.frontier = frontier     # tuples; mutable pkts inside are
        self.seq_n = seq_n           # journalled at their mutation site)
        self.fid_n = fid_n
        self.stale = stale


@dataclasses.dataclass(frozen=True)
class FlowResult:
    """Completed flow, as reported by ``FabricSim.flow``."""

    fid: int
    src: int
    dst: int
    nbytes: float
    hops: int
    start_s: float
    finish_s: float
    label: str = ""
    cls: TrafficClass | None = None

    @property
    def duration_s(self) -> float:
        return self.finish_s - self.start_s

    @property
    def bandwidth(self) -> float:
        d = self.duration_s
        return self.nbytes / d if d > 0 else float("inf")


class FabricSim:
    """Event-driven link-level simulator over one ``Torus`` fabric.

    Flows are injected (``inject`` for wire transfers, ``occupy`` for
    rank-local host-interface DMA occupancy), optionally chained with
    ``after=`` and tagged with a ``TrafficClass``; ``run()`` drains the
    event queue.  ``qos`` selects the link arbiter: the default
    ``QosPolicy(single_class=True)`` is the classic single-FIFO link
    (class tags are inert); a multi-class ``QosPolicy()`` gives every
    class its own virtual channel, weight-proportional bandwidth under
    contention and a private credit partition.  The clock only moves
    forward: ``now`` is the frontier, and a timeline owner (the serving
    cluster) can ``advance`` it between logical windows.  Injecting at a
    time the simulator already processed is allowed but conservative —
    the new packets queue behind whatever the links already committed to.
    """

    def __init__(self, torus: Torus, net: NetModel | None = None, *,
                 packet_bytes: int = DEFAULT_PACKET_BYTES,
                 credit_bytes: float | None = None,
                 max_packets_per_flow: int = DEFAULT_MAX_PACKETS,
                 faults: FaultMap | None = None,
                 qos: QosPolicy | None = None,
                 telemetry: "object | None" = None) -> None:
        if packet_bytes <= 0:
            raise ValueError(f"packet_bytes must be > 0, got {packet_bytes}")
        self.torus = torus
        self.net = net or NetModel()
        self.faults = faults or FaultMap()
        self.qos = qos or SINGLE_CLASS
        self.link_bw = apelink.sustained_bandwidth(self.net.link)
        self.credit_bytes = (float(credit_bytes) if credit_bytes is not None
                             else apelink.channel_footprint_bytes(
                                 self.net.link))
        if self.credit_bytes <= 0:
            raise ValueError("credit_bytes must be > 0")
        self.packet_bytes = min(packet_bytes, int(self.credit_bytes) or 1)
        self.max_packets = max(1, max_packets_per_flow)
        self._weights = self.qos.weight_vector()
        self._class_credits = self.qos.partition_credits(self.credit_bytes)
        self._links: dict = {}
        self._flows: dict[int, _Flow] = {}
        self._heap: list = []
        self._seq_n = 0          # event tie-break counter (plain int so
        self._fid_n = 0          # probe snapshots can restore it exactly)
        self._frontier = 0.0
        self._stale = 0          # superseded retry events still in the heap
        self._journal: _Journal | None = None   # active probe journal
        self.last_probe_report: dict | None = None
        self.deadlock_breaks = 0   # escape-credit recoveries (see _unstick)
        # optional Telemetry hub.  Every hook is gated on
        # ``telemetry is not None and self._journal is None``: None is
        # bitwise-invisible, and probe ghosts never reach the hub.  All
        # derived telemetry state lives hub-side, so attaching one
        # changes NOTHING about sim state, snapshots, or rollbacks.
        self.telemetry = telemetry

    # -- clock ----------------------------------------------------------------
    @property
    def now(self) -> float:
        """The timeline frontier (latest processed/advanced time)."""
        return self._frontier

    def advance(self, t: float) -> None:
        """Move the frontier forward (never backward) — the timeline
        owner's logical-window boundary."""
        self._frontier = max(self._frontier, t)

    # -- link identity --------------------------------------------------------
    def _link_key(self, u: int, v: int, channel: int) -> tuple:
        """Physical cable identity of the hop u -> v (see ``link_key``)."""
        return link_key(self.torus, u, v, channel)

    # -- injection ------------------------------------------------------------
    def _resolve_route(self, src: int, dst: int,
                       route: Sequence[int] | None) -> tuple[int, ...]:
        if route is not None:
            route = tuple(route)
            if len(route) < 1 or route[0] != src or route[-1] != dst:
                raise ValueError(f"route {route} does not join {src}->{dst}")
            return route
        if src == dst:
            return (src,)
        if not self.faults:
            return tuple(self.torus.route(src, dst))
        path = _cached_bfs(self.torus, src, dst, self.faults)
        if path is None:
            raise UnroutableError(
                f"no surviving route {src} -> {dst} in the simulated fabric")
        return tuple(path)

    def _packetize(self, nbytes: float, cap: float) -> tuple[float, int]:
        """Packet size/count for a flow whose class credit partition is
        ``cap`` (see module-level ``packetize``)."""
        return packetize(nbytes, cap, self.packet_bytes, self.max_packets)

    def _new_flow(self, start_s: float | None,
                  after: Sequence[int]) -> _Flow:
        f = _Flow(self._fid_n)
        self._fid_n += 1
        f.req_start = self._frontier if start_s is None else float(start_s)
        self._flows[f.fid] = f
        for dep_fid in after:
            dep = self._flows[dep_fid]
            if dep.finish_s is None:
                self._j_flow(dep)
                dep.dependents.append(f.fid)
                f.pending += 1
            else:
                f.req_start = max(f.req_start, dep.finish_s)
        if f.pending == 0:
            self._push(f.req_start, "start", f.fid)
        return f

    def inject(self, src: int, dst: int, nbytes: float, *,
               start_s: float | None = None,
               route: Sequence[int] | None = None,
               after: Sequence[int] = (),
               src_gpu: bool = False, dst_gpu: bool = False,
               channel: int = 0, label: str = "",
               cls: TrafficClass = TrafficClass.BULK) -> int:
        """Inject one flow of ``nbytes`` from rank ``src`` to ``dst``.

        ``route`` overrides the dimension-ordered (or fault-BFS) default;
        ``after`` lists flow ids that must finish first; ``channel`` picks
        the cable on ambiguous 2-ring hops (see ``_link_key``); ``cls``
        tags the flow's traffic class (inert under a single-class policy).
        Returns the flow id — query its completion with
        ``finish_s``/``flow`` after ``run()``.
        """
        f = self._new_flow(start_s, after)
        f.route = self._resolve_route(src, dst, route)
        f.channel = channel
        f.cls = TrafficClass(cls)
        f.cidx = self.qos.class_index(f.cls)
        f.nbytes = float(nbytes)
        cap = self._class_credits[f.cidx]
        if not self.qos.single_class:
            # keep >= 2 packets inside the class's credit window: a packet
            # as large as the whole partition leaves the channel credit-
            # blocked at every arbitration instant (credits return one
            # t_hop after transmit), handing lower-weight classes a slot
            # they haven't earned
            cap = max(cap * 0.5, 1.0)
        f.pkt_bytes, f.npkts = self._packetize(f.nbytes, cap)
        f.src_over = self.net.t_inject \
            + (self.net.gpu_touch_overhead if src_gpu else 0.0)
        f.dst_over = self.net.t_receive \
            + (self.net.gpu_touch_overhead if dst_gpu else 0.0)
        if src_gpu and self.net.gpu_read_cap < self.link_bw:
            # GPU-outbound read bottleneck (Fig 3c): the source cannot feed
            # the link faster than the P2P read rate
            f.pace_s = f.pkt_bytes / self.net.gpu_read_cap
        f.label = label
        return f.fid

    def occupy(self, resource: Hashable, busy_s: float, *,
               start_s: float | None = None,
               after: Sequence[int] = (), label: str = "",
               cls: TrafficClass = TrafficClass.BULK) -> int:
        """Occupy a rank-local FIFO resource (e.g. ``("hostif", rank)``)
        for ``busy_s`` seconds — the host-interface DMA drain of one
        operation.  Concurrent occupiers of the same resource serialize;
        under a multi-class policy the arbiter weighs occupiers of
        different classes by their service seconds."""
        if busy_s < 0:
            raise ValueError(f"negative busy_s {busy_s}")
        f = self._new_flow(start_s, after)
        f.resource = resource
        f.service_s = float(busy_s)
        f.npkts = 1
        f.label = label
        f.cls = TrafficClass(cls)
        f.cidx = self.qos.class_index(f.cls)
        return f.fid

    # -- event machinery ------------------------------------------------------
    def _push(self, t: float, kind: str, arg) -> None:
        heapq.heappush(self._heap, (t, self._seq_n, kind, arg))
        self._seq_n += 1
        if self._stale > 64 and self._stale * 2 > len(self._heap) \
                and self._journal is None:
            self._compact()

    def _compact(self) -> None:
        """Drop provably superseded retry events (an earlier wake than the
        link's pending ``retry_at`` is a ghost: when popped it finds the
        link still busy and no-ops).  Long workloads with same-instant
        credit returns accumulate these; compacting lazily once they
        exceed half the heap keeps the heap bounded by live events
        without changing any processing order."""
        live = []
        for ev in self._heap:
            if ev[2] == "retry":
                link = self._links.get(ev[3])
                if link is not None and link.retry_at is not None \
                        and ev[0] < link.retry_at:
                    continue
            live.append(ev)
        self._heap = live
        heapq.heapify(live)
        self._stale = 0

    def _link(self, key) -> _Link:
        link = self._links.get(key)
        j = self._journal
        if j is not None and key not in j.links:
            # first touch under an active probe: record the pre-image
            j.links[key] = None if link is None else (
                link.free_at, tuple(list(q) for q in link.queues),
                list(link.credits), list(link.vtime), link.vfloor,
                link.busy_s, link.bytes_carried, list(link.class_bytes),
                link.retry_at)
        if link is None:
            link = self._links[key] = _Link(self._class_credits)
        return link

    def _j_flow(self, f: _Flow) -> None:
        """Journal a pre-existing flow's mutable fields on first touch."""
        j = self._journal
        if j is not None and f.fid < j.fid_n and f.fid not in j.flows:
            j.flows[f.fid] = (f.sent, f.arrived, f.req_start, f.start_s,
                              f.finish_s, f.pending, list(f.dependents))

    def _j_pkt(self, p: _Pkt) -> None:
        """Journal a pre-existing packet's routing fields on first touch."""
        j = self._journal
        if j is not None and p.fid < j.fid_n and id(p) not in j.pkts:
            j.pkts[id(p)] = (p, p.hop, p.prev)

    def _enqueue(self, key, pkt: _Pkt, now: float) -> None:
        link = self._link(key)
        q = link.queues[self._flows[pkt.fid].cidx]
        if not q:
            # re-activation joins at the service frontier, so an idle class
            # cannot bank virtual time and then monopolize the link
            c = self._flows[pkt.fid].cidx
            link.vtime[c] = max(link.vtime[c], link.vfloor)
        q.append(pkt)
        self._try_start(key, now)

    def _pick(self, link: _Link) -> int | None:
        """The backlogged virtual channel that transmits next: least
        virtual time among channels whose head packet has credit (ties
        break toward the lowest class index).  None = every backlogged
        channel is credit-blocked."""
        best = -1
        best_v = 0.0
        for c, q in enumerate(link.queues):
            if not q:
                continue
            pkt = q[0]
            if pkt.nbytes > link.credits[c] \
                    and self._flows[pkt.fid].resource is None:
                continue   # this channel is blocked until credit returns
            v = link.vtime[c]
            if best < 0 or v < best_v:
                best, best_v = c, v
        return None if best < 0 else best

    def _try_start(self, key, now: float) -> None:
        link = self._link(key)
        while any(link.queues):
            if link.free_at > now:
                # one pending retry per link: re-pushing at the same (or a
                # later) wake time only duplicates work the scheduled one
                # will do anyway
                if link.retry_at is None or link.retry_at > link.free_at \
                        or link.retry_at <= now:
                    if link.retry_at is not None:
                        # the old retry event is now a superseded ghost
                        # still sitting in the heap — count it so
                        # ``_compact`` knows when ghosts dominate
                        self._stale += 1
                    self._push(link.free_at, "retry", key)
                    link.retry_at = link.free_at
                return
            c = self._pick(link)
            if c is None:
                tel = self.telemetry
                if tel is not None and self._journal is None:
                    tel.on_credit_block(key, now)
                return   # all backlogged channels credit-blocked
            pkt: _Pkt = link.queues[c].pop(0)
            flow = self._flows[pkt.fid]
            is_resource = flow.resource is not None
            if is_resource:
                dur = flow.service_s or 0.0
                cost = dur       # seconds-unit fairness on resource links
            else:
                link.credits[c] -= pkt.nbytes
                dur = pkt.nbytes / self.link_bw
                cost = pkt.nbytes
            # start-time-fair accounting (a no-op under single_class)
            link.vfloor = max(link.vfloor, link.vtime[c])
            link.vtime[c] += cost / self._weights[c]
            start = max(link.free_at, now)
            link.free_at = start + dur
            link.busy_s += dur
            link.bytes_carried += pkt.nbytes
            link.class_bytes[int(flow.cls)] += pkt.nbytes
            tel = self.telemetry
            if tel is not None and self._journal is None:
                # mirrors the three += above in the same order, so the
                # hub's per-key counters cross-check EXACTLY
                tel.on_link_tx(key, int(flow.cls), pkt.nbytes, dur,
                               start, is_resource)
            if pkt.prev is not None:
                # the packet left the upstream buffer: credit flows back
                up = self._link(pkt.prev)
                up.credits[c] += pkt.nbytes
                self._try_start(pkt.prev, now)
            if is_resource:
                self._push(link.free_at, "done", pkt)
                continue
            if pkt.hop == 0 and flow.sent < flow.npkts:
                self._feed_source(flow, start)
            self._push(link.free_at + self.net.t_hop, "arrive", pkt)

    def _feed_source(self, flow: _Flow, now: float) -> None:
        """Queue the flow's next packet at the first link.

        One packet per flow sits at the link head at a time, so each
        virtual channel round-robins its concurrent flows at packet
        granularity; ``pace_s`` throttles GPU-outbound sources."""
        self._j_flow(flow)
        idx = flow.sent
        flow.sent += 1
        last = flow.npkts - 1
        nbytes = (flow.nbytes - last * flow.pkt_bytes) if idx == last \
            else flow.pkt_bytes
        pkt = _Pkt(flow.fid, idx, 0, max(nbytes, 0.0), None, flow.route)
        ready = (flow.start_s or 0.0) + flow.src_over + idx * flow.pace_s
        key = self._link_key(pkt.route[0], pkt.route[1], flow.channel)
        if ready > now:
            self._push(ready, "enqueue", (key, pkt))
        else:
            self._enqueue(key, pkt, now)

    def _finish_flow(self, flow: _Flow, t: float) -> None:
        self._j_flow(flow)
        flow.finish_s = t
        self._frontier = max(self._frontier, t)
        tel = self.telemetry
        if tel is not None and self._journal is None:
            start = flow.start_s if flow.start_s is not None \
                else flow.req_start
            if flow.resource is not None:
                track = ("node", flow.resource)
            elif len(flow.route) >= 2:
                track = ("link", self._link_key(flow.route[0],
                                                flow.route[1],
                                                flow.channel))
            else:
                track = ("node", flow.route[0] if flow.route else -1)
            tel.flow_span(track, flow.label or f"flow{flow.fid}",
                          start, t, cls=int(flow.cls),
                          nbytes=flow.nbytes, fid=flow.fid)
        for dep_fid in flow.dependents:
            dep = self._flows[dep_fid]
            self._j_flow(dep)
            dep.pending -= 1
            dep.req_start = max(dep.req_start, t)
            if dep.pending == 0:
                self._push(dep.req_start, "start", dep.fid)
        flow.dependents = []

    def _start_flow(self, flow: _Flow, now: float) -> None:
        self._j_flow(flow)
        flow.start_s = now
        if flow.resource is not None:
            self._enqueue(flow.resource, _Pkt(flow.fid, 0, 0, 0.0, None), now)
            return
        if len(flow.route) < 2:      # self-send: no wire
            self._finish_flow(flow, now)
            return
        self._feed_source(flow, now)

    def run(self) -> float:
        """Process every pending event; returns the frontier time."""
        while True:
            self._drain()
            if not self._unstick():
                return self._frontier

    def run_until(self, t: float) -> float:
        """Process every event up to and including time ``t``, then stop
        with later events still pending — the checkpoint a mid-flight
        re-striping PUT uses to inspect its unsent remainder.  A later
        ``run()``/``run_until`` picks up exactly where this left off, in
        the same heap order a straight ``run()`` would have used; credit-
        deadlock recovery (``_unstick``) only engages on a full ``run``,
        so a partial drain is always conservative."""
        while self._heap and self._heap[0][0] <= t:
            et, _, kind, arg = heapq.heappop(self._heap)
            self._frontier = max(self._frontier, et)
            self._dispatch(et, kind, arg)
        self._frontier = max(self._frontier, t)
        return self._frontier

    def _drain(self) -> None:
        while self._heap:
            t, _, kind, arg = heapq.heappop(self._heap)
            self._frontier = max(self._frontier, t)
            self._dispatch(t, kind, arg)

    def _dispatch(self, t: float, kind: str, arg) -> None:
        if kind == "start":
            self._start_flow(self._flows[arg], t)
        elif kind == "retry":
            link = self._link(arg)
            if link.retry_at is not None and link.retry_at <= t:
                link.retry_at = None
            else:
                # a superseded ghost drained out of the heap on its own
                self._stale = max(0, self._stale - 1)
            self._try_start(arg, t)
        elif kind == "enqueue":
            key, pkt = arg
            self._enqueue(key, pkt, t)
        elif kind == "done":
            self._finish_flow(self._flows[arg.fid], t)
        elif kind == "arrive":
            pkt: _Pkt = arg
            flow = self._flows[pkt.fid]
            here = pkt.hop + 1
            up_key = self._link_key(pkt.route[pkt.hop],
                                    pkt.route[here], flow.channel)
            if here == len(pkt.route) - 1:
                # consumed at the endpoint: buffer drains immediately
                up = self._link(up_key)
                up.credits[flow.cidx] += pkt.nbytes
                self._try_start(up_key, t)
                self._j_flow(flow)
                flow.arrived += 1
                if flow.arrived == flow.npkts:
                    self._finish_flow(flow, t + flow.dst_over)
            else:
                nxt = self._link_key(pkt.route[here],
                                     pkt.route[here + 1], flow.channel)
                self._j_pkt(pkt)
                pkt.hop = here
                pkt.prev = up_key
                self._enqueue(nxt, pkt, t)

    def _unstick(self) -> bool:
        """Credit-deadlock recovery (escape credit); True if it made
        progress.

        Dimension-ordered routes on the wrap-around rings of a torus can
        form a cyclic buffer wait under partitioned per-class credits:
        every backlogged channel's head packet needs more credit than its
        link holds, and that credit can only return once a downstream
        link in the same cycle transmits.  The event heap then drains
        with packets still queued — a state a completing run can never
        reach (a startable head always has a pending wake event), so
        engaging here never perturbs a workload that finishes on its
        own.  Recovery mirrors hardware escape/bubble flow control: the
        oldest blocked head packet borrows exactly the missing credit —
        the class balance goes negative and is repaid by the packet's
        normal downstream credit return — guaranteeing at least one
        transmission of forward progress per call."""
        best = None
        for key, link in self._links.items():
            for c, q in enumerate(link.queues):
                if not q:
                    continue
                pkt = q[0]
                if pkt.nbytes <= link.credits[c] \
                        or self._flows[pkt.fid].resource is not None:
                    continue
                order = (pkt.fid, pkt.idx, pkt.hop)
                if best is None or order < best[0]:
                    best = (order, key, c)
        if best is None:
            return False
        _, key, c = best
        link = self._link(key)
        need = link.queues[c][0].nbytes - link.credits[c]
        link.credits[c] += need          # loan the escape credit
        self.deadlock_breaks += 1
        if self.telemetry is not None and self._journal is None:
            self.telemetry.on_escape_loan(key, c, need)
        self._try_start(key, self._frontier)
        link.credits[c] -= need          # balance now negative: the loan
        return True                      # is repaid on the credit return

    # -- results --------------------------------------------------------------
    def finish_s(self, fid: int) -> float:
        flow = self._flows[fid]
        if flow.finish_s is None:
            self.run()
        if flow.finish_s is None:
            raise RuntimeError(f"flow {fid} never completed "
                               "(unsatisfied dependency?)")
        return flow.finish_s

    def flow(self, fid: int) -> FlowResult:
        f = self._flows[fid]
        return FlowResult(
            fid=fid,
            src=f.route[0] if f.route else -1,
            dst=f.route[-1] if f.route else -1,
            nbytes=f.nbytes, hops=max(len(f.route) - 1, 0),
            start_s=f.start_s if f.start_s is not None else f.req_start,
            finish_s=self.finish_s(fid), label=f.label, cls=f.cls)

    def link_stats(self) -> dict:
        """Per-directed-link busy seconds and carried bytes (reporting);
        ``class_bytes`` breaks the carried bytes down by traffic-class
        TAG — always ``len(TrafficClass)`` entries, meaningful even under
        ``single_class`` arbitration (where all tags share one channel)."""
        return {k: {"busy_s": v.busy_s, "bytes": v.bytes_carried,
                    "class_bytes": tuple(v.class_bytes)}
                for k, v in ordered_link_items(self._links.items())}

    def class_stats(self, since: dict | None = None
                    ) -> dict[TrafficClass, float]:
        """Bytes carried per traffic-class tag, summed over every directed
        link (each wire hop counts — a 3-hop flow carries 3x its payload).
        Accounting is by the flow's ``cls`` tag, so the breakdown is
        meaningful even under ``single_class`` arbitration.

        ``since`` takes a previous ``class_stats()`` mapping and returns
        the per-class DELTA — the bytes carried inside one replay window,
        which is what the closed-loop QoS controller steers on (run-
        lifetime averages wash out exactly the transient it must react
        to).  Reading stats never mutates the sim, so two identical
        windows report identical deltas."""
        totals = [0.0] * len(TrafficClass)
        for link in self._links.values():
            for c in range(len(TrafficClass)):
                totals[c] += link.class_bytes[c]
        out = {cls: totals[int(cls)] for cls in TrafficClass}
        if since is not None:
            for cls in out:
                out[cls] -= float(since.get(cls, 0.0))
        return out

    # -- live QoS retune -------------------------------------------------------
    def set_qos(self, policy: QosPolicy) -> None:
        """Swap the arbitration policy on a LIVE timeline — the closed-loop
        controller's actuator.  Weights take effect at the next arbitration
        decision (the arbiter reads them per service); credit partitions are
        re-applied as a per-class DELTA to every existing link's balance, so
        outstanding in-flight debits (and any escape-credit loans) stay
        consistent: a link that owes 12 KB of BULK credit still owes it
        after the retune, it just owes it against the new partition."""
        if self._journal is not None:
            raise RuntimeError("set_qos under an active probe journal")
        if policy.n_classes != self.qos.n_classes:
            raise ValueError(
                "cannot change the virtual-channel count of a live sim "
                f"({self.qos.n_classes} -> {policy.n_classes})")
        old = self._class_credits
        new = policy.partition_credits(self.credit_bytes)
        self.qos = policy
        self._weights = policy.weight_vector()
        self._class_credits = new
        for key, link in self._links.items():
            for c in range(len(new)):
                if new[c] != old[c]:
                    link.credits[c] += new[c] - old[c]
        # a credit raise may unblock queued heads immediately
        for key, link in self._links.items():
            if any(link.queues):
                self._try_start(key, self._frontier)
        if self.telemetry is not None:
            self.telemetry.add("fabric.qos_retunes")

    # -- mid-flight re-striping ------------------------------------------------
    def unsent_bytes(self, fid: int) -> float:
        """Bytes of ``fid`` not yet committed to a route — the remainder a
        mid-flight re-stripe may re-split.  Packets already FED to the
        first link (queued or in flight) are committed: their per-packet
        route tags pin them to the path they launched on."""
        f = self._flows[fid]
        if f.finish_s is not None or f.resource is not None:
            return 0.0
        if f.start_s is None:
            return f.nbytes
        return max(f.nbytes - f.sent * f.pkt_bytes, 0.0)

    def restripe(self, fid: int, plan: Sequence[tuple]) -> list[int]:
        """Re-split flow ``fid``'s unsent remainder across a fresh
        ``striped_routes``-style plan ``[(route, frac), ...]`` — the
        mid-flight re-striping a half-sent bulk PUT performs when probed
        congestion has shifted since its original stripe plan.

        The flow itself is re-pointed at ``plan[0]`` and shrunk to carry
        that route's share of the remainder (its in-flight packets keep
        their per-packet route tags); every other plan route gets a fresh
        sibling flow starting now.  Returns the flow ids carrying the
        payload from here on (``fid`` first).  Each sibling re-issues a
        source descriptor, so it pays ``t_inject`` again — re-striping is
        not free, which is exactly why the controller only triggers it on
        a detected congestion shift."""
        if self._journal is not None:
            raise RuntimeError("restripe under an active probe journal")
        f = self._flows[fid]
        if f.resource is not None:
            raise ValueError("cannot restripe a resource occupancy")
        if f.start_s is None:
            raise ValueError(f"flow {fid} has not started; nothing is "
                             "committed yet — re-plan the whole transfer")
        rem = self.unsent_bytes(fid)
        routes: list[tuple[int, ...]] = []
        fracs: list[float] = []
        for route, frac in plan:
            route = tuple(route)
            if route[0] != f.route[0] or route[-1] != f.route[-1]:
                raise ValueError(f"plan route {route} does not join "
                                 f"{f.route[0]}->{f.route[-1]}")
            if frac > 0.0:
                routes.append(route)
                fracs.append(float(frac))
        if rem <= 0.0 or not routes:
            return [fid]
        total = sum(fracs)
        shares = [rem * fr / total for fr in fracs]
        # the original flow keeps plan[0]'s share; packets it already fed
        # were all full-size (the short tail packet is by construction the
        # LAST one, and rem > 0 means it has not been fed)
        sent_bytes = f.sent * f.pkt_bytes
        f.route = routes[0]
        f.nbytes = sent_bytes + shares[0]
        f.npkts = f.sent + int(-(-shares[0] // f.pkt_bytes))
        out = [fid]
        for route, share in zip(routes[1:], shares[1:]):
            nfid = self.inject(
                route[0], route[-1], share, start_s=self._frontier,
                route=route, channel=f.channel, cls=f.cls,
                label=(f.label + "+restripe") if f.label else "restripe")
            nf = self._flows[nfid]
            nf.src_over = f.src_over       # same endpoint overheads as the
            nf.dst_over = f.dst_over       # leg it split from (GPU touch,
            nf.pace_s = f.pace_s           # outbound read pacing)
            out.append(nfid)
        if self.telemetry is not None:
            self.telemetry.add("fabric.restripes")
            self.telemetry.add("fabric.restripe_siblings",
                               float(len(out) - 1))
        return out

    def prune(self) -> int:
        """Drop finished flows from the registry; returns how many.

        A long-lived timeline (the serving cluster's) accumulates settled
        flows forever otherwise, growing both the resident sim and every
        ``probe_route`` snapshot without bound.  The owner calls this
        once its window accounting has read the finishes it needs —
        pruned flow ids can no longer be queried or used as ``after=``
        dependencies.  Link state (busy-until, credits, queues) is live
        scheduling state and is kept."""
        done = [fid for fid, f in self._flows.items()
                if f.finish_s is not None]
        for fid in done:
            del self._flows[fid]
        return len(done)

    # -- what-if probing -------------------------------------------------------
    def _snapshot(self) -> tuple:
        """Record every piece of mutable scheduling state — links (queues,
        credits, arbiter clocks), flows' progress, packets in flight, the
        event heap and the counters — WITHOUT copying the static half of
        the sim (torus, net, fault map, policy).  Bounded by the in-flight
        state, where the old ``copy.deepcopy`` ghost was O(whole sim) per
        probe."""
        pkts: list[tuple] = []
        seen: set[int] = set()

        def note(p: _Pkt) -> None:
            if id(p) not in seen:
                seen.add(id(p))
                pkts.append((p, p.hop, p.prev))

        links = {}
        for k, link in self._links.items():
            queues = tuple(list(q) for q in link.queues)
            for q in queues:
                for p in q:
                    note(p)
            links[k] = (link.free_at, queues, list(link.credits),
                        list(link.vtime), link.vfloor, link.busy_s,
                        link.bytes_carried, list(link.class_bytes),
                        link.retry_at)
        heap = list(self._heap)
        for _, _, kind, arg in heap:
            if kind in ("arrive", "done"):
                note(arg)
            elif kind == "enqueue":
                note(arg[1])
        flows = {fid: (f.sent, f.arrived, f.req_start, f.start_s,
                       f.finish_s, f.pending, list(f.dependents))
                 for fid, f in self._flows.items()}
        return (links, pkts, heap, flows, self._frontier,
                self._seq_n, self._fid_n, self._stale)

    def _restore(self, snap: tuple) -> None:
        """Put every mutable field back exactly as ``_snapshot`` saw it;
        objects created since (ghost flows, their packets and events, new
        links) are dropped.  The snapshot is consumed — its saved lists
        become the live state."""
        links, pkts, heap, flows, frontier, seq_n, fid_n, stale = snap
        for k in [k for k in self._links if k not in links]:
            del self._links[k]
        for k, (free_at, queues, credits, vtime, vfloor, busy_s,
                carried, class_bytes, retry_at) in links.items():
            link = self._links[k]
            link.free_at = free_at
            link.queues = queues
            link.credits = credits
            link.vtime = vtime
            link.vfloor = vfloor
            link.busy_s = busy_s
            link.bytes_carried = carried
            link.class_bytes = class_bytes
            link.retry_at = retry_at
        for p, hop, prev in pkts:
            p.hop = hop
            p.prev = prev
        self._heap = heap
        for fid in [fid for fid in self._flows if fid not in flows]:
            del self._flows[fid]
        for fid, (sent, arrived, req_start, start_s, finish_s, pending,
                  dependents) in flows.items():
            f = self._flows[fid]
            f.sent = sent
            f.arrived = arrived
            f.req_start = req_start
            f.start_s = start_s
            f.finish_s = finish_s
            f.pending = pending
            f.dependents = dependents
        self._frontier = frontier
        self._seq_n = seq_n
        self._fid_n = fid_n
        self._stale = stale

    def _rollback(self, j: _Journal) -> None:
        """Undo everything the probe touched, exactly as the journal's
        pre-images recorded it; ghost flows/links/events vanish."""
        for key, saved in j.links.items():
            if saved is None:
                self._links.pop(key, None)     # link created by the probe
                continue
            link = self._links[key]
            (link.free_at, link.queues, link.credits, link.vtime,
             link.vfloor, link.busy_s, link.bytes_carried,
             link.class_bytes, link.retry_at) = saved
        for fid in range(j.fid_n, self._fid_n):   # ghost flows
            self._flows.pop(fid, None)
        for fid, (sent, arrived, req_start, start_s, finish_s, pending,
                  dependents) in j.flows.items():
            f = self._flows[fid]
            f.sent = sent
            f.arrived = arrived
            f.req_start = req_start
            f.start_s = start_s
            f.finish_s = finish_s
            f.pending = pending
            f.dependents = dependents
        for p, hop, prev in j.pkts.values():
            p.hop = hop
            p.prev = prev
        self._heap = j.heap
        self._frontier = j.frontier
        self._seq_n = j.seq_n
        self._fid_n = j.fid_n
        self._stale = j.stale

    def probe_route(self, route: Sequence[int], nbytes: float, *,
                    start_s: float | None = None, **kw) -> float:
        """Simulated completion time of a hypothetical flow along
        ``route`` against the CURRENT traffic, without committing anything
        to the timeline.

        Runs on the live simulator under a copy-on-write journal: state is
        recorded lazily the first time the ghost traffic touches it, so
        the rollback cost is bounded by the links on the probed route plus
        the flows crossing them — not the whole resident sim.  The last
        probe's touch counts are published in ``last_probe_report``."""
        start = self._frontier if start_s is None else start_s

        def ghost() -> float:
            fid = self.inject(route[0], route[-1], nbytes, start_s=start,
                              route=route, **kw)
            return self.finish_s(fid) - start

        db = self.deadlock_breaks
        if self._journal is not None:
            # nested probe: fall back to the eager full snapshot
            snap = self._snapshot()
            try:
                return ghost()
            finally:
                self._restore(snap)
                self.deadlock_breaks = db
        j = _Journal(heap=list(self._heap), frontier=self._frontier,
                     seq_n=self._seq_n, fid_n=self._fid_n,
                     stale=self._stale)
        self._journal = j
        try:
            out = ghost()
        finally:
            self._journal = None
            self._rollback(j)
            self.deadlock_breaks = db
        self.last_probe_report = {
            "links_touched": len(j.links),
            "flows_touched": len(j.flows),
            "pkts_touched": len(j.pkts),
            "links_total": len(self._links),
            "flows_total": len(self._flows),
        }
        if self.telemetry is not None:
            # stamped AFTER rollback, once per top-level probe (nested
            # probes are fully suppressed under the outer journal) —
            # the ONE counter a probe moves, by design; everything else
            # must match a never-probed control bitwise
            self.telemetry.add("fabric.probes")
        return out


# ----------------------------------------------------------------------------
# schedule traffic: CollectiveSchedule -> flows
# ----------------------------------------------------------------------------

def _transfer_endpoints(torus: Torus, schedule: CollectiveSchedule,
                        phase: Phase, tr: Transfer):
    """(src_rank, dst_rank, route|None) triples for one transfer —
    every lane of the phase axis carries the ppermute's messages."""
    if phase.kind == P2P:
        yield phase.ring[0], phase.ring[-1], phase.ring
        return
    dim = schedule.axis_dims[schedule.axes.index(phase.axis)]
    dead = schedule.faults.dead_nodes
    for lane in _lanes(torus, dim):
        for a, b in tr.perm:
            ca = tuple(a if c is None else c for c in lane)
            cb = tuple(b if c is None else c for c in lane)
            ra, rb = torus.rank(ca), torus.rank(cb)
            if ra in dead or rb in dead:
                continue
            yield ra, rb, None


def inject_schedule(sim: FabricSim, schedule: CollectiveSchedule,
                    nbytes: float, *, start_s: float | None = None,
                    after: Sequence[int] = (),
                    granularity: str = "phase",
                    cls: TrafficClass = TrafficClass.COLLECTIVE,
                    **endpoint_kw) -> list[int]:
    """Inject a collective's traffic into a (shared) sim; returns the
    tail flow ids (the collective is done when all of them finish).

    ``granularity="round"`` barriers every wall-clock round on the
    previous one — the analytic model's sequential-rounds rule, used by
    the ``backend="sim"`` estimator.  ``granularity="phase"`` aggregates
    each phase's rounds into one flow per (lane, direction) — per-link
    bytes identical, round barriers elided — the cheap form the serving
    timeline uses for background traffic.  ``cls`` tags every flow of the
    collective (serving decode steps pass ``TrafficClass.DECODE``).
    """
    if granularity not in ("round", "phase"):
        raise ValueError(f"unknown granularity {granularity!r}")
    tail = list(after)
    for ph in schedule.phases:
        if not ph.steps:
            continue
        if granularity == "phase":
            fids = []
            rounds = len(ph.steps)
            for ti, tr in enumerate(ph.steps[0].transfers):
                for ra, rb, route in _transfer_endpoints(
                        sim.torus, schedule, ph, tr):
                    fids.append(sim.inject(
                        ra, rb, tr.frac * nbytes * rounds, start_s=start_s,
                        route=route, after=tuple(tail), channel=ti,
                        cls=cls, **endpoint_kw))
            if fids:
                tail = fids
        else:
            for st in ph.steps:
                fids = []
                for ti, tr in enumerate(st.transfers):
                    for ra, rb, route in _transfer_endpoints(
                            sim.torus, schedule, ph, tr):
                        fids.append(sim.inject(
                            ra, rb, tr.frac * nbytes, start_s=start_s,
                            route=route, after=tuple(tail), channel=ti,
                            cls=cls, **endpoint_kw))
                if fids:
                    tail = fids
    return tail


def simulate_schedule(schedule: CollectiveSchedule, nbytes: int,
                      net: NetModel | None = None, *,
                      cls: TrafficClass = TrafficClass.COLLECTIVE,
                      qos: QosPolicy | None = None,
                      fidelity: str = "packet",
                      **endpoint_kw) -> CostEstimate:
    """Event-driven price of one collective on a quiet fabric — the
    ``backend="sim"`` path of ``fabric.estimate``.

    Rounds barrier on each other exactly like the analytic model's
    sequential steps, so on single-flow schedules (no two messages of a
    round sharing a link direction) the two backends must agree — the
    differential in ``tests/fabric_checks.py`` holds both to it.  The
    default (no ``qos``) prices on the single-class FIFO link.
    ``fidelity`` selects the simulator tier (``fluid.make_sim``): the
    default ``"packet"`` oracle, or the ``"fluid"``/``"hybrid"`` fast
    path for large tori.
    """
    if fidelity == "packet":
        sim: FabricSim = FabricSim(Torus(schedule.torus_dims), net,
                                   faults=schedule.faults, qos=qos)
    else:
        from repro_torch.core.fabric.fluid import make_sim
        sim = make_sim(Torus(schedule.torus_dims), net, fidelity=fidelity,
                       faults=schedule.faults, qos=qos)
    phase_s = []
    t = 0.0
    tail: list[int] = []
    for ph in schedule.phases:
        sub = dataclasses.replace(schedule, phases=(ph,))
        new_tail = inject_schedule(sim, sub, nbytes, start_s=t,
                                   after=tuple(tail), granularity="round",
                                   cls=cls, **endpoint_kw)
        if new_tail != list(tail):
            tail = new_tail
            sim.run()
            end = max(sim.finish_s(f) for f in tail)
        else:
            end = t
        phase_s.append(max(end - t, 0.0))
        t = end
    return CostEstimate(total_s=t, phase_s=tuple(phase_s),
                        rounds=schedule.rounds,
                        bytes_per_rank=schedule.bytes_per_rank(nbytes),
                        max_hops=schedule.max_hops)


# ----------------------------------------------------------------------------
# congestion-aware route selection (fault.py's BFS machinery, probed by
# simulated completion time)
# ----------------------------------------------------------------------------

def candidate_routes(torus: Torus, src: int, dst: int,
                     faults: FaultMap | None = None) -> list[tuple[int, ...]]:
    """Loop-free candidate routes src -> dst over the surviving fabric:
    the dimension-ordered minimal path plus, per live first hop, the BFS
    shortest path that commits to that first link (the detour family the
    router could select).  Sorted by hop count; raises ``UnroutableError``
    when no route survives.

    Cached per (torus dims, src, dst, fault map): within one fault epoch,
    repeated probes and re-striping pay the BFS detour family exactly
    once (``clear_route_cache`` drops dead epochs)."""
    faults = faults or FaultMap()
    key = (torus.dims, src, dst, faults)
    hit = _candidates_cache.get(key, _MISS)
    if hit is _MISS:
        ROUTE_CACHE_STATS["cand_misses"] += 1
        if len(_candidates_cache) >= _ROUTE_CACHE_CAP:
            _candidates_cache.clear()
        hit = _candidates_cache[key] = _candidate_routes_uncached(
            torus, src, dst, faults)
    else:
        ROUTE_CACHE_STATS["cand_hits"] += 1
    return list(hit)


def _candidate_routes_uncached(torus: Torus, src: int, dst: int,
                               faults: FaultMap) -> list[tuple[int, ...]]:
    for r in (src, dst):
        if r in faults.dead_nodes:
            raise UnroutableError(f"route endpoint rank {r} is dead")
    if src == dst:
        return [(src,)]
    routes: list[tuple[int, ...]] = []
    if not faults:
        routes.append(tuple(torus.route(src, dst)))
    src_blocked = FaultMap(faults.dead_nodes | {src}, faults.dead_links)
    for n in torus.neighbors(src):
        if not faults.link_ok(src, n):
            continue
        if n == dst:
            path: list[int] | None = [n]
        else:
            path = _cached_bfs(torus, n, dst, src_blocked)
        if path is None:
            continue
        routes.append((src, *path))
    seen: set[tuple[int, ...]] = set()
    out = [r for r in routes if not (r in seen or seen.add(r))]
    if not out:
        raise UnroutableError(
            f"no surviving route {src} -> {dst}: the fault map "
            "partitions the fabric")
    return sorted(out, key=len)


def best_route(sim: FabricSim, src: int, dst: int, nbytes: float, *,
               faults: FaultMap | None = None,
               start_s: float | None = None,
               cls: TrafficClass = TrafficClass.BULK
               ) -> tuple[tuple[int, ...], float]:
    """The candidate route with the least *simulated* completion time
    against the sim's current traffic (ties break toward fewer hops —
    candidates come sorted, and ``min`` is stable)."""
    cands = candidate_routes(sim.torus, src, dst, faults)
    timed = [(sim.probe_route(r, nbytes, start_s=start_s, cls=cls), len(r), r)
             for r in cands]
    t, _, route = min(timed, key=lambda x: (x[0], x[1]))
    return route, t


def striped_routes(sim: FabricSim, src: int, dst: int, nbytes: float, *,
                   k: int = 3, faults: FaultMap | None = None,
                   start_s: float | None = None,
                   cls: TrafficClass = TrafficClass.BULK
                   ) -> list[tuple[tuple[int, ...], float]]:
    """Multi-path stripe plan for one bulk transfer: the ``k`` candidate
    routes with the least probed completion time, each with the fraction
    of the payload it should carry — proportional to its probed goodput
    (``nbytes / probed_s``), so a congested member of the stripe set gets
    proportionally less and the stripes finish together.

    Returns ``[(route, frac), ...]`` with fracs summing to 1; degenerates
    to ``[(best_route, 1.0)]`` when only one candidate survives.  This is
    the ROADMAP "adaptive multi-path routing" item: one transfer split
    across several loop-free detour-family routes at once."""
    if k < 1:
        raise ValueError(f"stripe count k must be >= 1, got {k}")
    cands = candidate_routes(sim.torus, src, dst, faults)
    timed = sorted(
        ((sim.probe_route(r, nbytes, start_s=start_s, cls=cls), len(r), r)
         for r in cands), key=lambda x: (x[0], x[1]))
    picked = timed[:k]
    goodput = [1.0 / max(t, 1e-12) for t, _, _ in picked]
    total = sum(goodput)
    return [(r, g / total) for (_, _, r), g in zip(picked, goodput)]


def stripe_counts(plan: Sequence[tuple[tuple[int, ...], float]],
                  n_items: int) -> list[int]:
    """Apportion ``n_items`` indivisible units (pages) across a
    ``striped_routes`` plan: largest-remainder rounding of the per-route
    fractions, so the counts always sum to ``n_items`` exactly.  Entries
    may be 0 when ``n_items < len(plan)`` — callers drop those stripes.
    The ONE page-split rule shared by the serving cluster, the QoS
    benchmark and the tests, so the gated numbers price exactly the
    production split."""
    if n_items < 0:
        raise ValueError(f"negative n_items {n_items}")
    exact = [frac * n_items for _, frac in plan]
    counts = [int(e) for e in exact]
    short = n_items - sum(counts)
    order = sorted(range(len(plan)), key=lambda i: exact[i] - counts[i],
                   reverse=True)
    for i in order[:short]:
        counts[i] += 1
    return counts
