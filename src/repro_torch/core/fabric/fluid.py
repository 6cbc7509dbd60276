"""Flow-level (fluid) fabric simulator — the fast fidelity tier for
large tori, with optional packet-mode escalation of contended links.

``FabricSim`` (``fabric/sim.py``) walks every packet of every flow
through every router: exact, and the bitwise oracle — but pure-Python
event dispatch caps it at a few dozen nodes.  The paper's own pitch is
petaflops-class machines (arXiv:1102.3796 frames APEnet+ entirely in
aggregate-bandwidth-vs-concurrent-flows terms), and the ROADMAP's
autotuner and trace-replay items both need an 8x8x8 torus with thousands
of live flows to settle in milliseconds.  This module adds that tier:

  * ``FluidSim`` models each flow as a *rate* over its route instead of a
    packet walk.  Whenever the set of transmitting flows changes, a
    vectorized **hierarchical weighted max-min** solver (progressive
    filling / waterfilling over the links x flows incidence) re-allocates
    every link-direction's bandwidth: first across backlogged traffic
    classes in proportion to the ``QosPolicy`` arbiter weights (the
    virtual-channel arbiter), then within a class in proportion to each
    flow's packet size (the FIFO round-robins concurrent flows packet by
    packet, so within-class goodput is packet-size-proportional).  Time
    then fast-forwards to the next rate-change event (flow start / drain)
    — the event count is O(flows), not O(packets x hops).  The solver
    runs on flat numpy index arrays by default; ``solver="torch"``
    switches to a dense-incidence waterfill in PyTorch (a links x flows
    0/1 matrix, padded to stable shapes, fp32) on an explicit device —
    the card by default — with a fixed number of rounds and no host
    synchronisation inside them.
  * per-flow endpoint costs are carried over from the packet model
    *exactly*: activation + ``t_inject``/GPU touch, a drain window whose
    byte integral is the payload, then the store-and-forward tail
    ``(h-1) * tail_bytes / B + h * t_hop`` and ``t_receive``.  On an
    uncontended route the fluid finish time equals the packet sim's to
    float precision — the differential tests pin that down.
  * ``HybridSim`` watches the solver for saturated links (utilization
    above ``escalate_util`` with >= 2 competing flows), re-runs exactly
    the flows crossing those links through a packet-mode ``FabricSim``
    sub-simulation, and stitches the timelines back (packet-accurate
    finishes on contended links, fluid everywhere else; downstream
    dependents shift by their dependencies' slip).
  * the public surface duck-types ``FabricSim`` — ``inject`` / ``occupy``
    / ``run`` / ``finish_s`` / ``flow`` / ``probe_route`` / ``link_stats``
    / ``class_stats`` / ``advance`` / ``prune`` — so ``RdmaEndpoint``,
    the serving cluster/engine and the route prober run unmodified on
    either tier; ``make_sim(..., fidelity=)`` is the one constructor
    every consumer threads through.

What the fluid tier does NOT model (the documented fidelity contract):
packet-granular interleaving transients, credit-window backpressure
transients, and contention among sub-packet-size flows (a flow smaller
than one packet holds a link for one packet time; the fluid tier prices
its latency exactly but does not charge other flows for it).  The
differential harness (tests/test_fluid_sim.py) holds fluid completion
times to within 10% of packet mode on multi-packet workloads — the same
bar the sim/analytic differential uses.
"""
from __future__ import annotations

import heapq
from typing import Hashable, Sequence

import numpy as np

from repro_torch.core import apelink
from repro_torch.core.apelink import NetModel
from repro_torch.core.fabric.lower import UnroutableError
from repro_torch.core.fabric.qos import SINGLE_CLASS, QosPolicy, TrafficClass
from repro_torch.core.fabric.schedule import FaultMap
from repro_torch.core.fabric.sim import (
    DEFAULT_MAX_PACKETS, DEFAULT_PACKET_BYTES, FabricSim, FlowResult,
    _cached_bfs, link_key, packetize)
from repro_torch.core.fabric.telemetry import ordered_link_items
from repro_torch.core.topology import Torus

FIDELITIES = ("packet", "fluid", "hybrid")

# a drain below half a byte is float dust from settling, not payload
_BYTE_EPS = 0.5
# progressive-filling rounds: each round freezes at least one link or
# flow, so depth bounds the distinct bottleneck levels resolved exactly
_MAX_ROUNDS = 64


def make_sim(torus: Torus, net: NetModel | None = None, *,
             fidelity: str = "packet", **kw):
    """The one constructor for every fabric-simulator fidelity tier.

    ``"packet"`` -> ``FabricSim`` (bitwise oracle), ``"fluid"`` ->
    ``FluidSim`` (flow-level fast path), ``"hybrid"`` -> ``HybridSim``
    (fluid with packet-mode escalation of contended links).  Extra
    keyword arguments go to the tier's constructor."""
    if fidelity == "packet":
        return FabricSim(torus, net, **kw)
    if fidelity == "fluid":
        return FluidSim(torus, net, **kw)
    if fidelity == "hybrid":
        return HybridSim(torus, net, **kw)
    raise ValueError(
        f"unknown fidelity {fidelity!r}: expected one of {FIDELITIES}")


class _FFlow:
    """One fluid-tier flow: a drain window over its route plus exact
    endpoint terms (packet-model parity, see module docstring)."""

    __slots__ = ("fid", "route", "links", "link_keys", "nbytes", "remaining",
                 "rate", "weight", "tail_s", "tail_bytes", "cls", "cidx",
                 "req_start", "start_s", "drain_s", "finish_s", "pending",
                 "deps", "dependents", "src_over", "dst_over", "rate_cap",
                 "resource", "service_s", "label", "channel", "src_gpu",
                 "dst_gpu", "version")

    def __init__(self, fid: int) -> None:
        self.fid = fid
        self.route: tuple[int, ...] = ()
        self.links: np.ndarray | None = None   # interned link ids, int64
        self.link_keys: tuple = ()
        self.nbytes = 0.0
        self.remaining = 0.0      # drain bytes left (payload minus tail)
        self.rate = 0.0           # current allocated rate, bytes/s
        self.weight = 1.0         # within-class arbiter weight (pkt bytes)
        self.tail_s = 0.0         # store-and-forward tail + hop latency
        self.tail_bytes = 0.0     # last-packet bytes riding the tail
        self.cls: TrafficClass | None = None
        self.cidx = 0
        self.req_start = 0.0
        self.start_s: float | None = None     # activation (deps satisfied)
        self.drain_s: float | None = None     # payload fully injected
        self.finish_s: float | None = None
        self.pending = 0
        self.deps: tuple[int, ...] = ()
        self.dependents: list[int] = []
        self.src_over = 0.0
        self.dst_over = 0.0
        self.rate_cap = float("inf")          # GPU-outbound source pacing
        self.resource: Hashable | None = None
        self.service_s: float | None = None
        self.label = ""
        self.channel = 0
        self.src_gpu = False
        self.dst_gpu = False
        self.version = 0          # drain-event staleness stamp


class FluidSim:
    """Flow-level fabric simulator over one ``Torus`` — same public
    surface as ``FabricSim``, O(flows) events instead of O(packets).

    ``solver`` picks the rate solver: ``"np"`` (flat-index numpy
    progressive filling, the default) or ``"torch"`` (dense fp32
    waterfill over the links x flows incidence on ``device``: ``None``
    means the card, which must then exist; pass ``"cpu"`` for the host).
    ``exact_below`` and ``resolve_frac`` trade solver invocations for
    staleness: with more than ``exact_below`` active flows, a re-solve
    after drains is only triggered once ``resolve_frac`` of the active
    set has drained (rates
    between solves are *stale but conservative* — a drained flow only
    frees bandwidth, so surviving flows never finish later than the lazy
    schedule predicts).  ``coalesce_s`` widens the same-instant event
    batch window so staggered activations share one solve."""

    def __init__(self, torus: Torus, net: NetModel | None = None, *,
                 packet_bytes: int = DEFAULT_PACKET_BYTES,
                 credit_bytes: float | None = None,
                 max_packets_per_flow: int = DEFAULT_MAX_PACKETS,
                 faults: FaultMap | None = None,
                 qos: QosPolicy | None = None,
                 solver: str = "np",
                 device: str | None = None,
                 exact_below: int = 64,
                 resolve_frac: float = 0.05,
                 coalesce_s: float = 0.0,
                 telemetry: "object | None" = None) -> None:
        if packet_bytes <= 0:
            raise ValueError(f"packet_bytes must be > 0, got {packet_bytes}")
        if solver not in ("np", "torch"):
            raise ValueError(f"unknown solver {solver!r}")
        self.device = _solver_device(device) if solver == "torch" else None
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
        self.solver = solver
        self.exact_below = max(1, exact_below)
        self.resolve_frac = resolve_frac
        self.coalesce_s = coalesce_s
        self._weights = self.qos.weight_vector()
        self._class_credits = self.qos.partition_credits(self.credit_bytes)
        self._flows: dict[int, _FFlow] = {}
        self._active: dict[int, _FFlow] = {}   # transmitting (insertion =
        self._heap: list = []                  # deterministic solve order)
        self._seq_n = 0
        self._fid_n = 0
        self._frontier = 0.0
        self._solve_t = 0.0       # time the active set's rates are valid from
        self._version = 0
        self._dirty = False
        self._drained_since = 0   # drains since the last re-solve
        self._lid: dict = {}      # link key -> dense id (solver index)
        self._lid_keys: list = []
        self._stats: dict = {}    # link key -> [busy_s, bytes, class_bytes[]]
        self._res_free: dict = {} # resource key -> FIFO free-at time
        self._probing = False
        # optional Telemetry hub — every hook gated on
        # ``telemetry is not None and not self._probing`` (None is
        # bitwise-invisible; probe ghosts never reach the hub)
        self.telemetry = telemetry
        self.n_solves = 0         # solver invocations (reporting)
        self.n_warm_solves = 0    # solves that reused cached incidence
        # warm-start cache: the flat incidence arrays ``_rates_np`` builds
        # are a pure function of (active flow set, interned link count) —
        # a re-solve where only the QoS weights changed (the controller's
        # per-window retune) reuses them verbatim, so the waterfill rounds
        # re-run against identical inputs and the allocation is bitwise
        # equal to a cold solve at a fraction of the Python cost
        self._inc_cache: tuple | None = None
        # hybrid escalation hooks (populated by the solver when tracking)
        self.escalate_util: float | None = None
        self._hot: set[int] = set()
        self.last_probe_report: dict | None = None

    # -- clock ----------------------------------------------------------------
    @property
    def now(self) -> float:
        """The timeline frontier (latest processed/advanced time)."""
        return self._frontier

    def advance(self, t: float) -> None:
        """Move the frontier forward (never backward)."""
        self._frontier = max(self._frontier, t)

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

    def _lid_of(self, key) -> int:
        lid = self._lid.get(key)
        if lid is None:
            lid = self._lid[key] = len(self._lid_keys)
            self._lid_keys.append(key)
        return lid

    def _stat(self, key) -> list:
        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = [0.0, 0.0, [0.0] * len(TrafficClass)]
        return st

    def _new_flow(self, start_s: float | None,
                  after: Sequence[int]) -> _FFlow:
        f = _FFlow(self._fid_n)
        self._fid_n += 1
        f.req_start = self._frontier if start_s is None else float(start_s)
        self._flows[f.fid] = f
        f.deps = tuple(after)
        for dep_fid in after:
            dep = self._flows[dep_fid]
            if dep.finish_s is None:
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
        """Inject one flow of ``nbytes`` from rank ``src`` to ``dst`` —
        the ``FabricSim.inject`` contract, priced at flow level."""
        f = self._new_flow(start_s, after)
        f.route = self._resolve_route(src, dst, route)
        f.channel = channel
        f.cls = TrafficClass(cls)
        f.cidx = self.qos.class_index(f.cls)
        f.nbytes = float(nbytes)
        f.src_gpu = src_gpu
        f.dst_gpu = dst_gpu
        cap = self._class_credits[f.cidx]
        if not self.qos.single_class:
            # same >= 2-packets-per-credit-window rule as the packet tier
            cap = max(cap * 0.5, 1.0)
        pkt, npkts = packetize(f.nbytes, cap, self.packet_bytes,
                               self.max_packets)
        tail = max(f.nbytes - (npkts - 1) * pkt, 0.0)
        h = len(f.route) - 1
        # drain window carries payload-minus-tail at the allocated rate;
        # the last packet crosses every hop at wire speed (store-and-
        # forward boundary) — on a quiet route this reproduces the packet
        # sim's finish exactly: t0 + src_over + nbytes/B
        #                       + (h-1)*tail/B + h*t_hop + dst_over
        f.remaining = max(f.nbytes - tail, 0.0)
        f.tail_bytes = tail
        f.tail_s = h * tail / self.link_bw + h * self.net.t_hop
        f.weight = pkt if pkt > 0 else 1.0
        f.src_over = self.net.t_inject \
            + (self.net.gpu_touch_overhead if src_gpu else 0.0)
        f.dst_over = self.net.t_receive \
            + (self.net.gpu_touch_overhead if dst_gpu else 0.0)
        if src_gpu and self.net.gpu_read_cap < self.link_bw:
            # GPU-outbound read bottleneck as a per-flow rate cap
            f.rate_cap = float(self.net.gpu_read_cap)
        if h > 0:
            keys = tuple(
                link_key(self.torus, f.route[i], f.route[i + 1], channel)
                for i in range(h))
            f.link_keys = keys
            f.links = np.fromiter((self._lid_of(k) for k in keys),
                                  dtype=np.int64, count=h)
        f.label = label
        return f.fid

    def occupy(self, resource: Hashable, busy_s: float, *,
               start_s: float | None = None,
               after: Sequence[int] = (), label: str = "",
               cls: TrafficClass = TrafficClass.BULK) -> int:
        """Occupy a rank-local FIFO resource for ``busy_s`` seconds (the
        host-interface DMA drain) — FIFO-serialized at flow level."""
        if busy_s < 0:
            raise ValueError(f"negative busy_s {busy_s}")
        f = self._new_flow(start_s, after)
        f.resource = resource
        f.service_s = float(busy_s)
        f.label = label
        f.cls = TrafficClass(cls)
        f.cidx = self.qos.class_index(f.cls)
        return f.fid

    # -- event machinery ------------------------------------------------------
    def _push(self, t: float, kind: str, arg) -> None:
        heapq.heappush(self._heap, (t, self._seq_n, kind, arg))
        self._seq_n += 1

    def _activate(self, f: _FFlow, t: float) -> None:
        f.start_s = t
        if f.resource is not None:
            free = self._res_free.get(f.resource, 0.0)
            beg = max(t, free)
            end = beg + (f.service_s or 0.0)
            self._res_free[f.resource] = end
            self._stat(f.resource)[0] += f.service_s or 0.0
            if self.telemetry is not None and not self._probing:
                self.telemetry.on_resource_busy(
                    f.resource, f.service_s or 0.0, int(f.cls))
            if end > t:
                self._push(end, "complete", f.fid)
            else:
                self._finish(f, t)
            return
        if len(f.route) < 2:          # self-send: no wire
            self._finish(f, t)
            return
        if f.src_over > 0:
            self._push(t + f.src_over, "go", f.fid)
        else:
            self._go(f, t)

    def _go(self, f: _FFlow, t: float) -> None:
        """The flow's payload starts transmitting: join the rate solve."""
        if f.remaining <= _BYTE_EPS:
            self._drain(f, t)         # sub-packet flow: tail terms only
            return
        self._active[f.fid] = f
        self._dirty = True

    def _drain(self, f: _FFlow, t: float) -> None:
        """The payload has fully entered the wire; account the route's
        byte/busy stats and schedule the store-and-forward tail."""
        f.drain_s = t
        f.remaining = 0.0
        self._active.pop(f.fid, None)
        busy = f.nbytes / self.link_bw
        for key in f.link_keys:
            st = self._stat(key)
            st[0] += busy
            st[1] += f.nbytes
            st[2][int(f.cls)] += f.nbytes
        if self.telemetry is not None and not self._probing:
            # mirrors the per-key loop above in the same order, so the
            # hub's counters cross-check exactly against _stats
            self.telemetry.on_flow_drain(f.link_keys, int(f.cls),
                                         f.nbytes, busy)
        fin = t + f.tail_s + f.dst_over
        if fin > t:
            self._push(fin, "complete", f.fid)
        else:
            self._finish(f, t)
        self._drained_since += 1
        n_act = len(self._active)
        if n_act and (n_act <= self.exact_below
                      or self._drained_since >= max(
                          1.0, self.resolve_frac * n_act)):
            self._dirty = True

    def _finish(self, f: _FFlow, t: float) -> None:
        f.finish_s = t
        self._frontier = max(self._frontier, t)
        tel = self.telemetry
        if tel is not None and not self._probing:
            start = f.start_s if f.start_s is not None else f.req_start
            if f.resource is not None:
                track = ("node", f.resource)
            elif f.link_keys:
                track = ("link", f.link_keys[0])
            else:
                track = ("node", f.route[0] if f.route else -1)
            tel.flow_span(track, f.label or f"flow{f.fid}", start, t,
                          cls=int(f.cls), nbytes=f.nbytes, fid=f.fid)
        for dep_fid in f.dependents:
            dep = self._flows[dep_fid]
            dep.pending -= 1
            dep.req_start = max(dep.req_start, t)
            if dep.pending == 0:
                self._push(dep.req_start, "start", dep.fid)
        f.dependents = []

    def _settle(self, t: float) -> None:
        """Advance every active flow's drain integral to ``t`` under the
        current rates (progress is only materialized at solve points)."""
        dt = t - self._solve_t
        if dt > 0:
            for f in self._active.values():
                f.remaining = max(f.remaining - f.rate * dt, 0.0)
        self._solve_t = max(self._solve_t, t)

    def _solve(self, t: float) -> None:
        """Re-allocate link bandwidth across the active flows and refresh
        their predicted drain events (version-stamped: predictions from
        older solves are ignored when popped)."""
        self._settle(t)
        self._dirty = False
        self._drained_since = 0
        act = list(self._active.values())
        if not act:
            return
        self.n_solves += 1
        self._version += 1
        ver = self._version
        if len(act) == 1:
            rates = [min(self.link_bw, act[0].rate_cap)]
        elif self.solver == "torch":
            rates = self._rates_torch(act)
        else:
            rates = self._rates_np(act)
        for f, r in zip(act, rates):
            f.rate = float(r)
            f.version = ver
            if f.remaining <= _BYTE_EPS:
                self._push(t, "drain", (f.fid, ver))
            else:
                self._push(t + f.remaining / f.rate, "drain", (f.fid, ver))

    def _rates_np(self, act: list[_FFlow]) -> np.ndarray:
        """Hierarchical weighted max-min progressive filling on flat
        index arrays: every round grants each unfrozen flow its min
        bottleneck share — residual * (class weight / active class
        weights) * (flow weight / class weight sum on that link) — then
        freezes flows touching saturated links (or at their source rate
        cap).  Each round saturates at least one link or cap, so rounds
        are bounded by the distinct bottleneck levels."""
        B = self.link_bw
        nc = self.qos.n_classes
        n_lids = len(self._lid_keys)
        n_flows = len(act)
        ckey = (n_lids, tuple(f.fid for f in act))
        cached = self._inc_cache
        if cached is not None and cached[0] == ckey:
            hop_flow, hop_link, cidx, wf, cap = cached[1]
            self.n_warm_solves += 1
        else:
            hop_flow = np.repeat(np.arange(n_flows, dtype=np.int64),
                                 [len(f.links) for f in act])
            hop_link = np.concatenate([f.links for f in act])
            cidx = np.fromiter((f.cidx for f in act), dtype=np.int64,
                               count=n_flows)
            wf = np.fromiter((f.weight for f in act), dtype=np.float64,
                             count=n_flows)
            cap = np.fromiter((f.rate_cap for f in act), dtype=np.float64,
                              count=n_flows)
            self._inc_cache = (ckey, (hop_flow, hop_link, cidx, wf, cap))
        wc = np.asarray(self._weights, dtype=np.float64)
        resid = np.full(n_lids, B)
        rate = np.zeros(n_flows)
        unfrozen = np.ones(n_flows, dtype=bool)
        for _ in range(_MAX_ROUNDS):
            live = unfrozen[hop_flow]
            hf = hop_flow[live]
            hl = hop_link[live]
            if hf.size == 0:
                break
            hc = cidx[hf]
            key = hl * nc + hc
            class_w = np.zeros(n_lids * nc)
            np.add.at(class_w, key, wf[hf])
            active_w = (class_w.reshape(n_lids, nc) > 0.0) @ wc
            share = resid[hl] * (wc[hc] / active_w[hl]) * (wf[hf]
                                                           / class_w[key])
            inc = np.full(n_flows, np.inf)
            np.minimum.at(inc, hf, share)
            np.minimum(inc, cap - rate, out=inc)
            inc[~unfrozen] = 0.0
            np.maximum(inc, 0.0, out=inc)
            rate += inc
            used = np.zeros(n_lids)
            np.add.at(used, hl, inc[hf])
            resid -= used
            sat = resid <= B * 1e-9
            np.maximum(resid, 0.0, out=resid)
            flow_sat = np.zeros(n_flows, dtype=bool)
            flow_sat[hf[sat[hl]]] = True
            capped = rate >= cap * (1.0 - 1e-12)
            newly = unfrozen & (flow_sat | capped)
            if not newly.any() and inc.max(initial=0.0) <= B * 1e-12:
                break
            unfrozen &= ~newly
            if not unfrozen.any():
                break
        if self.escalate_util is not None and not self._probing:
            # hybrid hook: saturated links shared by >= 2 flows
            count = np.zeros(n_lids)
            np.add.at(count, hop_link, 1.0)
            hot = np.flatnonzero(
                (resid <= B * (1.0 - self.escalate_util)) & (count >= 2.0))
            self._hot.update(int(x) for x in hot)
        return rate

    def _rates_torch(self, act: list[_FFlow]) -> np.ndarray:
        """Dense-incidence waterfill in PyTorch: the same progressive
        filling as ``_rates_np`` over a padded links x flows 0/1
        incidence matrix (stable shapes), fp32 on ``self.device``."""
        B = self.link_bw
        nc = self.qos.n_classes
        n_lids = len(self._lid_keys)
        n_flows = len(act)
        pad = _pad_to(n_flows), _pad_to(n_lids)
        inc_mat = np.zeros((pad[1], pad[0]), dtype=np.float32)
        for i, f in enumerate(act):
            inc_mat[f.links, i] = 1.0
        onehot = np.zeros((pad[0], nc), dtype=np.float32)
        wf = np.zeros(pad[0], dtype=np.float32)
        cap = np.full(pad[0], np.inf, dtype=np.float32)
        alive = np.zeros(pad[0], dtype=np.float32)
        for i, f in enumerate(act):
            onehot[i, f.cidx] = 1.0
            wf[i] = f.weight
            cap[i] = min(f.rate_cap, 3.4e38)
            alive[i] = 1.0
        wc = np.asarray(self._weights, dtype=np.float32)
        rate, resid = _torch_waterfill(inc_mat, wf, onehot, cap, alive,
                                       wc, float(B), _MAX_ROUNDS,
                                       self.device)
        rate = np.asarray(rate, dtype=np.float64)[:n_flows]
        if self.escalate_util is not None and not self._probing:
            resid = np.asarray(resid, dtype=np.float64)[:n_lids]
            count = inc_mat.sum(axis=1)[:n_lids]
            hot = np.flatnonzero(
                (resid <= B * (1.0 - self.escalate_util)) & (count >= 2.0))
            self._hot.update(int(x) for x in hot)
        return rate

    def run(self) -> float:
        """Process every pending event; returns the frontier time."""
        heap = self._heap
        while heap:
            self._step(heapq.heappop(heap))
        return self._frontier

    def run_until(self, until: float) -> float:
        """Process every event up to and including ``until``, settle the
        active drain integrals to that instant, and stop with later
        events pending — the mid-flight re-striping checkpoint.  A later
        ``run()`` resumes in the same heap order; on the hybrid tier a
        partial drain never escalates (escalation is a full-``run``
        stitch)."""
        heap = self._heap
        while heap and heap[0][0] <= until:
            self._step(heapq.heappop(heap))
        if self._dirty and self._active:
            self._solve(max(self._frontier, self._solve_t))
        self._settle(max(self._frontier, until, self._solve_t))
        self._frontier = max(self._frontier, until)
        return self._frontier

    def _step(self, ev: tuple) -> None:
        t, _, kind, arg = ev
        if t < self._solve_t:
            t = self._solve_t     # clock guard (coalesced batches)
        self._frontier = max(self._frontier, t)
        if kind == "start":
            self._activate(self._flows[arg], t)
        elif kind == "go":
            f = self._flows[arg]
            if f.finish_s is None and f.drain_s is None:
                self._go(f, t)
        elif kind == "drain":
            fid, ver = arg
            f = self._flows.get(fid)
            if f is not None and f.version == ver \
                    and f.drain_s is None:
                self._drain(f, t)
        elif kind == "complete":
            f = self._flows.get(arg)
            if f is not None and f.finish_s is None:
                self._finish(f, t)
        if self._dirty and (not self._heap
                            or self._heap[0][0] > t + self.coalesce_s):
            self._solve(t)

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
        """Per-directed-link busy seconds / carried bytes / class bytes —
        the ``FabricSim.link_stats`` shape, accounted at flow drains."""
        return {k: {"busy_s": v[0], "bytes": v[1],
                    "class_bytes": tuple(v[2])}
                for k, v in ordered_link_items(self._stats.items())}

    def class_stats(self, since: dict | None = None
                    ) -> dict[TrafficClass, float]:
        """Bytes carried per traffic-class tag over every directed link
        (each wire hop counts) — identical accounting to the packet tier,
        so per-class byte conservation is exact across fidelities.
        ``since`` takes a previous ``class_stats()`` mapping and returns
        the per-window DELTA (see ``FabricSim.class_stats``); the read
        never mutates the sim."""
        totals = [0.0] * len(TrafficClass)
        for st in self._stats.values():
            for c in range(len(TrafficClass)):
                totals[c] += st[2][c]
        out = {cls: totals[int(cls)] for cls in TrafficClass}
        if since is not None:
            for cls in out:
                out[cls] -= float(since.get(cls, 0.0))
        return out

    # -- live QoS retune -------------------------------------------------------
    def set_qos(self, policy: QosPolicy) -> None:
        """Swap the arbitration policy on a LIVE timeline — the fluid
        expression of ``FabricSim.set_qos``.  The waterfill honors the
        retuned weights from this instant on: active drain integrals are
        settled under the old rates up to now, then one immediate re-solve
        re-allocates every link under the new weights (warm-started — the
        active set did not change, so the cached incidence arrays are
        reused and only the class-weight vector differs)."""
        if self._probing:
            raise RuntimeError("set_qos during an active probe")
        if policy.n_classes != self.qos.n_classes:
            raise ValueError(
                "cannot change the virtual-channel count of a live sim "
                f"({self.qos.n_classes} -> {policy.n_classes})")
        self.qos = policy
        self._weights = policy.weight_vector()
        self._class_credits = policy.partition_credits(self.credit_bytes)
        if self._active:
            self._solve(max(self._frontier, self._solve_t))
        if self.telemetry is not None:
            self.telemetry.add("fabric.qos_retunes")

    # -- mid-flight re-striping ------------------------------------------------
    def unsent_bytes(self, fid: int) -> float:
        """Drain bytes of ``fid`` not yet injected into the wire at the
        last settle point (``run_until`` settles to its checkpoint) — the
        remainder a mid-flight re-stripe may re-split.  The fluid tier
        tracks a continuous drain integral, so "unsent" is the remaining
        integral rather than a packet count; the store-and-forward tail
        stays with the original flow."""
        f = self._flows[fid]
        if f.finish_s is not None or f.drain_s is not None \
                or f.resource is not None:
            return 0.0
        if f.start_s is None:
            return f.nbytes
        return max(f.remaining, 0.0)

    def restripe(self, fid: int, plan: Sequence[tuple]) -> list[int]:
        """Re-split flow ``fid``'s unsent remainder across a fresh
        ``striped_routes`` plan — ``FabricSim.restripe`` at flow level.
        The flow is re-pointed at ``plan[0]`` carrying that route's share
        (its byte/busy stats account on the final route — the fluid
        fidelity contract trades per-hop exactness for O(flows) cost);
        sibling flows carry the other shares from now.  Triggers an
        immediate re-solve so no drain integral ever advances under a
        stale route."""
        if self._probing:
            raise RuntimeError("restripe during an active probe")
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
        if rem <= _BYTE_EPS or not routes:
            return [fid]
        total = sum(fracs)
        shares = [rem * fr / total for fr in fracs]
        taken = rem - shares[0]
        f.nbytes = max(f.nbytes - taken, 0.0)
        f.remaining = shares[0]
        f.route = routes[0]
        h = len(f.route) - 1
        f.tail_s = h * f.tail_bytes / self.link_bw + h * self.net.t_hop
        keys = tuple(
            link_key(self.torus, f.route[i], f.route[i + 1], f.channel)
            for i in range(h))
        f.link_keys = keys
        f.links = np.fromiter((self._lid_of(k) for k in keys),
                              dtype=np.int64, count=h)
        self._inc_cache = None     # the flow's incidence row changed
        out = [fid]
        for route, share in zip(routes[1:], shares[1:]):
            out.append(self.inject(
                route[0], route[-1], share, start_s=self._frontier,
                route=route, src_gpu=f.src_gpu, dst_gpu=f.dst_gpu,
                channel=f.channel, cls=f.cls,
                label=(f.label + "+restripe") if f.label else "restripe"))
        if f.fid in self._active:
            self._dirty = True
            self._solve(max(self._frontier, self._solve_t))
        if self.telemetry is not None:
            self.telemetry.add("fabric.restripes")
            self.telemetry.add("fabric.restripe_siblings",
                               float(len(out) - 1))
        return out

    def prune(self) -> int:
        """Drop finished flows from the registry; returns how many."""
        done = [fid for fid, f in self._flows.items()
                if f.finish_s is not None]
        for fid in done:
            del self._flows[fid]
        return len(done)

    # -- what-if probing -------------------------------------------------------
    def _snapshot(self) -> tuple:
        flows = {fid: (f.remaining, f.rate, f.version, f.req_start,
                       f.start_s, f.drain_s, f.finish_s, f.pending,
                       list(f.dependents))
                 for fid, f in self._flows.items()}
        stats = {k: (v[0], v[1], list(v[2]))
                 for k, v in self._stats.items()}
        return (flows, list(self._active.keys()), list(self._heap),
                dict(self._res_free), stats, len(self._lid_keys),
                self._frontier, self._solve_t, self._version, self._dirty,
                self._drained_since, self._seq_n, self._fid_n,
                set(self._hot))

    def _restore(self, snap: tuple) -> None:
        (flows, active, heap, res_free, stats, n_lids, frontier, solve_t,
         version, dirty, drained, seq_n, fid_n, hot) = snap
        for fid in [fid for fid in self._flows if fid not in flows]:
            del self._flows[fid]
        for fid, (remaining, rate, ver, req_start, start_s, drain_s,
                  finish_s, pending, dependents) in flows.items():
            f = self._flows[fid]
            f.remaining = remaining
            f.rate = rate
            f.version = ver
            f.req_start = req_start
            f.start_s = start_s
            f.drain_s = drain_s
            f.finish_s = finish_s
            f.pending = pending
            f.dependents = dependents
        self._active = {fid: self._flows[fid] for fid in active}
        self._heap = heap
        self._res_free = res_free
        for k in [k for k in self._stats if k not in stats]:
            del self._stats[k]
        for k, (busy, carried, class_bytes) in stats.items():
            st = self._stats[k]
            st[0] = busy
            st[1] = carried
            st[2] = class_bytes
        for key in self._lid_keys[n_lids:]:
            del self._lid[key]
        del self._lid_keys[n_lids:]
        self._frontier = frontier
        self._solve_t = solve_t
        self._version = version
        self._dirty = dirty
        self._drained_since = drained
        self._seq_n = seq_n
        self._fid_n = fid_n
        self._hot = hot
        # flow ids may be reused after the rollback with different routes;
        # a stale incidence cache keyed on those ids would be wrong
        self._inc_cache = None

    def probe_route(self, route: Sequence[int], nbytes: float, *,
                    start_s: float | None = None, **kw) -> float:
        """Simulated completion time of a hypothetical flow along
        ``route`` against the current traffic, with full rollback — the
        ``FabricSim.probe_route`` contract on the fluid tier, which is
        what makes congestion-aware routing affordable at 512 nodes."""
        snap = self._snapshot()
        was_probing = self._probing
        self._probing = True
        try:
            start = self._frontier if start_s is None else start_s
            fid = self.inject(route[0], route[-1], nbytes, start_s=start,
                              route=route, **kw)
            out = self.finish_s(fid) - start
        finally:
            self._probing = was_probing
            self._restore(snap)
        self.last_probe_report = {
            "flows_touched": len(snap[0]), "links_touched": len(route) - 1,
        }
        if self.telemetry is not None and not self._probing:
            # once per TOP-LEVEL probe, after restore — the one counter
            # a probe moves (nested probes stay fully suppressed)
            self.telemetry.add("fabric.probes")
        return out


class HybridSim(FluidSim):
    """Fluid tier with packet-mode escalation: links the rate solver
    finds saturated (utilization >= ``escalate_util`` with >= 2 competing
    flows) flag their flows, and after the fluid pass those flows re-run
    through a packet-mode ``FabricSim`` sub-simulation on the same torus
    / QoS policy / fault map — injected at their fluid activation times
    with their intra-set dependencies.  The packet finishes replace the
    fluid ones and downstream dependents shift by their dependencies'
    slip, so contended links get packet-accurate completion (credit
    backpressure, packet interleaving and all) while the quiet majority
    of the fabric stays on the O(flows) fast path.  Probes never
    escalate — route selection stays cheap."""

    def __init__(self, torus: Torus, net: NetModel | None = None, *,
                 escalate_util: float = 0.85, **kw) -> None:
        super().__init__(torus, net, **kw)
        if not 0.0 < escalate_util <= 1.0:
            raise ValueError(
                f"escalate_util must be in (0, 1], got {escalate_util}")
        self.escalate_util = escalate_util
        self.last_escalation: dict | None = None

    def run(self) -> float:
        open_fids = [fid for fid, f in self._flows.items()
                     if f.finish_s is None]
        self._hot.clear()
        super().run()
        if self._probing or not self._hot:
            return self._frontier
        batch = [self._flows[fid] for fid in open_fids
                 if self._flows[fid].finish_s is not None]
        hot = self._hot
        esc_ids = {f.fid for f in batch
                   if f.links is not None
                   and any(int(l) in hot for l in f.links)}
        if not esc_ids:
            return self._frontier
        # Close the set under link-sharing: packet queues serve FIFO by
        # arrival, so even an *uncontended* sharer of some non-hot link
        # shifts the interleaving seen downstream — the sub-sim is only
        # authoritative if no outside flow touches any queue it contains.
        # Under full saturation the closure approaches the whole batch
        # and hybrid degrades gracefully to packet accuracy (and cost).
        used = {int(l) for f in batch if f.fid in esc_ids
                for l in (f.links if f.links is not None else ())}
        rest = [f for f in batch
                if f.fid not in esc_ids and f.links is not None]
        changed = True
        while changed:
            changed = False
            still = []
            for f in rest:
                if any(int(l) in used for l in f.links):
                    esc_ids.add(f.fid)
                    used.update(int(l) for l in f.links)
                    changed = True
                else:
                    still.append(f)
            rest = still
        esc = [f for f in batch if f.fid in esc_ids]
        sub = FabricSim(self.torus, self.net,
                        packet_bytes=self.packet_bytes,
                        credit_bytes=self.credit_bytes,
                        max_packets_per_flow=self.max_packets,
                        faults=self.faults, qos=self.qos)
        idmap: dict[int, int] = {}
        for f in sorted(esc, key=lambda f: (f.start_s, f.fid)):
            idmap[f.fid] = sub.inject(
                f.route[0], f.route[-1], f.nbytes, start_s=f.start_s,
                route=f.route,
                after=[idmap[d] for d in f.deps if d in idmap],
                src_gpu=f.src_gpu, dst_gpu=f.dst_gpu, channel=f.channel,
                label=f.label,
                cls=TrafficClass.BULK if f.cls is None else f.cls)
        sub.run()
        # stitch: escalated flows take their packet finish (the sub-sim
        # holds the full link-sharing closure around the hot links, so no
        # absent flow can perturb any of its queues and it is authoritative
        # there — faster or slower than the fluid guess); everyone
        # downstream shifts by the worst slip among its dependencies.
        # Slip is one-directional: a packet finish earlier than fluid
        # never pulls dependents earlier (their other contention was
        # priced by fluid and stays).
        fluid_fin = {f.fid: f.finish_s for f in batch}
        slip: dict[int, float] = {}
        for f in sorted(batch, key=lambda f: (
                f.start_s if f.start_s is not None else f.req_start,
                f.fid)):
            s = 0.0
            mine = f.fid in idmap
            for d in f.deps:
                if d in slip and not (mine and d in idmap):
                    s = max(s, slip[d])   # intra-set deps already in sub
            if mine:
                new = sub.finish_s(idmap[f.fid]) + s
            else:
                new = fluid_fin[f.fid] + s
            if new > fluid_fin[f.fid]:
                slip[f.fid] = new - fluid_fin[f.fid]
            f.finish_s = new
            self._frontier = max(self._frontier, new)
        # flows still waiting on unfinished deps saw the fluid finishes
        # when their other deps completed — re-bump their earliest start
        for g in self._flows.values():
            if g.finish_s is None and g.pending > 0:
                for d in g.deps:
                    if d in slip:
                        g.req_start = max(g.req_start,
                                          self._flows[d].finish_s or 0.0)
        self.last_escalation = {
            "hot_links": len(hot), "escalated_flows": len(esc),
            "batch_flows": len(batch),
        }
        if self.telemetry is not None:
            # the sub-sim runs WITHOUT the hub: its link traffic is the
            # same payload the fluid pass already accounted (only the
            # timing is refined), so reporting both would double-count.
            # Escalated flows' spans keep their fluid finishes (stitching
            # rewrites finish_s post-hoc); the escalation itself is one
            # instant event plus counters.
            self.telemetry.add("fabric.escalations")
            self.telemetry.add("fabric.escalated_flows", float(len(esc)))
            self.telemetry.event(
                ("hybrid",), "escalation", self._frontier,
                hot_links=len(hot), escalated=len(esc),
                batch=len(batch))
        return self._frontier


# ----------------------------------------------------------------------------
# torch dense waterfill (solver="torch")
# ----------------------------------------------------------------------------

def _pad_to(n: int, quantum: int = 64) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def _solver_device(device: str | None) -> str:
    """``None`` is the card; asking for it without one raises (there is
    no fallback to the host)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'solver="torch" defaults to the card and none is '
                'available; pass device="cpu" to solve on the host')
        return "cuda"
    return str(device)


def _torch_waterfill(inc_mat: np.ndarray, wf: np.ndarray, onehot: np.ndarray,
                     cap: np.ndarray, alive: np.ndarray, wc: np.ndarray,
                     B: float, rounds: int, device: str):
    """Hierarchical progressive filling over a dense links x flows
    incidence matrix, run for a fixed number of rounds with no host
    synchronisation inside them (frozen flows take no increment, so extra
    rounds change nothing).  The JAX package's jnp waterfill in PyTorch,
    thresholds included: a link saturates at 1e-6 of its rate and a flow
    at 1 - 1e-6 of its cap (``_rates_np``: 1e-9 and 1e-12, which fp32
    cannot resolve), so where a residual falls between the two the
    allocation parts from ``_rates_np``'s, as the jnp one does.

    Every product over the incidence is an fp32 multiply and a sum
    reduction, not a matmul: a card with TF32 matmuls enabled (a
    process-wide setting the caller owns) would round the rates to ~3
    digits, so the solver does not depend on that setting."""
    import torch

    def t(x):
        return torch.from_numpy(x).to(device)

    A, wf, onehot, cap, alive, wc = (t(inc_mat), t(wf), t(onehot), t(cap),
                                     t(alive), t(wc))
    n_cls = onehot.shape[1]
    wcf = (onehot * wc).sum(1)                     # (F,) class weight
    eps = 1e-30
    inf = torch.tensor(float("inf"), device=A.device)
    zero = torch.zeros((), device=A.device)
    live = A > 0
    rate = torch.zeros_like(wf)
    resid = torch.full((A.shape[0],), B, dtype=A.dtype, device=A.device)
    unf = alive
    for _ in range(rounds):
        wfa = wf * unf
        # S[l, c]: the weight of class c's unfrozen flows on link l
        S = torch.stack([(A * (wfa * onehot[:, c])).sum(1)
                         for c in range(n_cls)], 1)
        active_w = ((S > 0).to(S.dtype) * wc).sum(1)
        s_f = sum(S[:, c:c + 1] * onehot[:, c] for c in range(n_cls))
        s_lf = A * s_f                             # S[l, class(f)] on A
        ok = live & (s_lf > 0) & (unf > 0)
        share = torch.where(
            ok,
            resid[:, None] * (wcf / torch.clamp(active_w, min=eps)[:, None])
            * (wf / torch.clamp(s_lf, min=eps)),
            inf)
        inc = share.amin(0)
        inc = torch.minimum(inc, cap - rate)
        inc = torch.where((unf > 0) & torch.isfinite(inc),
                          torch.clamp(inc, min=0.0), zero)
        rate = rate + inc
        resid = torch.clamp(resid - (A * inc).sum(1), min=0.0)
        sat = (resid <= B * 1e-6).to(A.dtype)
        flow_sat = (A * sat[:, None]).amax(0)
        capped = (rate >= cap * (1.0 - 1e-6)).to(A.dtype)
        unf = unf * (1.0 - torch.maximum(flow_sat, capped))
    return rate.cpu().numpy(), resid.cpu().numpy()
