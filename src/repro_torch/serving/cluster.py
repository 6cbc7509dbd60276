"""Multi-node serving cluster with live RDMA KV-page migration.

The paper's headline capability — zero-copy, low-latency GPU-to-GPU RDMA
across the 3D torus (GPUDirect P2P, arXiv:1307.8276 measures exactly this
path) — is what lets a serving deployment move a *running* request between
nodes without restarting its decode: the request's KV-cache pages are the
whole decode state, and they travel as one bulk dimension-ordered RDMA PUT
(``RdmaEndpoint.put_pages`` over a ``fabric.lower_p2p`` schedule).

Topology: every serving node is a rank of one shared ``Torus`` (the
cluster fabric); ranks without a serving node are pass-through routers.
Each node owns a full model replica (``PagedLM`` + ``Engine``); a router
in front admits each request to the least-loaded node.

Live migration of a slot from node A to node B:

  1. ``A.lm.export_slot``   — snapshot the slot's KV pages (logical order)
                              and sequence length;
  2. ``B.lm.import_slot``   — claim fresh pages on B, land the contents
                              (fails cleanly when B is full: the request
                              stays on A untouched);
  3. ``A.endpoint.put_pages(B, ...)`` — model the wire: TLB translation on
                              both cards, host-interface DMA, and the
                              multi-hop unicast priced by ``fabric.estimate``
                              — rewritten by the fault machinery, so a dead
                              link on the route becomes a BFS detour
                              (``hops`` up, tokens unchanged) and a
                              partitioned fabric raises ``UnroutableError``;
  4. the request detaches from A's batch, frees A's pages, and resumes
     decode on B **bitwise-identically** to the unmigrated run (the page
     contents + seq_len are the complete decode state; positions past
     seq_len are masked on both nodes).

The alternative to migrating ~len(context) * bytes_per_token of KV is
re-prefilling the context on B — a whole-prompt forward that stalls B's
running decode batch.  ``MigrationReport`` carries both modelled numbers;
``benchmarks/migration.py`` gates migration being the cheaper move.

Time is ONE shared fabric timeline (``fabric.FabricSim``): every node's
RDMA endpoint and per-decode-step TP collectives inject flows into the
same event-driven, link-level simulator, so a migration PUT issued while
decode traffic is in flight is priced *with* the contention (and slows
the decode comm in return) — ``MigrationReport.contention_slowdown``
reports how much the old sum-of-isolated models under-priced the move.
``migrate`` picks its route by simulated completion time against that
live traffic (``route_policy="congestion"``), not hop count;
the JAX package's ``benchmarks/contention.py`` gates both behaviours.

The counterpart of the JAX package's ``serving/cluster.py``.  Every node's
``PagedLM`` lives on one ``device`` (the card unless the caller asks for
the CPU) and all of them share ONE ``TransformerLM`` there — no weight
copy per node; a migration between nodes on one card is a device-to-device
copy between their K/V pools.  The fabric timeline (routes, flows,
``MigrationReport``, ``stats()``) is host float64 arithmetic and equals
the JAX package's bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import fabric
from repro_torch.core.apelink import NetModel
from repro_torch.core.hw import PAPER_GPU_EFF_FLOPS as GPU_EFF_FLOPS
from repro_torch.core.topology import Torus
from repro_torch.models.common import ArchCfg
from repro_torch.serving.engine import (Engine, PagedLM, Request,
                                  TruncatedRunError)


def count_params(params: torch.nn.Module) -> int:
    """Parameter count as the JAX package counts its pytree's leaves: a
    tied embedding is one leaf there and one shared parameter here, so
    ``parameters()`` (which yields a shared tensor once) agrees."""
    return sum(int(np.prod(p.shape)) for p in params.parameters())


def reprefill_stall_s(n_params: int, context_tokens: int,
                      flops: float = GPU_EFF_FLOPS) -> float:
    """Modelled decode stall of re-prefilling ``context_tokens`` from
    scratch on the destination (2 FLOPs per param per token forward, at
    the paper-era rate of ``hw.PAPER_GPU_EFF_FLOPS``) — the cost
    migration avoids."""
    return 2.0 * n_params * context_tokens / flops


@dataclasses.dataclass(frozen=True)
class MigrationReport:
    """One slot migration: what moved, over what route, at what cost."""

    rid: int
    src: int                     # torus rank of the source node
    dst: int                     # torus rank of the destination node
    n_pages: int
    nbytes: int                  # KV payload on the wire
    hops: int                    # route length actually taken
    min_hops: int                # healthy-fabric dimension-ordered distance
    modelled_s: float            # put_pages: translation + DMA + wire,
    #                              priced on the shared timeline (contended)
    reprefill_s: float           # the decode stall migrating avoided
    isolated_s: float = 0.0      # sum-of-isolated price (quiet fabric)
    route_policy: str = "hops"   # how the route was picked
    stripes: int = 1             # wire legs the PUT was split across

    @property
    def rerouted(self) -> bool:
        """Route longer than the healthy minimal one — a fault detour or a
        congestion-motivated one."""
        return self.hops > self.min_hops

    @property
    def speedup(self) -> float:
        """Avoided stall per second of modelled migration time."""
        return self.reprefill_s / self.modelled_s if self.modelled_s else 0.0

    @property
    def contention_slowdown(self) -> float:
        """Contended price / quiet-fabric price (1.0 = nothing in the
        way); > 1 means the old sum-of-isolated models under-priced it."""
        return self.modelled_s / self.isolated_s if self.isolated_s else 1.0


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """Serving-level objectives + the knobs that defend them.

    Attaching one (``ServingCluster(slo=...)``) switches the router to
    *capacity-aware* admission: a request only lands on a node whose free
    slots AND free KV pages (net of what its queued requests will claim,
    and of ``min_free_pages`` headroom) can actually hold it; otherwise
    it waits in a cluster-level admission queue, and is **shed** when the
    queue overflows ``queue_limit`` or it has waited ``max_queue_wait_s``
    on the shared timeline.  Without a policy the router keeps the legacy
    least-loaded behaviour bit-for-bit.

    ``token_target_s`` is the per-token decode-latency SLO the proactive
    rebalancer defends: it acts when a node's *predicted* next-window
    per-token latency crosses ``token_target_s * headroom`` — before the
    breach, not after the p99 already moved.
    """

    ttft_target_s: float = 0.5       # reported against, not enforced
    token_target_s: float = 0.05     # per-token decode latency SLO
    headroom: float = 0.8            # act at target*headroom (pre-breach)
    queue_limit: int = 256           # admission queue cap; overflow sheds
    max_queue_wait_s: float = 2.0    # queued longer than this sheds
    min_free_pages: int = 0          # per-node KV page headroom kept free
    max_moves_per_window: int = 4    # proactive migration budget
    probe_dsts: int = 2              # destinations probed per candidate
    max_migration_s: float | None = None   # skip moves probed slower


@dataclasses.dataclass
class ClusterNode:
    """One serving node: a torus rank owning a model replica."""

    rank: int
    lm: PagedLM
    engine: Engine

    @property
    def load(self) -> int:
        return self.engine.load


class ServingCluster:
    """N model replicas on one torus fabric behind a least-loaded router.

    ``node_ranks`` selects which torus ranks carry a serving node (default:
    all of them) — a fabric larger than the serving set leaves the spare
    ranks as pure routers, exactly like compute-less switch hops.
    """

    def __init__(self, cfg: ArchCfg, params, *, torus: Torus,
                 node_ranks: Sequence[int] | None = None,
                 max_batch: int = 4, max_seq: int = 64,
                 page_tokens: int = 16, pool_pages: int | None = None,
                 chunked_prefill: bool = False,
                 tp_axes: tuple[str, ...] | None = (),
                 net=None, sim_kw: dict | None = None,
                 qos: fabric.QosPolicy | str | None = "auto",
                 fidelity: str = "packet",
                 modelled: bool = False,
                 n_params: int | float | None = None,
                 descriptor_bytes: float | None = None,
                 restripe_s: float | None = None,
                 slo: SloPolicy | None = None,
                 telemetry: "object | None" = None,
                 device=None) -> None:
        self.cfg = cfg
        self.torus = torus
        # ``modelled=True`` builds accounting-only replicas (no K/V
        # tensors) — the trace-replay mode; ``n_params`` must
        # then be given explicitly (there are no real params to count)
        # so the analytic compute model prices decode windows.
        if modelled and not n_params:
            raise ValueError("modelled=True needs an explicit n_params "
                             "(no real params to size the compute model)")
        # qos="auto" (default) consults the fabric autotuner's pinned
        # ``best_configs.json`` ("serving" entry): a searched multi-class
        # policy when one is pinned, the legacy single-FIFO link when not.
        # Passing an explicit QosPolicy or None always wins.
        self._tuned = fabric.autotune.tuned_config("serving")
        if qos == "auto":
            qos = self._tuned.qos() if self._tuned is not None else None
        ranks = tuple(node_ranks) if node_ranks is not None \
            else tuple(torus.all_ranks())
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"repeated node ranks {ranks}")
        # ONE event-driven timeline for the whole cluster: every node's
        # RDMA endpoint and decode-step TP collectives inject flows here,
        # so a migration PUT and live decode traffic genuinely contend for
        # the links they share (fabric.sim.FabricSim); one NetModel prices
        # every node's wire identically.  ``qos`` selects the link
        # arbiter: a multi-class QosPolicy gives decode-step TP flows
        # (DECODE) weighted protection from migration PUTs (BULK); the
        # default keeps the classic single-FIFO link.  ``fidelity``
        # selects the simulator tier (``fabric.make_sim``): "packet" is
        # the bitwise oracle, "fluid"/"hybrid" keep a big cluster's
        # shared timeline affordable (flow-level rate allocation; probes
        # stay cheap, so congestion-aware routing scales).
        self.net = net or NetModel()
        sim_kw = dict(sim_kw or {})
        if qos is not None:
            sim_kw.setdefault("qos", qos)
        # ONE optional Telemetry hub for the whole cluster: the shared
        # sim reports per-link counters/flow spans into it, every node's
        # RDMA endpoint reports PUT spans, and the cluster itself stamps
        # admission/shed/migration/fault-epoch events.  None (default)
        # is bitwise-invisible end to end.
        self.telemetry = telemetry
        if telemetry is not None:
            sim_kw.setdefault("telemetry", telemetry)
        self.sim = fabric.make_sim(torus, self.net, fidelity=fidelity,
                                   **sim_kw)
        self.nodes: dict[int, ClusterNode] = {}
        for r in ranks:
            lm = PagedLM(cfg, params, max_batch=max_batch, max_seq=max_seq,
                         page_tokens=page_tokens, pool_pages=pool_pages,
                         torus=torus, tp_axes=tp_axes, rank=r,
                         sim=self.sim, net=self.net, modelled=modelled,
                         descriptor_bytes=descriptor_bytes, device=device)
            if telemetry is not None:
                lm.endpoint.telemetry = telemetry
            self.nodes[r] = ClusterNode(
                r, lm, Engine(lm, chunked_prefill=chunked_prefill))
        self.page_tokens = page_tokens
        self.page_nbytes = (page_tokens
                            * self.nodes[ranks[0]].lm.bytes_per_token)
        if n_params is None:
            n_params = count_params(params)
        self.n_params = int(n_params)
        self.modelled = modelled
        # mid-flight re-striping checkpoint for migration PUTs: after
        # ``restripe_s`` of wire time the remaining pages are re-split
        # across freshly probed routes (``RdmaEndpoint.put_pages``).
        # None (default) keeps every PUT on its launch-time routes.
        self.restripe_s = restripe_s
        self.slo = slo
        self.admission_queue: collections.deque[Request] = \
            collections.deque()
        self.shed: list[Request] = []
        self.faults = fabric.FaultMap()
        self.migrations: list[MigrationReport] = []
        self._window_start = 0.0
        self._window_open = False

    # -- fault feed (LO|FA|MO master view) --------------------------------------
    def fail_link(self, a: int, b: int) -> None:
        """Mark the first-neighbour link (a, b) dead; later migrations
        reroute around it (the fault machinery's BFS detour), and every
        node's decode TP twin is re-lowered through ``fabric.rewrite`` so
        the per-step TP flows price the shrunk/detoured rings honestly —
        not just via the sim's route resolution."""
        self.faults = fabric.FaultMap.normalized(
            self.faults.dead_nodes,
            set(self.faults.dead_links) | {(a, b)})
        self.sim.faults = self.faults   # sim flows detour the same map
        # route/BFS memo entries are keyed by fault epoch, so stale hits
        # are impossible — dropping the dead epoch's entries just keeps
        # the cache from accumulating one generation per fault event
        fabric.clear_route_cache()
        for node in self.nodes.values():
            node.lm.relower_tp(self.faults)
        if self.telemetry is not None:
            # exactly one fault-epoch stamp per fail_link call — the
            # sims themselves have no fault mutators, this is THE site
            self.telemetry.add("fabric.fault_epochs")
            self.telemetry.event(("cluster",), "fail_link",
                                 float(self.sim.now), a=a, b=b)

    def clear_faults(self) -> None:
        self.faults = fabric.FaultMap()
        self.sim.faults = self.faults
        fabric.clear_route_cache()
        for node in self.nodes.values():
            node.lm.relower_tp(self.faults)
        if self.telemetry is not None:
            self.telemetry.add("fabric.fault_epochs")
            self.telemetry.event(("cluster",), "clear_faults",
                                 float(self.sim.now))

    # -- router -----------------------------------------------------------------
    @property
    def t_token_s(self) -> float:
        """Analytic decode cost of one token on one replica (2 FLOPs per
        param per token at the paper-era effective rate)."""
        return 2.0 * self.n_params / GPU_EFF_FLOPS

    def _pages_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens)
                 // self.page_tokens)

    def _can_host(self, node: ClusterNode, req: Request) -> bool:
        """Capacity check for SLO admission: a free slot AND enough free
        KV pages once the node's already-queued requests (which WILL
        claim theirs first) and the policy's headroom are netted out.
        ``Engine.load`` alone can't see pool pressure — two nodes with
        equal load can differ by a whole pool of committed pages."""
        eng = node.engine
        occupied = (len(eng.running) + len(eng.prefilling)
                    + len(eng.pending))
        if occupied >= node.lm.max_batch:
            return False
        reserved = sum(self._pages_needed(r) for r in eng.pending)
        free = (len(node.lm.allocator.free) - reserved
                - self.slo.min_free_pages)
        return free >= self._pages_needed(req)

    def submit(self, req: Request, *,
               prefer: int | None = None) -> int | None:
        """Route one request.

        Legacy mode (no ``slo``): admit to the least-loaded node (stable
        tie-break: lowest rank) unconditionally; returns the chosen rank.

        SLO mode: ``prefer`` (a session's home node — its modelled prefix
        cache holds ``req.warm_tokens``) wins when it has capacity;
        otherwise least-loaded among nodes that pass ``_can_host``.  A
        request routed away from its home node re-prefills cold
        (``warm_tokens`` is zeroed).  With no capacity anywhere the
        request queues — or is shed when the queue is past
        ``queue_limit`` — and ``None`` is returned.
        """
        if req.arrival_s is None:
            req.arrival_s = self.sim.now
        if self.slo is None:
            node = min(self.nodes.values(), key=lambda n: (n.load, n.rank))
            node.engine.submit(req)
            return node.rank
        node = None
        if prefer is not None and prefer in self.nodes \
                and self._can_host(self.nodes[prefer], req):
            node = self.nodes[prefer]
        else:
            fits = [n for n in self.nodes.values()
                    if self._can_host(n, req)]
            if fits:
                node = min(fits, key=lambda n: (n.load, n.rank))
        if node is None:
            if len(self.admission_queue) >= self.slo.queue_limit:
                req.shed_s = self.sim.now
                self.shed.append(req)
                if self.telemetry is not None:
                    self.telemetry.add("cluster.sheds")
            else:
                self.admission_queue.append(req)
            return None
        if prefer is not None and node.rank != prefer:
            req.warm_tokens = 0   # prefix cache is home-node-local
        node.engine.submit(req)
        req.admit_s = self.sim.now
        if self.telemetry is not None:
            self.telemetry.add("cluster.admitted")
            self.telemetry.add("cluster.queue_wait_s",
                               req.admit_s - (req.arrival_s or 0.0))
        return node.rank

    def _drain_admission(self) -> int:
        """Re-try the queued requests against current capacity (called at
        each window boundary): place what now fits, shed what has waited
        past ``max_queue_wait_s``.  FIFO with head-of-line skip — a short
        request behind a long one may be placed first; the wait cap
        bounds the starvation that trade accepts."""
        if self.slo is None or not self.admission_queue:
            return 0
        now = self.sim.now
        placed = 0
        keep: collections.deque[Request] = collections.deque()
        while self.admission_queue:
            req = self.admission_queue.popleft()
            if now - (req.arrival_s or 0.0) > self.slo.max_queue_wait_s:
                req.shed_s = now
                self.shed.append(req)
                if self.telemetry is not None:
                    self.telemetry.add("cluster.sheds")
                continue
            fits = [n for n in self.nodes.values()
                    if self._can_host(n, req)]
            if fits:
                node = min(fits, key=lambda n: (n.load, n.rank))
                req.warm_tokens = 0   # queue wait forfeits the warm prefix
                node.engine.submit(req)
                req.admit_s = now
                placed += 1
                if self.telemetry is not None:
                    self.telemetry.add("cluster.admitted")
                    self.telemetry.add("cluster.queue_wait_s",
                                       now - (req.arrival_s or 0.0))
            else:
                keep.append(req)
        self.admission_queue = keep
        return placed

    def step(self) -> None:
        """One engine step on every node — one *logical window* of the
        shared fabric timeline.  All nodes' decode TP flows enter at the
        window start; the window stays open until the next step (or
        stats), so a ``migrate()`` issued between steps lands in the same
        window and contends with the decode traffic already in flight."""
        self._close_window()
        self._drain_admission()
        self._window_start = self.sim.now
        self._window_open = True
        for node in self.nodes.values():
            node.engine.step()

    def _close_window(self) -> None:
        """Settle the open window: resolve every node's injected flows,
        advance the shared clock past both the contention-priced comm and
        the modelled decode compute of the busiest node, and stamp the
        per-request SLO times (first token / finish) with each node's own
        window end — a hot node's tokens genuinely land later than a cold
        node's in the same window, which is exactly the tail the SLO
        metrics must see."""
        if not self._window_open:
            return
        self._window_open = False
        ws = self._window_start
        t_tok = self.t_token_s
        end = ws
        for node in self.nodes.values():
            eng = node.engine
            comm_end = eng.settle_comm(ws)
            # per-node compute: every decoded token, plus (modelled lms
            # only) the cold prefill tokens admitted this window — the
            # real prefill path measures its own wall time instead
            tokens = (eng.window_decode_tokens
                      + eng.window_cold_prefill_tokens)
            node_end = max(comm_end, ws + t_tok * tokens)
            end = max(end, node_end)
            for req in eng.window_first:
                if req.first_token_s is None:
                    req.first_token_s = node_end
            for req in eng.window_finished:
                req.finish_s = node_end
            eng.window_first = []
            eng.window_finished = []
        self.sim.advance(end)
        # the window's finishes are all accounted for: drop the settled
        # flows so the long-lived timeline (and every route probe's copy
        # of it) stays O(in-flight), not O(uptime)
        self.sim.prune()

    def settle(self) -> None:
        """Close the open window (if any) — public seam for drivers
        (trace replay) that interleave their own work between steps and
        must settle the last window without another engine step."""
        self._close_window()

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        """Step until nothing is in flight.  Raises ``TruncatedRunError``
        when ``max_steps`` windows pass with requests still in flight —
        the silently-truncated alternative corrupts exactly the p99 tail
        a long replay exists to measure."""
        steps = 0
        while self.in_flight and steps < max_steps:
            self.step()
            steps += 1
        self._close_window()
        if self.in_flight:
            raise TruncatedRunError(steps, self.in_flight)

    @property
    def in_flight(self) -> int:
        return (sum(n.load for n in self.nodes.values())
                + len(self.admission_queue))

    @property
    def finished(self) -> list[Request]:
        out: list[Request] = []
        for node in self.nodes.values():
            out.extend(node.engine.finished)
        return sorted(out, key=lambda r: r.rid)

    # -- live migration ---------------------------------------------------------
    def _find_running(self, rid: int) -> tuple[ClusterNode, Request]:
        for node in self.nodes.values():
            for req in node.engine.running.values():
                if req.rid == rid:
                    return node, req
        raise KeyError(f"request {rid} is not running on any node "
                       "(pending/prefilling/finished requests don't migrate)")

    def migrate(self, rid: int, dst_rank: int, *,
                route_policy: str | None = None,
                stripe_k: int | None = None) -> MigrationReport:
        """Live-migrate a running request's KV pages to ``dst_rank``.

        Decode resumes on the destination with bitwise-identical tokens;
        raises ``UnroutableError`` when the fault map separates the nodes,
        and leaves the request untouched on the source when the
        destination has no free slot/pages.

        ``route_policy="congestion"`` (default) probes every candidate
        route (the fault BFS machinery's loop-free detour family) against
        the live traffic on the shared timeline and takes the one with the
        least *simulated completion time* — on a quiet fabric that is the
        minimal dimension-ordered path, but when decode collectives are
        hammering the direct links a longer detour can genuinely win.
        ``route_policy="hops"`` keeps the classic hop-count-minimal route.
        ``route_policy="striped"`` splits the PUT across the ``stripe_k``
        best-probed candidate routes at once (``fabric.striped_routes``),
        each stripe carrying a probed-goodput-proportional page share —
        multi-path bandwidth aggregation, priced with the receiver's
        reorder/settle model (``RdmaEndpoint.put_pages(stripes=...)``).
        The PUT rides the BULK traffic class: on a QoS fabric it cannot
        starve the decode-step collectives it contends with.

        Both knobs default to ``None`` — resolved from the autotuner's
        pinned ``best_configs.json`` ("serving" entry) when one exists,
        falling back to the hand-tuned ``"congestion"`` / ``stripe_k=3``
        otherwise.  Explicit values always win.
        """
        if route_policy is None:
            route_policy = (self._tuned.route_policy
                            if self._tuned is not None else "congestion")
        if stripe_k is None:
            stripe_k = (self._tuned.stripe_k
                        if self._tuned is not None else 3)
        src_node, req = self._find_running(rid)
        if dst_rank not in self.nodes:
            raise KeyError(f"no serving node at rank {dst_rank}")
        if dst_rank == src_node.rank:
            raise ValueError(f"request {rid} already lives on {dst_rank}")
        dst_node = self.nodes[dst_rank]
        old_slot = req.slot
        assert old_slot is not None
        state = src_node.lm.export_slot(old_slot)
        # route first: an unroutable fabric must fail before any state
        # moves (the request keeps decoding on the source)
        stripes = None
        if route_policy == "congestion":
            route, _ = fabric.best_route(
                self.sim, src_node.rank, dst_rank, state.nbytes,
                faults=self.faults)
            sched = fabric.lower_route(self.torus, route, faults=self.faults)
        elif route_policy == "hops":
            sched = fabric.lower_p2p(self.torus, src_node.rank, dst_rank,
                                     faults=self.faults)
        elif route_policy == "striped":
            plan = fabric.striped_routes(
                self.sim, src_node.rank, dst_rank, state.nbytes,
                k=stripe_k, faults=self.faults)
            stripes = self._stripe_pages(plan, state.n_pages)
            sched = max((s for s, _ in stripes), key=lambda s: s.max_hops)
        else:
            raise ValueError(f"unknown route_policy {route_policy!r}")
        new_slot = dst_node.lm.import_slot(state)
        # only the live pages ride the wire (headroom is claimed fresh on
        # the destination) — the same byte count the bench gate prices
        modelled = src_node.lm.endpoint.put_pages(
            dst_rank, src_node.lm.allocator.region,
            src_node.lm.live_pages(old_slot),
            page_nbytes=self.page_nbytes,
            dst_endpoint=dst_node.lm.endpoint,
            dst_region=dst_node.lm.allocator.region,
            dst_pages=dst_node.lm.slot_pages[new_slot][:state.n_pages],
            schedule=None if stripes is not None else sched,
            stripes=stripes, restripe_s=self.restripe_s,
            faults=self.faults)
        src_node.engine.detach(old_slot)
        src_node.lm.free_slot(old_slot)
        req.slot = new_slot
        dst_node.engine.attach(req)
        put = src_node.lm.endpoint.last_put_report or {}
        report = MigrationReport(
            rid=rid, src=src_node.rank, dst=dst_rank,
            n_pages=state.n_pages, nbytes=state.nbytes,
            hops=sched.max_hops,
            min_hops=self.torus.hop_distance(src_node.rank, dst_rank),
            modelled_s=modelled,
            reprefill_s=reprefill_stall_s(self.n_params, req.pos),
            isolated_s=put.get("isolated_s", modelled),
            route_policy=route_policy,
            stripes=put.get("stripes", 1))
        self.migrations.append(report)
        if self.telemetry is not None:
            self.telemetry.add("cluster.migrations")
            self.telemetry.add("cluster.migrated_bytes",
                               float(report.nbytes))
            self.telemetry.event(
                ("cluster",), "migrate", float(self.sim.now),
                rid=rid, src=report.src, dst=report.dst,
                n_pages=report.n_pages, stripes=report.stripes)
        return report

    def _stripe_pages(self, plan, n_pages: int) -> list[tuple]:
        """Turn a ``fabric.striped_routes`` plan into put_pages stripes:
        page-granular byte shares (``fabric.stripe_counts``, zero-page
        stripes dropped — a stripe must carry at least one page)."""
        counts = fabric.stripe_counts(plan, n_pages)
        stripes = []
        for (route, _), c in zip(plan, counts):
            if c <= 0:
                continue
            sched = fabric.lower_route(self.torus, route, faults=self.faults)
            stripes.append((sched, c * self.page_nbytes))
        if not stripes:   # zero live pages: one empty leg on the best route
            stripes = [(fabric.lower_route(self.torus, plan[0][0],
                                           faults=self.faults), 0)]
        return stripes

    def rebalance(self, threshold: int = 2) -> MigrationReport | None:
        """Migrate one running request from the most- to the least-loaded
        node when the load gap reaches ``threshold``; returns the report
        (or None when balanced / nothing migratable).

        A full destination is not "balanced": when the idlest node's
        pool/slots reject the move (``RuntimeError``), the next-idlest
        destination is tried, then the next candidate request — the old
        single-shot ``return None`` left a glaring gap standing whenever
        the one preferred destination happened to be page-starved."""
        busiest = max(self.nodes.values(), key=lambda n: (n.load, -n.rank))
        idlest = min(self.nodes.values(), key=lambda n: (n.load, n.rank))
        if busiest.rank == idlest.rank \
                or busiest.load - idlest.load < threshold \
                or not busiest.engine.running:
            return None
        # candidates: most decode work left first — it amortises the wire
        # cost over the largest avoided future imbalance
        cands = sorted(busiest.engine.running.values(),
                       key=lambda r: (-(r.max_new_tokens
                                        - len(r.out_tokens)), r.rid))
        # destinations: idlest first, but only while the move still
        # closes a meaningful gap (moving to a node one short of the
        # source just swaps the hotspot)
        dsts = sorted((n for n in self.nodes.values()
                       if n.rank != busiest.rank
                       and busiest.load - n.load >= threshold),
                      key=lambda n: (n.load, n.rank))
        for req in cands:
            for dst in dsts:
                try:
                    return self.migrate(req.rid, dst.rank)
                except fabric.UnroutableError:
                    raise   # a partitioned fabric is NOT "balanced"
                except RuntimeError:
                    continue   # dst pool/slots full: try the next one
        return None   # nothing migratable fits anywhere: stay put

    def _predicted_window_tokens(self, node: ClusterNode) -> int:
        """Compute tokens ``node``'s next engine step will carry: one per
        active decode, plus each prefilling request's next chunk (the
        whole cold remainder when prefill is monolithic), plus the first
        chunk of whatever admission will pull in from the local queue.
        Chunk-accurate: charging a queued prompt's entire cold prefill to
        one window would make every node with a queue look molten and
        every chunk-prefilling node look idle — exactly backwards."""
        eng = node.engine
        chunk = eng.chunk_tokens if eng.chunked_prefill else None
        toks = sum(1 for r in eng.running.values() if not r.done)
        for r in eng.prefilling.values():
            pos = r.pos if r.pos > 0 \
                else min(max(r.warm_tokens, 0), len(r.prompt))
            rem = max(len(r.prompt) - pos, 0)
            toks += min(chunk, rem) if chunk is not None else rem
        slots_free = (node.lm.max_batch - len(eng.running)
                      - len(eng.prefilling))
        for r in eng.pending[:max(slots_free, 0)]:
            cold = max(len(r.prompt) - max(r.warm_tokens, 0), 0)
            toks += min(chunk, cold) if chunk is not None else cold
        return toks

    def _predicted_token_latency(self, node: ClusterNode) -> float:
        """Predicted per-token decode latency of ``node``'s next window:
        analytic compute for the window's tokens vs the node's
        quiet-fabric TP comm floor — the pre-breach signal the proactive
        rebalancer acts on."""
        return max(self.t_token_s * self._predicted_window_tokens(node),
                   node.lm.predicted_tp_comm_s)

    def rebalance_proactive(self, max_moves: int | None = None
                            ) -> list[MigrationReport]:
        """SLO-defending rebalance: striped-migrate running requests off
        any node whose *predicted* next-window per-token latency exceeds
        ``token_target_s * headroom`` — before the p99 breach, not after.

        Unlike ``rebalance`` this is not load-count arithmetic: the
        trigger is the latency prediction, the destination must keep
        enough predicted headroom to absorb the request, and among the
        ``probe_dsts`` least-loaded-by-prediction destinations the one
        with the least *probed* PUT completion time on the live fabric
        wins (``fabric.best_route`` against current traffic, BULK class)
        — a destination behind a congested link is passed over even when
        its compute is idle.  Moves are capped at ``max_moves_per_window``
        and each PUT stripes across multi-path routes; a move whose
        probed wire time exceeds ``max_migration_s`` (when set) is
        skipped — it could not complete ahead of the breach it is meant
        to prevent.
        """
        if self.slo is None:
            raise ValueError("rebalance_proactive needs an SloPolicy "
                             "(ServingCluster(slo=...))")
        slo = self.slo
        budget = slo.token_target_s * slo.headroom
        limit = slo.max_moves_per_window if max_moves is None else max_moves
        t_tok = self.t_token_s
        pred = {r: self._predicted_token_latency(n)
                for r, n in self.nodes.items()}
        reports: list[MigrationReport] = []
        hot = sorted((n for n in self.nodes.values()
                      if pred[n.rank] > budget),
                     key=lambda n: (-pred[n.rank], n.rank))
        for node in hot:
            while (len(reports) < limit and pred[node.rank] > budget
                   and node.engine.running):
                cands = sorted(
                    (r for r in node.engine.running.values()
                     if not r.done),
                    key=lambda r: (-(r.max_new_tokens
                                     - len(r.out_tokens)), r.rid))
                moved = None
                for req in cands:
                    nbytes = (-(-max(req.pos, 1) // self.page_tokens)
                              * self.page_nbytes)
                    # destinations that keep predicted headroom after
                    # absorbing one more decode stream, best-predicted
                    # first; the top few are probed on the live fabric
                    dsts = sorted(
                        (d for d in self.nodes.values()
                         if d.rank != node.rank
                         and pred[d.rank] + t_tok <= budget),
                        key=lambda d: (pred[d.rank], d.rank))
                    probed = []
                    for d in dsts[:max(slo.probe_dsts, 1)]:
                        try:
                            _, wire = fabric.best_route(
                                self.sim, node.rank, d.rank, nbytes,
                                faults=self.faults,
                                cls=fabric.TrafficClass.BULK)
                        except fabric.UnroutableError:
                            continue
                        if slo.max_migration_s is not None \
                                and wire > slo.max_migration_s:
                            continue
                        probed.append((wire, d.rank, d))
                    for _, _, d in sorted(probed,
                                          key=lambda x: (x[0], x[1])):
                        try:
                            moved = self.migrate(req.rid, d.rank,
                                                 route_policy="striped")
                            break
                        except fabric.UnroutableError:
                            raise
                        except RuntimeError:
                            continue   # dst filled up since the probe
                    if moved is not None:
                        break
                if moved is None:
                    break   # nothing migratable fits anywhere cooler
                reports.append(moved)
                pred[node.rank] = self._predicted_token_latency(node)
                pred[moved.dst] = self._predicted_token_latency(
                    self.nodes[moved.dst])
        return reports

    def slo_stats(self) -> dict:
        """SLO-layer counters (admission + per-class fabric bytes) — the
        latency percentiles themselves live in ``serving.trace``, which
        owns the request population."""
        cs = self.sim.class_stats()
        return {
            "queued": len(self.admission_queue),
            "shed": len(self.shed),
            "class_bytes": {cls.name: float(v) for cls, v in cs.items()},
            "n_migrations": len(self.migrations),
            "migrated_bytes": sum(m.nbytes for m in self.migrations),
        }

    # -- reporting --------------------------------------------------------------
    def stats(self) -> dict:
        """Cluster-wide report.  A pure read: the open fabric window (if
        any) is left open, so a monitoring poll between ``step()`` and
        ``migrate()`` cannot quietly settle the in-flight decode traffic
        a contention-priced migration is about to contend with —
        ``sim_tp_comm_s`` therefore reflects *settled* windows only
        (``run_to_completion`` closes the last one)."""
        per_node = {r: dict(n.engine.stats(), load=n.load)
                    for r, n in self.nodes.items()}
        return {
            "nodes": per_node,
            "n_migrations": len(self.migrations),
            "migrated_bytes": sum(m.nbytes for m in self.migrations),
            "migration_modelled_s": sum(m.modelled_s
                                        for m in self.migrations),
            "migration_isolated_s": sum(m.isolated_s
                                        for m in self.migrations),
            "reprefill_avoided_s": sum(m.reprefill_s
                                       for m in self.migrations),
            "rerouted_migrations": sum(m.rerouted for m in self.migrations),
            "faults": {"dead_nodes": sorted(self.faults.dead_nodes),
                       "dead_links": sorted(self.faults.dead_links)},
            "fabric_sim_now_s": self.sim.now,
        }


def owners(cluster: ServingCluster,
           rids: Iterable[int]) -> dict[int, int | None]:
    """rid -> rank map over running/prefilling/pending requests (test and
    example helper; finished requests map to None)."""
    out: dict[int, int | None] = {rid: None for rid in rids}
    for node in cluster.nodes.values():
        eng = node.engine
        for req in (*eng.pending, *eng.prefilling.values(),
                    *eng.running.values()):
            if req.rid in out:
                out[req.rid] = node.rank
    return out
