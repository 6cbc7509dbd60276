"""Seeded heavy-tailed synthetic traces + the cluster replay driver.

This is the north-star workload: the paper's fabric exists to keep
latency low *under sustained real traffic* (arXiv:1311.1741 §1), and a
serving deployment's real traffic is not a uniform stream — it has a
diurnal swing, Poisson burst arrivals on top, Zipf-heavy prompt/output
lengths, and session reuse (a follow-up turn re-submits its whole
conversation, of which the home node's prefix cache already holds the
prefix).  ``generate_trace`` synthesises exactly that shape from one
seed, bitwise-reproducibly; ``replay`` drives a ``ServingCluster``
through it on the shared fabric timeline and reports the SLO metrics
that matter at the tail: p50/p99 time-to-first-token and per-token
decode latency, plus the admission layer's shed rate.

Determinism contract: every random draw goes through one
``numpy.random.Generator(PCG64(seed))`` in a fixed call order, so the
same ``TraceConfig`` yields an identical trace — and, the fabric tiers
being deterministic, an identical replay — on every run.  The CI gate
relies on this (same-seed snapshots diff at 0%).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.engine import Request, TruncatedRunError


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs of the synthetic workload (all rates in requests/second,
    all lengths in tokens, times in seconds on the replay timeline)."""

    n_requests: int = 1000
    seed: int = 0
    # -- arrival process: nonhomogeneous Poisson (thinning) ------------
    base_rate: float = 100.0     # diurnal midline arrival rate
    diurnal_amp: float = 0.6     # rate swings +-amp around the midline
    diurnal_period_s: float = 60.0   # one compressed "day"
    burst_rate: float = 0.05     # Poisson burst events per second
    burst_size: float = 8.0      # mean arrivals per burst (geometric)
    burst_span_s: float = 0.25   # a burst's arrivals land within this
    # -- length distributions: bounded Zipf (rank-frequency) -----------
    prompt_min: int = 16
    prompt_max: int = 256
    prompt_zipf_a: float = 1.4
    output_min: int = 8
    output_max: int = 96
    output_zipf_a: float = 1.2
    # -- session reuse -------------------------------------------------
    session_p: float = 0.35      # P(an arrival continues an old session)
    session_gap_s: float = 1.0   # think time before a follow-up turn
    max_context: int = 448       # cap on a turn's total prompt length


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One trace arrival.  ``prompt_tokens`` is the FULL conversation
    context the turn submits; ``warm_tokens`` is the prefix of it the
    session's home node still holds in its (modelled) prefix cache —
    a router that honours session affinity prefills only the cold
    suffix, one that bounces the turn elsewhere re-prefills it all."""

    rid: int
    t: float                     # arrival time (s)
    prompt_tokens: int
    output_tokens: int
    session: int
    turn: int                    # 0 = session opener
    warm_tokens: int


def _zipf_pmf(n: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return w / w.sum()


def _zipf_len(rng: np.random.Generator, lo: int, hi: int,
              a: float, pmf: np.ndarray) -> int:
    """Bounded Zipf over [lo, hi]: rank-1 (the mode) maps to ``lo``, so
    most lengths are short and the tail is heavy but capped."""
    return lo + int(rng.choice(len(pmf), p=pmf))


def generate_trace(cfg: TraceConfig) -> list[TraceRequest]:
    """Synthesise a seeded trace (sorted by arrival time).

    Arrival process: homogeneous Poisson at the diurnal peak rate,
    thinned to ``base_rate * (1 + amp*sin(2*pi*t/period))`` — the
    textbook nonhomogeneous-Poisson construction, exact and one-pass.
    Burst events arrive as their own Poisson process; each splashes a
    geometric number of extra arrivals across ``burst_span_s``.
    """
    rng = np.random.Generator(np.random.PCG64(cfg.seed))
    p_pmf = _zipf_pmf(cfg.prompt_max - cfg.prompt_min + 1,
                      cfg.prompt_zipf_a)
    o_pmf = _zipf_pmf(cfg.output_max - cfg.output_min + 1,
                      cfg.output_zipf_a)

    lam_max = cfg.base_rate * (1.0 + abs(cfg.diurnal_amp))
    t = 0.0
    base: list[float] = []
    while len(base) < cfg.n_requests:
        t += rng.exponential(1.0 / lam_max)
        rate = cfg.base_rate * (1.0 + cfg.diurnal_amp
                                * math.sin(2.0 * math.pi * t
                                           / cfg.diurnal_period_s))
        if rng.random() * lam_max < max(rate, 0.0):
            base.append(t)
    span = base[-1]
    arrivals = base
    n_bursts = int(rng.poisson(cfg.burst_rate * span))
    for _ in range(n_bursts):
        t_b = float(rng.uniform(0.0, span))
        g = int(rng.geometric(1.0 / max(cfg.burst_size, 1.0)))
        arrivals.extend(
            t_b + float(u)
            for u in rng.uniform(0.0, cfg.burst_span_s, size=g))
    arrivals.sort()
    arrivals = arrivals[:cfg.n_requests]

    # sessions: an arrival either opens a new session or continues an
    # idle one (last turn arrived >= session_gap_s ago) — the follow-up
    # re-submits the whole context, warm up to what the last turn built
    out: list[TraceRequest] = []
    last_ctx: dict[int, int] = {}     # session -> context it built
    last_t: dict[int, float] = {}     # session -> last arrival time
    turns: dict[int, int] = {}
    next_sid = 0
    for rid, t in enumerate(arrivals):
        eligible = sorted(s for s, lt in last_t.items()
                          if lt + cfg.session_gap_s <= t)
        sid = -1
        if eligible and rng.random() < cfg.session_p:
            sid = int(eligible[int(rng.integers(len(eligible)))])
            new_tokens = _zipf_len(rng, cfg.prompt_min, cfg.prompt_max,
                                   cfg.prompt_zipf_a, p_pmf)
            prompt = last_ctx[sid] + new_tokens
            if prompt > cfg.max_context:
                sid = -1              # conversation full: open fresh
        if sid < 0:
            sid = next_sid
            next_sid += 1
            prompt = _zipf_len(rng, cfg.prompt_min, cfg.prompt_max,
                               cfg.prompt_zipf_a, p_pmf)
            prompt = min(prompt, cfg.max_context)
            warm = 0
            turn = 0
        else:
            warm = last_ctx[sid]
            turn = turns[sid] + 1
        output = _zipf_len(rng, cfg.output_min, cfg.output_max,
                           cfg.output_zipf_a, o_pmf)
        out.append(TraceRequest(rid=rid, t=float(t),
                                prompt_tokens=int(prompt),
                                output_tokens=int(output),
                                session=sid, turn=turn,
                                warm_tokens=int(warm)))
        last_ctx[sid] = prompt + output
        last_t[sid] = t
        turns[sid] = turn
    return out


@dataclasses.dataclass
class ReplayReport:
    """What one replay measured.  ``metrics()`` is the deterministic
    subset (no wall time) the CI snapshots diff."""

    n_requests: int
    n_finished: int
    n_shed: int
    ttft_p50_s: float
    ttft_p99_s: float
    tpt_p50_s: float             # per-token decode latency
    tpt_p99_s: float
    makespan_s: float            # trace span on the fabric timeline
    steps: int                   # logical windows stepped
    n_migrations: int
    migrated_bytes: int
    wall_s: float                # host wall clock (NOT deterministic)

    @property
    def shed_rate(self) -> float:
        return self.n_shed / self.n_requests if self.n_requests else 0.0

    def metrics(self) -> dict[str, float]:
        # sorted-key ordering: deterministic independent of the literal's
        # (or any future caller's) insertion history, so snapshot diffs
        # and cross-tier comparisons never see a reordered dict
        return dict(sorted({
            "n_finished": float(self.n_finished),
            "shed_rate": float(self.shed_rate),
            "ttft_p50_s": float(self.ttft_p50_s),
            "ttft_p99_s": float(self.ttft_p99_s),
            "tpt_p50_s": float(self.tpt_p50_s),
            "tpt_p99_s": float(self.tpt_p99_s),
            "makespan_s": float(self.makespan_s),
            "steps": float(self.steps),
            "n_migrations": float(self.n_migrations),
            "migrated_bytes": float(self.migrated_bytes),
        }.items()))


def _pct(vals: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), q)) \
        if vals else 0.0


def replay(cluster: ServingCluster, trace: list[TraceRequest], *,
           rebalance: str = "proactive", rebalance_threshold: int = 2,
           rebalance_every_s: float | None = None,
           session_affinity: bool = True,
           qos_ctl=None, background=None,
           max_steps: int = 2_000_000,
           telemetry=None) -> ReplayReport:
    """Drive ``cluster`` through ``trace``, event-driven per node.

    Every node runs its own decode cadence: a per-node frontier
    ``busy[rank]`` advances by the analytic cost of the tokens that
    node's engine step carried (decode batch + cold prefill chunks), so
    one replica's long prefill never stalls the other 511 — the
    lock-step ``cluster.step()`` window is a fine model for a handful of
    nodes but turns a 512-node torus into a convoy.  The shared fabric
    simulator stays the single clock authority for everything that
    crosses the wire: migrations are priced (and probed) against
    whatever traffic is genuinely concurrent.

    ``rebalance`` selects the hook run after each event: ``"proactive"``
    (``rebalance_proactive``, needs an SloPolicy), ``"reactive"`` (the
    classic load-gap ``rebalance(threshold)``) or ``"none"``.  Both
    hooks scan every node, so they run at most once per
    ``rebalance_every_s`` of event-clock time (default: one token-time)
    — the same cadence for either mode, keeping the comparison fair.

    ``qos_ctl`` attaches a closed-loop QoS controller
    (``fabric.QosController``): at every hook tick it receives the
    per-token latencies of the requests that finished inside the window
    and may retune the live arbitration policy through ``sim.set_qos``.
    The controller is latched quiescent — on a replay where it never
    leaves the safe band it issues zero retunes, and the run is bitwise
    identical to ``qos_ctl=None``.

    ``background`` is a per-hook traffic callback ``(cluster, t)``:
    cross-traffic the request trace does not carry (checkpoint streams,
    a co-tenant's decode collectives) injected at every hook tick so it
    genuinely overlaps — in sim time — the migration PUTs priced inside
    the same window.  The event-driven driver otherwise serialises the
    fabric: a PUT runs the shared timeline to completion, so traffic
    injected at later event times can never contend with it.

    TTFT = first-token window end - arrival; per-token latency =
    (finish - first token) / (output tokens - 1).  Shed requests count
    in ``shed_rate`` and nowhere else.  Raises ``TruncatedRunError``
    instead of silently dropping the in-flight tail when ``max_steps``
    node-events pass.
    """
    if rebalance not in ("proactive", "reactive", "none"):
        raise ValueError(f"unknown rebalance mode {rebalance!r}")
    # the cluster's hub is the default reporting target; an explicit
    # ``telemetry=`` overrides (None + no cluster hub = zero telemetry
    # code on the replay path — bitwise-invisible)
    tel = telemetry if telemetry is not None \
        else getattr(cluster, "telemetry", None)
    t0 = time.perf_counter()
    t_tok = cluster.t_token_s
    reqs = [Request(rid=tr.rid,
                    prompt=np.zeros(tr.prompt_tokens, np.int32),
                    max_new_tokens=tr.output_tokens,
                    arrival_s=tr.t, warm_tokens=tr.warm_tokens,
                    session=tr.session)
            for tr in trace]
    home: dict[int, int] = {}    # session -> rank of its prefix cache
    busy: dict[int, float] = {r: 0.0 for r in cluster.nodes}
    i = 0
    steps = 0
    eps = 1e-12
    hook_dt = t_tok if rebalance_every_s is None else rebalance_every_s
    last_hook = -float("inf")
    win_tpts: list[float] = []   # per-token latencies finished this window

    def has_work(n) -> bool:
        e = n.engine
        return bool(e.pending or e.prefilling or e.running)

    while True:
        work = [busy[r] for r, n in cluster.nodes.items() if has_work(n)]
        nxt_arrival = reqs[i].arrival_s if i < len(reqs) else None
        if not work and nxt_arrival is None \
                and not cluster.admission_queue:
            break
        cands = []
        if work:
            cands.append(min(work))
        if nxt_arrival is not None:
            cands.append(nxt_arrival)
        if not cands:
            # only unplaceable stragglers queue: nothing decodes, so no
            # event advances the clock — jump past the wait cap so
            # admission sheds them instead of spinning
            wait = (cluster.slo.max_queue_wait_s
                    if cluster.slo is not None else 0.0)
            cands.append(cluster.sim.now + wait + 2 * eps)
        # the event clock is NOT clamped to the sim frontier: a settled
        # migration PUT may have pushed sim.now a few ms ahead, and
        # dragging every node's cadence forward with it would re-create
        # the convoy this driver exists to avoid.  advance() is a no-op
        # when the frontier is already ahead.
        t = min(cands)
        cluster.sim.advance(t)
        while i < len(reqs) and reqs[i].arrival_s <= t + eps:
            req = reqs[i]
            prefer = home.get(req.session) if session_affinity else None
            rank = cluster.submit(req, prefer=prefer) \
                if cluster.slo is not None else cluster.submit(req)
            if rank is not None and req.session >= 0:
                home[req.session] = rank
            i += 1
        cluster._drain_admission()
        for r in sorted(cluster.nodes):
            node = cluster.nodes[r]
            if busy[r] > t + eps or not has_work(node):
                continue
            eng = node.engine
            eng.step()
            tokens = (eng.window_decode_tokens
                      + eng.window_cold_prefill_tokens)
            end = t + t_tok * tokens
            for req in eng.window_first:
                if req.first_token_s is None:
                    req.first_token_s = end
            for req in eng.window_finished:
                # a request migrated off a node whose frontier ran ahead
                # of the hook clock can finish on a destination whose
                # frontier still trails its own first-token stamp; the
                # skew is bounded by one source window — clamp rather
                # than let the record claim a finish before the first
                # token
                req.finish_s = end if req.first_token_s is None \
                    else max(end, req.first_token_s)
                if qos_ctl is not None and len(req.out_tokens) > 1:
                    win_tpts.append((req.finish_s - req.first_token_s)
                                    / (len(req.out_tokens) - 1))
            eng.window_first = []
            eng.window_finished = []
            # a step that moved nothing (pool temporarily starved by an
            # inbound migration) polls again one token-time later rather
            # than busy-looping at the same instant
            busy[r] = end if tokens > 0 else t + t_tok
            steps += 1
        if (rebalance != "none" or qos_ctl is not None) \
                and t >= last_hook + hook_dt:
            last_hook = t
            if qos_ctl is not None:
                # controller first: a retune this window shapes the very
                # migrations the rebalancer is about to probe/price
                qos_ctl.window(cluster.sim, win_tpts)
                win_tpts = []
            if background is not None:
                background(cluster, t)
            if rebalance == "proactive":
                moves = cluster.rebalance_proactive()
            elif rebalance == "reactive":
                m = cluster.rebalance(threshold=rebalance_threshold)
                moves = [] if m is None else [m]
            else:
                moves = []
            if tel is not None:
                tel.add("replay.hooks")
                if moves:
                    tel.add("replay.rebalance_moves", float(len(moves)))
            for m in moves:
                # the destination resumes no earlier than the PUT's
                # contention-priced completion: the pages must land
                # before the migrated slot can decode — this is where
                # the fabric tier's pricing feeds back into the tail.
                # (The source's frontier is NOT inherited: that would
                # stall every request already on the destination for
                # one straggler's window; the bounded stamp skew is
                # clamped per-request at stamping time instead.)
                busy[m.dst] = max(busy[m.dst], t + m.modelled_s)
                if tel is not None:
                    tel.event(("cluster",), "rebalance", t,
                              rid=m.rid, src=m.src, dst=m.dst,
                              nbytes=float(m.nbytes))
            # the shared timeline outlives every window: drop settled
            # flows so probe snapshots stay O(in-flight), not O(uptime)
            cluster.sim.prune()
        if steps >= max_steps:
            raise TruncatedRunError(steps, cluster.in_flight)
    cluster.settle()
    if tel is not None:
        tel.collect(cluster.sim)   # route-cache gauges + final clock

    finished = cluster.finished
    ttfts = [r.first_token_s - r.arrival_s for r in finished
             if r.first_token_s is not None and r.arrival_s is not None]
    tpts = [(r.finish_s - r.first_token_s) / (len(r.out_tokens) - 1)
            for r in finished
            if r.finish_s is not None and r.first_token_s is not None
            and len(r.out_tokens) > 1]
    return ReplayReport(
        n_requests=len(trace),
        n_finished=len(finished),
        n_shed=len(cluster.shed),
        ttft_p50_s=_pct(ttfts, 50), ttft_p99_s=_pct(ttfts, 99),
        tpt_p50_s=_pct(tpts, 50), tpt_p99_s=_pct(tpts, 99),
        makespan_s=float(cluster.sim.now),
        steps=steps,
        n_migrations=len(cluster.migrations),
        migrated_bytes=sum(m.nbytes for m in cluster.migrations),
        wall_s=time.perf_counter() - t0)
