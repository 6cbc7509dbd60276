"""Unified fabric telemetry: counter registry + event tracer + Perfetto export.

The APEnet+ board ships hardware performance counters and diagnostic
registers because a multi-hop RDMA fabric is undebuggable without
per-link, per-channel visibility (arXiv:1311.1741 §4; arXiv:2201.01088
extends the monitoring for fault diagnosis).  This module is the
software twin: ONE ``Telemetry`` hub that every dynamic subsystem —
packet/fluid/hybrid sims, the RDMA endpoint, the serving cluster, the
trace-replay driver, the closed-loop QoS controller, the trainer —
optionally reports into.

Two stores:

* a typed **counter/gauge registry** keyed ``(name, key, cls)`` —
  per-link-direction bytes / busy time / credit-stall time per traffic
  class, escape-credit loans and repayments, host-IF descriptor
  preemptions, restripes, probe counts, BFS-cache hits, queue waits,
  sheds, migrations, controller retunes;
* an **event/span tracer** with bounded ring-buffer storage — flow
  inject→drain spans, descriptor segments, controller windows,
  rebalance decisions, fault epochs — exported by :meth:`to_perfetto`
  as Chrome-trace JSON (one track per link direction / node /
  controller) loadable in ``ui.perfetto.dev`` or ``chrome://tracing``.

Invariants the rest of the stack depends on:

* **Disabled mode is bitwise-invisible.**  Every producer gates its
  hook on ``telemetry is not None`` (and on not being inside a probe
  journal); with the default ``telemetry=None`` no telemetry code runs
  on any hot path and every sim/replay timeline is bit-identical to a
  build without this module (gated at exactly 0 diff by
  ``benchmarks/telemetry.py``).
* **Counters mirror the sim's own float-addition order**, so
  :meth:`cross_check` against ``link_stats()`` is EXACT (0.0), not
  approximately-equal: per-key busy/bytes accumulate in the same order
  the sim adds to ``link.busy_s`` / ``_stats[key]``.
* **Probes are ghosts.**  Producers suppress hooks while a probe
  journal / ``_probing`` flag is active; only the deterministic
  top-level ``fabric.probes`` count is stamped after rollback.  A
  probed sim's counters and event ring match a never-probed control
  (same discipline as the PR-5 probe-ghost test).
* **Deterministic export.**  No wall-clock anywhere; timestamps are sim
  times, track ids are first-seen order, args are sorted — same seed
  produces a byte-identical ``.trace.json``.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Any, Iterable

__all__ = [
    "Telemetry",
    "ordered_link_items",
    "canon_key",
    "validate_perfetto",
]


# ----------------------------------------------------------------------------
# deterministic ordering over mixed-type keys
# ----------------------------------------------------------------------------

def canon_key(part: Any) -> Any:
    """Total order over the mixed key vocabulary of the fabric: wire
    keys ``(a, b, ch)`` are int tuples, resource keys are
    ``("hostif", rank)`` — Python can't compare ``int`` with ``str``,
    so every scalar maps to a (type-rank, value) pair and tuples map
    recursively.  Shared by both sim tiers' ``link_stats`` so the two
    schemas iterate in one deterministic order (satellite: metric-name
    drift fix)."""
    if isinstance(part, tuple):
        return (2, tuple(canon_key(p) for p in part))
    if isinstance(part, bool):
        return (1, str(part))
    if isinstance(part, (int, float)):
        return (0, float(part))
    if part is None:
        return (-1, 0.0)
    return (1, str(part))


def ordered_link_items(items: Iterable[tuple[Any, Any]]) -> list[tuple[Any, Any]]:
    """Sort ``link_stats``-style ``(key, stats)`` pairs into the one
    canonical order both sim tiers share."""
    return sorted(items, key=lambda kv: canon_key(kv[0]))


def _json_safe(v: Any) -> Any:
    """Coerce event args to JSON-stable scalars (tuples/lists become
    their compact str repr — routes, stripe plans)."""
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, (int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return "(" + ",".join(str(_json_safe(x)) for x in v) + ")"
    return str(v)


def _track_label(track: tuple) -> str:
    """Human-readable Perfetto thread name for a track tuple."""
    kind = track[0] if track else "?"
    rest = track[1:]
    if kind == "link" and rest:
        key = rest[0]
        if isinstance(key, tuple) and len(key) == 3 and all(
                isinstance(p, int) for p in key):
            a, b, ch = key
            return f"link {a}->{b} vc{ch}"
        return f"link {key}"
    if kind == "node" and rest:
        key = rest[0]
        if isinstance(key, tuple):   # resource key like ("hostif", rank)
            return " ".join(str(p) for p in key)
        return f"node {key}"
    if kind == "rdma" and rest:
        return f"rdma rank{rest[0]}"
    if kind == "controller":
        return "qos controller"
    if kind == "cluster":
        return "cluster"
    return " ".join(str(p) for p in track)


# ----------------------------------------------------------------------------
# the hub
# ----------------------------------------------------------------------------

class Telemetry:
    """Counter/gauge registry + bounded event ring, shared by every
    subsystem that accepts ``telemetry=``.

    ``ring`` bounds event storage (a deque; oldest spans drop first —
    ``n_events``/``dropped`` record the total and the loss so a
    truncated trace is never silently mistaken for a complete one).
    Counters are unbounded but small: one float per (name, key, class)
    label actually touched.
    """

    def __init__(self, *, ring: int = 65536) -> None:
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        self.ring = ring
        # (name, key, cls) -> float.  key/cls None = scalar counter.
        self.counters: dict[tuple, float] = {}
        # (ts, track, name, dur, ((k, v), ...)) — ts/dur in sim seconds
        self.events: deque = deque(maxlen=ring)
        self.n_events = 0
        # hub-side derived state — NEVER stored on a sim object, so
        # attaching a hub cannot perturb sim behavior or snapshots:
        self._stall_from: dict = {}   # link key -> credit-block start
        self._last_cls: dict = {}     # resource key -> last class served

    # -- registry ------------------------------------------------------------
    def add(self, name: str, value: float = 1.0, *,
            key: Any = None, cls: int | None = None) -> None:
        """Accumulate ``value`` into the counter labelled
        ``(name, key, cls)``."""
        label = (name, key, cls)
        self.counters[label] = self.counters.get(label, 0.0) + value

    def set_gauge(self, name: str, value: float, *,
                  key: Any = None, cls: int | None = None) -> None:
        """Overwrite a gauge (last-write-wins; cache sizes, hit rates)."""
        self.counters[(name, key, cls)] = float(value)

    def value(self, name: str, *, key: Any = None,
              cls: int | None = None) -> float:
        return self.counters.get((name, key, cls), 0.0)

    def counters_snapshot(self) -> dict[str, float]:
        """Flat ``{label: value}`` view with deterministic label
        strings and ordering — the comparison surface for the probe-
        ghost and invisibility tests."""
        out: dict[str, float] = {}
        for (name, key, cls), v in sorted(
                self.counters.items(),
                key=lambda kv: (kv[0][0], canon_key(kv[0][1]),
                                -1 if kv[0][2] is None else kv[0][2])):
            label = name
            if key is not None:
                label += f"@{key}"
            if cls is not None:
                label += f"#c{cls}"
            out[label] = v
        return out

    # -- tracer --------------------------------------------------------------
    def event(self, track: tuple, name: str, ts: float,
              dur: float = 0.0, **args: Any) -> None:
        """Record one span (``dur > 0``) or instant (``dur == 0``) on
        ``track`` at sim time ``ts`` seconds."""
        packed = tuple(sorted((k, _json_safe(v)) for k, v in args.items()))
        self.events.append((float(ts), track, name, float(dur), packed))
        self.n_events += 1

    @property
    def dropped(self) -> int:
        """Events lost to the ring bound."""
        return self.n_events - len(self.events)

    def events_snapshot(self) -> tuple:
        return tuple(self.events)

    # -- sim fast-path hooks -------------------------------------------------
    # Each mirrors the sim's own accounting EXACTLY (same float-addition
    # order per key), so cross_check() is exact.  Producers gate the
    # call on `telemetry is not None and <not probing>`; the hooks
    # themselves never touch sim state.

    def on_link_tx(self, key: Any, cls: int, nbytes: float, dur: float,
                   start: float, resource: bool) -> None:
        """Packet tier: one packet/occupancy started service on link or
        host-IF resource ``key`` (mirrors ``_try_start`` accounting)."""
        self.add("link.busy_s", dur, key=key)
        self.add("link.bytes", nbytes, key=key)
        self.add("link.bytes", nbytes, key=key, cls=cls)
        self.add("link.busy_s", dur, key=key, cls=cls)
        if resource:
            last = self._last_cls.get(key)
            if last is not None and last != cls:
                # a different class took the host interface at a
                # descriptor boundary — the §2.1 preemption event
                self.add("hostif.preemptions")
            self._last_cls[key] = cls
        else:
            t0 = self._stall_from.pop(key, None)
            if t0 is not None and start > t0:
                # credit-blocked interval ends at this tx's start;
                # attribute the stall to the class that finally went
                self.add("link.credit_stall_s", start - t0, key=key, cls=cls)

    def on_credit_block(self, key: Any, now: float) -> None:
        """Packet tier: arbiter found every backlogged channel on
        ``key`` credit-blocked at ``now`` (start of a stall window)."""
        self._stall_from.setdefault(key, now)
        self.add("link.credit_blocks", key=key)

    def on_escape_loan(self, key: Any, cls: int, need: int) -> None:
        """Packet tier: deadlock-recovery escape-credit loan on ``key``
        channel ``cls`` — repaid in the same call by construction, so
        loans and repayments move in lockstep (invariant-tested)."""
        self.add("escape.loans")
        self.add("escape.loan_credits", float(need))
        self.add("escape.repayments")

    def on_flow_drain(self, link_keys: Iterable[Any], cls: int,
                      nbytes: float, busy: float) -> None:
        """Fluid tier: a flow drained — mirrors ``_drain``'s per-key
        stats loop in the same key order."""
        for key in link_keys:
            self.add("link.busy_s", busy, key=key)
            self.add("link.bytes", nbytes, key=key)
            self.add("link.bytes", nbytes, key=key, cls=cls)
            self.add("link.busy_s", busy, key=key, cls=cls)

    def on_resource_busy(self, key: Any, service_s: float,
                         cls: int) -> None:
        """Fluid tier: a flow's host-IF occupancy activated — mirrors
        ``_activate``'s resource accounting."""
        self.add("link.busy_s", service_s, key=key)
        self.add("link.busy_s", service_s, key=key, cls=cls)
        last = self._last_cls.get(key)
        if last is not None and last != cls:
            self.add("hostif.preemptions")
        self._last_cls[key] = cls

    def flow_span(self, track: tuple, name: str, start: float,
                  finish: float, **args: Any) -> None:
        """Convenience: inject→drain span of one flow on ``track``."""
        self.event(track, name, start, max(finish - start, 0.0), **args)

    # -- pull-based gauges ---------------------------------------------------
    def collect(self, sim: Any = None) -> None:
        """Pull module-level route-cache gauges (and optional per-sim
        totals) into the registry.  Explicit, not hot-path: the route
        caches are free functions shared by every sim, so their stats
        live in a module counter dict that this copies in as gauges."""
        from . import sim as _simmod   # local import avoids a cycle
        for k, v in sorted(_simmod.ROUTE_CACHE_STATS.items()):
            self.set_gauge(f"route_cache.{k}", float(v))
        if sim is not None:
            self.set_gauge("sim.now", float(getattr(sim, "now", 0.0)))

    # -- verification --------------------------------------------------------
    def cross_check(self, sim: Any) -> float:
        """Max absolute difference between this hub's per-link counters
        and the sim's own ``link_stats()``.  EXACTLY 0.0 when the hub
        was attached at construction: both sides added the same floats
        in the same order.  (Gated at 0 by ``benchmarks/telemetry.py``.)"""
        worst = 0.0
        for key, st in sim.link_stats().items():
            worst = max(worst, abs(st["busy_s"]
                                   - self.value("link.busy_s", key=key)))
            worst = max(worst, abs(st["bytes"]
                                   - self.value("link.bytes", key=key)))
            for c, b in enumerate(st["class_bytes"]):
                worst = max(worst, abs(b - self.value("link.bytes",
                                                      key=key, cls=c)))
        return worst

    # -- export --------------------------------------------------------------
    def to_perfetto(self) -> str:
        """Chrome-trace JSON (the legacy JSON format Perfetto ingests):
        one pid, one tid per track (first-seen order), ``M`` metadata
        rows naming each track, ``X`` complete events for spans, ``i``
        instants for point events.  ts/dur in microseconds.  Fully
        deterministic — same seed, byte-identical file."""
        tids: dict[tuple, int] = {}
        trace_events: list[dict] = []
        for ts, track, name, dur, args in self.events:
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
            ev: dict[str, Any] = {
                "pid": 0, "tid": tid, "name": name,
                "cat": str(track[0]) if track else "event",
                "ts": round(ts * 1e6, 3),
            }
            if args:
                ev["args"] = dict(args)
            if dur > 0.0:
                ev["ph"] = "X"
                ev["dur"] = round(dur * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            trace_events.append(ev)
        meta = [{"pid": 0, "tid": tid, "ph": "M", "name": "thread_name",
                 "args": {"name": _track_label(track)}}
                for track, tid in tids.items()]
        obj = {"displayTimeUnit": "ms",
               "traceEvents": meta + trace_events}
        return json.dumps(obj, sort_keys=True, separators=(",", ":"))

    def summary_table(self, *, top: int = 24) -> str:
        """Plain-text counter summary — the ``scripts/fabric_trace.py``
        stdout report."""
        snap = self.counters_snapshot()
        scalars = {k: v for k, v in snap.items() if "@" not in k}
        labelled = {k: v for k, v in snap.items() if "@" in k}
        lines = ["== telemetry summary =="]
        lines.append(f"events: {self.n_events} recorded, "
                     f"{self.dropped} dropped (ring={self.ring})")
        for k, v in scalars.items():
            lines.append(f"  {k:<32s} {v:>14.6g}")
        busiest = sorted(
            ((k, v) for k, v in labelled.items()
             if k.startswith("link.busy_s@") and "#c" not in k),
            key=lambda kv: (-kv[1], kv[0]))[:top]
        if busiest:
            lines.append(f"  -- busiest links (top {len(busiest)}) --")
            for k, v in busiest:
                lines.append(f"  {k:<40s} {v:>12.6g} s")
        return "\n".join(lines)


# ----------------------------------------------------------------------------
# trace-file schema validation (scripts/fabric_trace.py --validate)
# ----------------------------------------------------------------------------

def validate_perfetto(obj: Any) -> list[str]:
    """Hand-rolled Chrome-trace JSON schema check (no jsonschema dep).
    Returns a list of violations; empty = valid."""
    errs: list[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing or non-list 'traceEvents'"]
    named_tids: set = set()
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            errs.append(f"{where}: bad ph {ph!r}")
            continue
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                errs.append(f"{where}: missing int {field!r}")
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errs.append(f"{where}: missing name")
        if ph == "M":
            args = ev.get("args")
            if not (isinstance(args, dict)
                    and isinstance(args.get("name"), str)):
                errs.append(f"{where}: metadata row lacks args.name")
            else:
                named_tids.add((ev.get("pid"), ev.get("tid")))
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: complete event with bad dur {dur!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            errs.append(f"{where}: non-object args")
    for i, ev in enumerate(evs):
        if isinstance(ev, dict) and ev.get("ph") in ("X", "i"):
            ident = (ev.get("pid"), ev.get("tid"))
            if ident not in named_tids:
                errs.append(f"traceEvents[{i}]: tid {ident} has no "
                            "thread_name metadata row")
                break   # one unnamed tid implies many; report once
    return errs
