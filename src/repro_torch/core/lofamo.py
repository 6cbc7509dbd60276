"""LO|FA|MO — LOcal FAult MOnitor, paper §4 (Fig 4).

A lightweight mutual-watchdog protocol between each host and its NIC, plus
fault diffusion over the 3D torus, yielding *global* fault awareness at a
master node with no impact on data-transfer latency (diagnostic messages are
hidden in the communication protocol).

This module is a deterministic discrete-time simulator of that protocol, used

* by the fault-tolerant trainer (`repro_torch.runtime.trainer`) to decide
  when to checkpoint-restart / re-mesh,
* by `benchmarks/lofamo.py` to reproduce the paper's awareness-time claim
  (Ta ~= 0.9 s at WD = 500 ms),
* by property tests: any fault pattern whose victims retain >= 1 live
  first-neighbour is detected, and detection reaches the master whenever the
  survivor graph is connected ("no area of the mesh can be isolated and no
  fault can remain undetected at global level").

Protocol model (one simulation tick = ``wd_period`` seconds, matching the
paper's watchdog granularity; sub-period phases are accounted analytically):

  * every live HOST increments its Host Watchdog Register each period;
  * every live NIC checks the host counter each period; a stale counter
    ⇒ ``HOST_FAULT`` raised locally;
  * every live NIC exchanges a status word with its torus neighbours each
    period (piggybacked on protocol traffic — zero added latency); a missing
    status word ⇒ ``NODE_FAULT`` recorded *about that neighbour*;
  * every live HOST reads its NIC's watchdog registers each period and
    forwards news to the MASTER over the service network (latency ~ ms,
    negligible vs. WD).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable

from repro_torch.core.topology import Torus


class Health(enum.Enum):
    OK = 0
    HOST_FAULT = 1    # host stopped updating its watchdog register
    NODE_FAULT = 2    # whole node (NIC included) unreachable
    LINK_FAULT = 3    # a torus link died; both endpoints still alive


@dataclasses.dataclass
class WatchdogRegisters:
    """The per-node LO|FA|MO register file (paper: 'a set of LO|FA|MO
    watchdog registers')."""

    host_counter: int = 0          # Host WD register (host increments)
    nic_counter: int = 0           # APEnet WD register (NIC increments)
    last_seen_host: int = -1       # NIC-side shadow of host_counter
    stale_reads: int = 0           # consecutive NIC reads w/o host progress
    self_status: Health = Health.OK
    # status the NIC holds about each first neighbour rank -> Health
    neighbor_status: dict[int, Health] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FaultEvent:
    rank: int
    kind: Health
    t_fault: float                 # injection time (s)
    t_local: float | None = None   # local awareness (own/neighbour NIC)
    t_master: float | None = None  # global awareness at master

    @property
    def awareness_time(self) -> float | None:
        if self.t_master is None:
            return None
        return self.t_master - self.t_fault


@dataclasses.dataclass
class LinkFaultEvent:
    pair: tuple[int, int]          # undirected link (lo, hi)
    t_fault: float
    t_master: float | None = None  # master classifies the pair as LINK_FAULT
    kind: Health = Health.LINK_FAULT

    @property
    def awareness_time(self) -> float | None:
        if self.t_master is None:
            return None
        return self.t_master - self.t_fault


class LofamoSim:
    """Discrete-time simulation of LO|FA|MO over a torus."""

    def __init__(self, torus: Torus, wd_period: float = 0.5,
                 master: int = 0, service_latency: float = 1e-3) -> None:
        self.torus = torus
        self.wd = wd_period
        self.master = master
        self.service_latency = service_latency
        self.regs = {r: WatchdogRegisters() for r in torus.all_ranks()}
        for r in torus.all_ranks():
            self.regs[r].neighbor_status = {n: Health.OK
                                            for n in torus.neighbors(r)}
        self.host_dead: set[int] = set()
        self.node_dead: set[int] = set()
        self.link_dead: set[tuple[int, int]] = set()
        self.events: list[FaultEvent] = []
        self.link_events: list[LinkFaultEvent] = []
        self.master_view: dict[int, Health] = {r: Health.OK
                                               for r in torus.all_ranks()}
        # link faults the master has inferred: (lo, hi) -> awareness time
        self.master_links: dict[tuple[int, int], float] = {}
        self.t = 0.0

    # -- fault injection -------------------------------------------------------
    def kill_host(self, rank: int) -> FaultEvent:
        """Host hangs/crashes; NIC still alive (paper's Fig 4 scenario)."""
        ev = FaultEvent(rank, Health.HOST_FAULT, self.t)
        self.host_dead.add(rank)
        self.events.append(ev)
        return ev

    def kill_node(self, rank: int) -> FaultEvent:
        """Whole node dies (host + NIC): neighbours must detect it."""
        ev = FaultEvent(rank, Health.NODE_FAULT, self.t)
        self.host_dead.add(rank)
        self.node_dead.add(rank)
        self.events.append(ev)
        return ev

    def kill_link(self, a: int, b: int) -> tuple[int, int]:
        """One torus link dies; both endpoint nodes stay alive.

        Locally each endpoint's NIC stops receiving the other's status word
        and suspects a NODE_FAULT; the master disambiguates (companion work
        on APEnet+ fault awareness): a suspected node that itself keeps
        reporting over the service network is alive, so the fault must be
        the link between the pair.
        """
        if b not in self.torus.neighbors(a):
            raise ValueError(f"{a} and {b} are not torus neighbours")
        pair = (min(a, b), max(a, b))
        self.link_dead.add(pair)
        ev = LinkFaultEvent(pair, self.t)
        self.link_events.append(ev)
        return ev

    def _link_ok(self, a: int, b: int) -> bool:
        return (min(a, b), max(a, b)) not in self.link_dead

    # -- one watchdog period ---------------------------------------------------
    def step(self) -> None:
        t_end = self.t + self.wd
        # Phase 1: live hosts bump their watchdog register.
        for r, reg in self.regs.items():
            if r not in self.host_dead:
                reg.host_counter += 1
        # Phase 2: live NICs check their host and mark HOST_FAULT after two
        # consecutive stale reads (debounce: host update and NIC check run
        # unsynchronised, so one stale read is not yet a fault — this is why
        # the paper's Ta is ~1.8 x WD rather than ~1 x WD).
        for r, reg in self.regs.items():
            if r in self.node_dead:
                continue
            reg.nic_counter += 1
            if reg.host_counter == reg.last_seen_host:
                reg.stale_reads += 1
                if reg.stale_reads >= 2 and reg.self_status is Health.OK:
                    reg.self_status = Health.HOST_FAULT
                    self._mark_local(r, t_end)
            else:
                reg.stale_reads = 0
            reg.last_seen_host = reg.host_counter
        # Phase 3: live NICs exchange status words with torus neighbours
        # (diagnostic messages hidden in protocol traffic -> zero extra
        # latency on the data path).
        for r, reg in self.regs.items():
            if r in self.node_dead:
                continue
            for n in self.torus.neighbors(r):
                if n in self.node_dead or not self._link_ok(r, n):
                    # no status word arrives: locally indistinguishable from
                    # a dead neighbour node
                    if reg.neighbor_status.get(n) is not Health.NODE_FAULT:
                        reg.neighbor_status[n] = Health.NODE_FAULT
                        self._mark_local(n, t_end)
                else:
                    st = self.regs[n].self_status
                    reg.neighbor_status[n] = st
        # Phase 4: live hosts read NIC registers and report to the master
        # over the service network (plus a liveness heartbeat).  The master
        # disambiguates: a NODE_FAULT suspicion about a rank whose own host
        # still heartbeats must be the *link* between the pair.
        alive_hosts = {r for r in self.regs if r not in self.host_dead}
        for r, reg in self.regs.items():
            if r in self.host_dead:
                continue
            reports: list[tuple[int, Health]] = []
            if reg.self_status is not Health.OK:
                reports.append((r, reg.self_status))
            for n, st in reg.neighbor_status.items():
                if st is not Health.OK:
                    reports.append((n, st))
            for rank, st in reports:
                if st is Health.NODE_FAULT and rank in alive_hosts \
                        and rank != r:
                    pair = (min(r, rank), max(r, rank))
                    if pair not in self.master_links:
                        self.master_links[pair] = t_end + self.service_latency
                        for ev in self.link_events:
                            if ev.pair == pair and ev.t_master is None:
                                ev.t_master = self.master_links[pair]
                    continue
                if self.master_view.get(rank) is Health.OK:
                    self.master_view[rank] = st
                    self._mark_master(rank, t_end + self.service_latency)
        self.t = t_end

    def run(self, periods: int) -> None:
        for _ in range(periods):
            self.step()

    # -- bookkeeping -----------------------------------------------------------
    def _mark_local(self, rank: int, t: float) -> None:
        for ev in self.events:
            if ev.rank == rank and ev.t_local is None:
                ev.t_local = t

    def _mark_master(self, rank: int, t: float) -> None:
        for ev in self.events:
            if ev.rank == rank and ev.t_master is None:
                ev.t_master = t

    # -- queries ---------------------------------------------------------------
    def detected_at_master(self) -> set[int]:
        return {r for r, st in self.master_view.items() if st is not Health.OK}

    def detected_links_at_master(self) -> set[tuple[int, int]]:
        """Dead links the master has inferred (both endpoints still alive)."""
        return set(self.master_links)

    def all_detected(self, faults: Iterable[int] | None = None) -> bool:
        want = set(faults) if faults is not None else {e.rank for e in self.events}
        return want <= self.detected_at_master()


def awareness_time_model(wd_period: float, service_latency: float = 1e-3) -> float:
    """Analytic awareness time, dominated by the watchdog period (paper §4).

    A host fault is noticed when the NIC sees a *second* read of an unchanged
    counter; averaged over the fault phase within the period this costs
    1.8 x WD, plus the service-network report.  At the paper's operating
    point WD = 500 ms this gives Ta ~= 0.9 s (paper: "for a WD = 500 ms,
    Ta = 0.9 s").
    """
    return 1.8 * wd_period + service_latency
