"""Schedule cost estimator — prices a ``CollectiveSchedule`` with the
APElink analytic model (``core.apelink.NetModel``).

One rule, applied uniformly: transfers inside a step ride disjoint link
directions concurrently (full duplex / dual DMA), so a step costs the MAX
of its transfers; steps are sequential rounds, so a schedule costs the SUM
of its steps.  Every transfer is priced as one ``NetModel.latency`` message
of ``frac * nbytes`` payload over its ``hops`` — the same model the paper's
Fig 3 curves come from, now attached to every collective for free.

This is the only place collective time is predicted; benchmarks and the
runtime report *this* number against measured wall time.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.apelink import NetModel
from repro_torch.core.fabric.schedule import BucketPlan, CollectiveSchedule


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    total_s: float
    phase_s: tuple[float, ...]       # per-phase breakdown, lowering order
    rounds: int                      # sequential ppermute rounds
    bytes_per_rank: float            # payload bytes each rank injects
    max_hops: int                    # worst detour in the schedule

    def __str__(self) -> str:
        return (f"{self.total_s * 1e6:.1f} us over {self.rounds} rounds "
                f"({self.bytes_per_rank / 1e6:.3f} MB/rank, "
                f"max {self.max_hops} hops)")


def message_time(nbytes: int, net: NetModel | None = None, *,
                 hops: int = 1, **endpoint_kw) -> float:
    """Single fabric message (the unit every step price is built from).

    A zero-byte message (pure sync step) prices header + latency only —
    injection, reception and the per-hop transits — with no phantom
    payload byte on the wire.
    """
    net = net or NetModel()
    return net.latency(max(int(nbytes), 0), hops=hops, **endpoint_kw)


def hostif_descriptors(nbytes: float,
                       descriptor_bytes: float) -> list[float]:
    """Byte sizes of the §2.1 prefetchable command-queue descriptors one
    host-IF DMA drain of ``nbytes`` splits into: full ``descriptor_bytes``
    chunks plus the partial tail, in issue order (sums to ``nbytes``
    exactly).  This is the preemption granularity of the host interface —
    a bulk drain occupies the host-IF FIFO one descriptor at a time, so a
    queued higher-class descriptor overtakes the *remaining* bulk
    descriptors instead of waiting out the whole PUT.  Shared by
    ``RdmaEndpoint.put_pages`` and the QoS controller benchmarks so both
    price the same split."""
    if descriptor_bytes <= 0:
        raise ValueError(
            f"descriptor_bytes must be > 0, got {descriptor_bytes}")
    if nbytes <= 0:
        return [max(nbytes, 0.0)]
    n = int(-(-nbytes // descriptor_bytes))
    out = [float(descriptor_bytes)] * (n - 1)
    out.append(float(nbytes) - (n - 1) * float(descriptor_bytes))
    return out


BACKENDS = ("analytic", "sim")
FIDELITIES = ("packet", "fluid", "hybrid")


def estimate(schedule: CollectiveSchedule, nbytes: int,
             net: NetModel | None = None, *, backend: str = "analytic",
             fidelity: str = "packet", cls=None,
             **endpoint_kw) -> CostEstimate:
    """Predicted completion time for the collective on an ``nbytes`` input
    (bytes of the per-rank input buffer, matching the transfers' ``frac``
    base).

    ``backend="analytic"`` (the fast path) prices every transfer in
    isolation with the closed-form model above; ``backend="sim"`` replays
    the schedule on the event-driven link-level simulator
    (``fabric.sim.simulate_schedule``) — same sequential-rounds rule, but
    messages become per-link packet walks with credit flow control, so
    transfers that share a link direction contend.  On single-flow
    schedules the two must agree (the ``tests/fabric_checks.py``
    differential); that agreement is the validation of both models.

    ``cls`` tags the traffic class (``fabric.qos.TrafficClass``) of the
    sim backend's flows; the analytic model ignores it — class weights
    only matter under contention, which the closed form never prices.

    ``fidelity`` selects the sim backend's simulator tier:
    ``"packet"`` (the bitwise oracle — the default), ``"fluid"``
    (flow-level rate allocation, O(flows) events — the fast path for
    large tori) or ``"hybrid"`` (fluid with packet-mode escalation of
    contended links).  The analytic backend ignores it.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown cost backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if fidelity not in FIDELITIES:
        raise ValueError(f"unknown sim fidelity {fidelity!r}; "
                         f"expected one of {FIDELITIES}")
    if backend == "sim":
        from repro_torch.core.fabric import sim as _sim
        if cls is not None:
            endpoint_kw["cls"] = cls
        return _sim.simulate_schedule(schedule, nbytes, net,
                                      fidelity=fidelity, **endpoint_kw)
    net = net or NetModel()
    phase_s = []
    for ph in schedule.phases:
        t = 0.0
        for st in ph.steps:
            if st.transfers:
                t += max(message_time(tr.frac * nbytes, net, hops=tr.hops,
                                      **endpoint_kw)
                         for tr in st.transfers)
        phase_s.append(t)
    return CostEstimate(total_s=sum(phase_s), phase_s=tuple(phase_s),
                        rounds=schedule.rounds,
                        bytes_per_rank=schedule.bytes_per_rank(nbytes),
                        max_hops=schedule.max_hops)


# ----------------------------------------------------------------------------
# overlap-aware estimate (the bucketed engine's timeline model)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OverlapEstimate:
    """Timeline of a bucketed, compute-overlapped schedule execution.

    The model is the schedule-level analogue of the paper's Fig 1 dual-DMA
    timeline: bucket i's collective can start once (a) its gradients exist
    (the backward compute segment feeding it finished) and (b) the fabric
    finished bucket i-1.  Comm that runs while backward compute is still in
    flight is *hidden*; whatever sticks out past the end of compute is
    *exposed* and is the only comm the step actually pays for.
    """

    total_s: float               # overlapped wall time (end of last bucket)
    sequential_s: float          # barrier baseline: compute + monolithic comm
    compute_s: float             # backward compute total
    comm_s: float                # sum of bucket wire times
    overhead_s: float            # exposed command-issue gaps (queue model)
    exposed_comm_s: float        # comm past the end of compute
    hidden_comm_s: float         # comm that ran under compute
    bucket_comm_s: tuple[float, ...]   # per-bucket wire time, issue order
    bucket_start_s: tuple[float, ...]  # per-bucket comm start on the timeline
    queue_depth: int

    @property
    def efficiency(self) -> float:
        """Fraction of fabric time hidden behind compute (1.0 = all)."""
        busy = self.hidden_comm_s + self.exposed_comm_s
        return self.hidden_comm_s / busy if busy > 0 else 1.0

    @property
    def reduction(self) -> float:
        """Total-time reduction vs the sequential barrier baseline."""
        if self.sequential_s <= 0:
            return 0.0
        return 1.0 - self.total_s / self.sequential_s

    def __str__(self) -> str:
        return (f"overlapped {self.total_s * 1e3:.3f} ms vs sequential "
                f"{self.sequential_s * 1e3:.3f} ms "
                f"({self.reduction * 100:.1f}% cut; "
                f"{self.hidden_comm_s * 1e3:.3f} ms comm hidden, "
                f"{self.exposed_comm_s * 1e3:.3f} ms exposed)")


def estimate_overlapped(schedule: CollectiveSchedule,
                        buckets: BucketPlan | Sequence[int],
                        compute_s: float | Sequence[float],
                        net: NetModel | None = None, *,
                        queue_depth: int = 2,
                        issue_gap_s: float = 0.85e-6,
                        backend: str = "analytic",
                        fidelity: str = "packet",
                        cls=None, **endpoint_kw) -> OverlapEstimate:
    """Price a bucketed, compute-overlapped execution of ``schedule``.

    ``buckets`` is a ``BucketPlan`` (or raw per-bucket byte counts) in
    issue order; ``compute_s`` is the backward compute trace — either one
    per-bucket segment each (segment i must finish before bucket i's grads
    exist) or a scalar total split proportionally to bucket bytes.

    ``queue_depth`` is the RDMA command queue's in-flight slots
    (``RdmaEndpoint.queue_depth``): with >= 2 slots the next bucket's
    command is prefetched while the fabric is busy, hiding the issue gap
    exactly like the second DMA engine of §2.1; a depth-1 queue pays
    ``issue_gap_s`` per bucket.  The sequential baseline is the monolithic
    post-backward barrier: all compute, then ONE schedule moving the whole
    payload.  ``backend`` (and, for the sim backend, ``fidelity``) selects
    how each bucket's wire time is priced (see ``estimate``); the timeline
    algebra on top is backend-agnostic.
    """
    net = net or NetModel()
    nbytes = (tuple(buckets.bucket_nbytes)
              if isinstance(buckets, BucketPlan) else tuple(buckets))
    if queue_depth < 1:
        raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
    nb = len(nbytes)
    if isinstance(compute_s, (int, float)):
        total = sum(nbytes)
        comp = (tuple(float(compute_s) * b / total for b in nbytes)
                if total > 0 else tuple(0.0 for _ in nbytes))
    else:
        comp = tuple(float(c) for c in compute_s)
        if len(comp) != nb:
            raise ValueError(
                f"compute trace has {len(comp)} segments for {nb} buckets")
    comm = tuple(estimate(schedule, b, net, backend=backend,
                          fidelity=fidelity, cls=cls, **endpoint_kw).total_s
                 for b in nbytes)
    compute_total = sum(comp)
    t = 0.0            # fabric busy-until
    elapsed = 0.0      # compute frontier
    starts, gaps = [], []
    for c_seg, m_s in zip(comp, comm):
        elapsed += c_seg           # this bucket's grads exist now
        if queue_depth >= 2 and t > elapsed:
            start, gap = t, 0.0    # command was prefetched while fabric busy
        else:
            start = max(t, elapsed) + issue_gap_s
            gap = issue_gap_s      # fabric idle at issue: gap is exposed
        starts.append(start)
        gaps.append(gap)
        t = start + m_s
    total_s = max(t, compute_total)
    exposed = total_s - compute_total
    busy = sum(comm) + sum(gaps)
    hidden = max(0.0, busy - exposed)
    seq = (compute_total + issue_gap_s
           + estimate(schedule, sum(nbytes), net, backend=backend,
                      fidelity=fidelity, cls=cls, **endpoint_kw).total_s
           if nbytes else compute_total)
    return OverlapEstimate(
        total_s=total_s, sequential_s=seq, compute_s=compute_total,
        comm_s=sum(comm), overhead_s=sum(gaps), exposed_comm_s=exposed,
        hidden_comm_s=hidden, bucket_comm_s=comm,
        bucket_start_s=tuple(starts), queue_depth=queue_depth)


def algorithmic_bandwidth(schedule: CollectiveSchedule, nbytes: int,
                          net: NetModel | None = None) -> float:
    """Collective goodput: input bytes / predicted time (bytes/s)."""
    t = estimate(schedule, nbytes, net).total_s
    return nbytes / t if t > 0 else float("inf")
