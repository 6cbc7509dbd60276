"""QoS traffic classes for the fabric timeline — virtual channels with
class-weighted arbitration and partitioned credits.

The APEnet+ router arbitrates several traffic sources onto each torus
link with dedicated per-channel resources (arXiv:1102.3796 §2; the 28 nm
follow-up extends the switch/arbiter datapath).  On the shared serving +
training fabric this repo models, that hardware fact is what makes
co-location viable: a bulk KV-page migration must not be able to starve
the latency-critical decode-step collectives it shares links with.

This module defines the *policy* half of the subsystem; the mechanism (a
per-class virtual-channel queue on every directed link, drained by a
weighted arbiter with per-class credit partitions) lives in
``fabric.sim.FabricSim``.

  ``TrafficClass``  — who is sending: ``CONTROL`` (descriptors, LO|FA|MO
                      diagnostics), ``DECODE`` (serving per-step tensor-
                      parallel collectives), ``COLLECTIVE`` (trainer
                      gradient buckets), ``BULK`` (KV-page migration,
                      checkpoint streams).
  ``QosPolicy``     — per-class arbitration weight (bandwidth share under
                      contention is weight-proportional) and per-class
                      fraction of each link's ~40 KB credit pool, so one
                      class's backpressure can never exhaust another's
                      credits.

``QosPolicy(single_class=True)`` collapses every class onto ONE virtual
channel with the whole credit pool — exactly the pre-QoS FIFO link, kept
as a config so the sim/analytic differential (and any consumer that wants
the old behaviour) reproduces those results bitwise.  ``FabricSim``
defaults to it.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping


class TrafficClass(enum.IntEnum):
    """Fabric traffic classes, one virtual channel each (arbiter order is
    by enum value only for deterministic tie-breaks, not priority)."""

    CONTROL = 0      # RDMA GET descriptors, sync/diagnostic messages
    DECODE = 1       # serving decode-step TP collectives (latency-critical)
    COLLECTIVE = 2   # trainer gradient buckets / bulk collectives
    BULK = 3         # KV-page migration, checkpoint and data streams


# Default arbitration weights: under contention a class's share of a
# saturated link is weight / sum(weights of backlogged classes).  DECODE
# at 16x BULK bounds the decode stretch under full bulk interference at
# ~17/16 (< the 1.10x acceptance bar); CONTROL is tiny traffic that must
# never queue behind payloads; COLLECTIVE sits between.
DEFAULT_WEIGHTS: dict[TrafficClass, float] = {
    TrafficClass.CONTROL: 4.0,
    TrafficClass.DECODE: 16.0,
    TrafficClass.COLLECTIVE: 8.0,
    TrafficClass.BULK: 1.0,
}

# Default credit partition: fraction of each link's credit pool (the
# ~40 KB bandwidth-delay product, ``apelink.channel_footprint_bytes``)
# reserved per class.  A congested BULK flow can fill at most its own
# partition of a downstream buffer — DECODE's window survives untouched.
DEFAULT_CREDIT_FRAC: dict[TrafficClass, float] = {
    TrafficClass.CONTROL: 0.10,
    TrafficClass.DECODE: 0.40,
    TrafficClass.COLLECTIVE: 0.30,
    TrafficClass.BULK: 0.20,
}


@dataclasses.dataclass(frozen=True)
class QosPolicy:
    """Arbitration weights + credit partition for the link virtual channels.

    ``weights``/``credit_frac`` may list any subset of ``TrafficClass``;
    unlisted classes keep their defaults.  ``single_class=True`` ignores
    both and reproduces the pre-QoS FIFO link exactly (one channel, one
    undivided credit pool) — the backwards-compatibility config the
    sim/analytic differential runs under.
    """

    weights: Mapping[TrafficClass, float] = dataclasses.field(
        default_factory=dict)
    credit_frac: Mapping[TrafficClass, float] = dataclasses.field(
        default_factory=dict)
    single_class: bool = False

    def __post_init__(self) -> None:
        for name, mapping, defaults in (
                ("weights", self.weights, DEFAULT_WEIGHTS),
                ("credit_frac", self.credit_frac, DEFAULT_CREDIT_FRAC)):
            merged = dict(defaults)
            for k, v in dict(mapping).items():
                k = TrafficClass(k)
                if v <= 0:
                    raise ValueError(
                        f"{name}[{k.name}] must be > 0, got {v}")
                merged[k] = float(v)
            object.__setattr__(self, name, merged)

    # -- class identity -------------------------------------------------------
    @property
    def n_classes(self) -> int:
        """Virtual channels per link (1 when single_class)."""
        return 1 if self.single_class else len(TrafficClass)

    def class_index(self, cls: TrafficClass | int | None) -> int:
        """Virtual-channel index of a traffic class under this policy."""
        if self.single_class or cls is None:
            return 0
        return int(TrafficClass(cls))

    # -- arbiter parameters ---------------------------------------------------
    def weight_vector(self) -> tuple[float, ...]:
        """Per-channel arbitration weights, channel-index order."""
        if self.single_class:
            return (1.0,)
        return tuple(self.weights[c] for c in TrafficClass)

    def partition_credits(self, total: float) -> tuple[float, ...]:
        """Split one link's credit pool across the virtual channels.

        Fractions are normalized so the partitions always sum to the full
        pool; ``single_class`` keeps it undivided."""
        if self.single_class:
            return (float(total),)
        fracs = [self.credit_frac[c] for c in TrafficClass]
        norm = sum(fracs)
        return tuple(float(total) * f / norm for f in fracs)

    def describe(self) -> str:
        if self.single_class:
            return "QosPolicy(single_class=True): one FIFO channel"
        lines = ["QosPolicy: weight / credit fraction per class"]
        norm = sum(self.credit_frac[c] for c in TrafficClass)
        for c in TrafficClass:
            lines.append(f"  {c.name:<10s} w={self.weights[c]:g} "
                         f"credit={self.credit_frac[c] / norm:.2%}")
        return "\n".join(lines)


#: The legacy configuration: every flow on one FIFO virtual channel with
#: the whole credit pool — bitwise the pre-QoS ``FabricSim``.
SINGLE_CLASS = QosPolicy(single_class=True)
