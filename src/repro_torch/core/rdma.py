"""RDMA host model on the torus — paper §1 (APEnet+ programming model).

APEnet+ exposes one-sided RDMA PUT/GET between nodes of the 3D torus.
``RdmaEndpoint`` is the host-side software stack of one card: buffer
*registration* through the §2.2 TLB (translation + pinning bookkeeping), a
command queue with a configurable number of in-flight slots (the §2.1 "dual
DMA engine" prefetchable queue), and a completion-cost model used by the
serving engine's page allocator.

A copy of the host half of the JAX package's ``core/rdma.py``.  The bulk
page transfers (``put_pages``, ``get_time``) wait for the serving-cluster
slice of the port, and the per-shard device primitives for the collectives
slice.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import apelink
from repro_torch.core.tlb import PAGE_BYTES, Tlb
from repro_torch.core.topology import Torus


@dataclasses.dataclass
class Region:
    handle: int
    vaddr: int
    nbytes: int


class RdmaEndpoint:
    """Software model of one node's APEnet+ card.

    * ``register`` pins a buffer and pre-translates its pages through the
      TLB (first touch = Nios II walk; later RDMA ops hit the HW TLB).
    * ``transfer_time`` models a PUT of ``nbytes`` with ``engines``
      concurrent DMA engines over the PCIe+link pipeline (Fig 1): with one
      engine the bus idles between a request's completion and the next
      issue; with two, requests overlap and the gap is hidden.
    """

    def __init__(self, torus: Torus, rank: int, *, tlb_entries: int = 512,
                 engines: int = 2, cq_slots: int | None = None,
                 net: apelink.NetModel | None = None) -> None:
        self.torus = torus
        self.rank = rank
        self.engines = engines
        # prefetchable command queue (§2.1): in-flight descriptor slots.
        # Two per engine by default — one draining, one prefetched — which
        # is what lets the second engine start without waiting for the
        # host.  ``fabric.estimate_overlapped`` consumes this as its
        # ``queue_depth``: depth 1 exposes the issue gap on every bucket.
        self.cq_slots = cq_slots if cq_slots is not None else 2 * engines
        if self.cq_slots < 1:
            raise ValueError(f"cq_slots must be >= 1, got {self.cq_slots}")
        self.tlb = Tlb(entries=tlb_entries)
        self.net = net or apelink.NetModel()
        self._regions: dict[int, Region] = {}
        self._next = 1
        self._next_vaddr = 1 << 20

    @property
    def queue_depth(self) -> int:
        """Command-queue depth feeding the fabric overlap model."""
        return self.cq_slots

    # -- registration ----------------------------------------------------------
    def register(self, nbytes: int) -> Region:
        region = Region(self._next, self._next_vaddr, nbytes)
        self._regions[self._next] = region
        self._next += 1
        # reserve at least one page: translate_region/deregister treat the
        # first page as owned even for zero-byte regions, so the address
        # space must too — otherwise a 0-byte region aliases the next
        # registration's vaddr and deregistering it would shoot down a
        # LIVE region's translations
        self._next_vaddr += (max(nbytes, 1) + PAGE_BYTES - 1) \
            // PAGE_BYTES * PAGE_BYTES
        return region

    def deregister(self, region: Region) -> None:
        """Unpin the region and shoot down its TLB entries.

        The sweep must cover exactly what translation can populate:
        ``translate_region`` walks ``max(nbytes, 1)`` bytes (a zero-byte
        region still owns its first page), so deregistering sweeps the
        same range — otherwise a stale translation for that page could
        hit after the region is gone.
        """
        del self._regions[region.handle]
        for off in range(0, max(region.nbytes, 1), PAGE_BYTES):
            self.tlb.invalidate(region.vaddr + off)

    def _check_registered(self, region: Region) -> None:
        """The region must be one THIS endpoint registered (a handle number
        alone can collide with another card's region)."""
        if self._regions.get(region.handle) is not region:
            raise KeyError("RDMA to a region this endpoint never registered")

    def translate_region(self, region: Region) -> float:
        """Translate every page of a region; returns modelled cost (s)."""
        self._check_registered(region)
        cost = 0.0
        for off in range(0, max(region.nbytes, 1), PAGE_BYTES):
            _, c = self.tlb.translate(region.vaddr + off)
            cost += c
        return cost

    # -- Fig 1 cost model --------------------------------------------------------
    def transfer_time(self, nbytes: int, *, engines: int | None = None,
                      max_payload: int = 4096,
                      t_issue: float = 0.2e-6,
                      t_completion_gap: float = 0.85e-6) -> float:
        """Total time to push ``nbytes`` through the PCIe DMA stage.

        Each PCIe read request costs a descriptor issue (``t_issue``, never
        hideable), moves ``max_payload`` bytes, and its completion arrives
        ``t_completion_gap`` after issue (system-dependent dead time, §2.1).
        A single engine serialises issue+gap+transfer — effective bandwidth
        ~50% of theoretical, as the paper observed; ``k`` engines keep k
        requests outstanding, hiding the gap whenever (k-1)*t_xfer >= gap.
        Calibration reproduces both §2.1 claims: single-engine efficiency
        ~0.5 and dual-engine total-time reduction ~40% (Fig 1).

        This is the *service time* of one DMA drain.
        """
        k = engines if engines is not None else self.engines
        nreq = max(1, (nbytes + max_payload - 1) // max_payload)
        t_xfer = max_payload / self.net.host_if.effective_bandwidth
        exposed_gap = max(0.0, t_completion_gap - (k - 1) * t_xfer)
        return nreq * (t_issue + t_xfer + exposed_gap)

    def put_time(self, dst: int, nbytes: int, region: Region) -> float:
        """End-to-end modelled PUT latency: translation + DMA + wire."""
        t = self.translate_region(region)
        t += self.transfer_time(nbytes)
        hops = self.torus.hop_distance(self.rank, dst)
        t += self.net.latency(nbytes, hops=hops)
        return t
