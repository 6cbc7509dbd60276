"""RDMA host model on the torus — paper §1 (APEnet+ programming model).

APEnet+ exposes one-sided RDMA PUT/GET between nodes of the 3D torus.
``RdmaEndpoint`` is the host-side software stack of one card: buffer
*registration* through the §2.2 TLB (translation + pinning bookkeeping), a
command queue with a configurable number of in-flight slots (the §2.1 "dual
DMA engine" prefetchable queue), a completion-cost model used by the
serving engine's page allocator, and the bulk page transfers of KV-page
migration (``put_pages``, ``get_time``), priced in closed form or on a
shared fabric simulator.

A copy of the host half of the JAX package's ``core/rdma.py``, and its
device half as per-rank primitives over a ``Mesh``
(``repro_torch.launch.mesh``): ``put_shift``, ``put_coords`` and
``send_recv`` are lists of ``dist.P2POp`` run by
``dist.batch_isend_irecv`` — a neighbour put inside the axis line's
process group, where JAX's are ``lax.ppermute`` inside ``shard_map``.  A
multi-hop transfer is a chain of neighbour puts following the
dimension-ordered route, like the APEnet+ router's store-and-forward.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import apelink
from repro_torch.core.fabric.execute import ppermute_round
from repro_torch.core.fabric.qos import TrafficClass
from repro_torch.core.tlb import PAGE_BYTES, Tlb
from repro_torch.core.topology import Torus


# ----------------------------------------------------------------------------
# per-rank device primitives (torch.distributed point-to-point)
# ----------------------------------------------------------------------------

def put_shift(x: torch.Tensor, axis_name: str, mesh,
              step: int = +1) -> torch.Tensor:
    """One-sided put to the ring neighbour at signed offset ``step``.

    Multi-hop |step| is realised as |step| single-hop writes (neighbour
    links are the only physical channels on the torus)."""
    n = mesh.shape[axis_name]
    hop = +1 if step >= 0 else -1
    perm = [(i, (i + hop) % n) for i in range(n)]
    for _ in range(abs(step)):
        (x,) = ppermute_round([(x, perm)], axis_name, mesh)
    return x


def put_coords(x: torch.Tensor, axis_names: Sequence[str], mesh,
               delta: Sequence[int]) -> torch.Tensor:
    """Dimension-ordered multi-axis put: shift by ``delta[i]`` hops along
    ``axis_names[i]``, X first then Y then Z (the APEnet+ routing order)."""
    if len(axis_names) != len(delta):
        raise ValueError("axis/delta arity mismatch")
    for ax, d in zip(axis_names, delta):
        if d:
            x = put_shift(x, ax, mesh, d)
    return x


def send_recv(x: torch.Tensor, axis_name: str, mesh,
              pairs: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Explicit (src, dst) one-sided writes; ranks not addressed receive
    zeros (RDMA semantics: untouched remote memory, here a fresh buffer)."""
    (out,) = ppermute_round([(x, list(pairs))], axis_name, mesh)
    return out


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
                 net: apelink.NetModel | None = None,
                 sim: "object | None" = None,
                 descriptor_bytes: float | None = None,
                 telemetry: "object | None" = None) -> None:
        self.torus = torus
        self.rank = rank
        self.engines = engines
        # §2.1 per-class command queues: with ``descriptor_bytes`` set and
        # a shared sim attached, put_pages occupies the host-IF FIFO as a
        # CHAIN of descriptor-granular occupancies instead of one
        # monolithic drain, so a queued higher-class descriptor (a decode
        # collective's DMA) overtakes the remaining bulk descriptors at
        # the next boundary instead of waiting out the whole PUT.  The
        # default None keeps the monolithic drain — bitwise identical to
        # the pre-descriptor timeline.
        self.descriptor_bytes = (float(descriptor_bytes)
                                 if descriptor_bytes else None)
        if self.descriptor_bytes is not None and self.descriptor_bytes <= 0:
            raise ValueError(
                f"descriptor_bytes must be > 0, got {descriptor_bytes}")
        # shared fabric timeline: when attached, put_pages/get_time inject
        # their host-IF DMA drain and wire legs as flows on it instead of
        # summing closed-form terms, so concurrent operations — this
        # card's or any other card sharing the sim — contend for links and
        # host-interface slots.  Any ``fabric.make_sim`` fidelity tier
        # works (the surface is duck-typed): the packet ``FabricSim``
        # oracle, or ``FluidSim``/``HybridSim`` for big clusters.
        # None = closed-form.
        self.sim = sim
        self.last_put_report: dict | None = None
        # optional Telemetry hub (the card's "hardware counters"): PUT /
        # GET / descriptor tallies + one span per PUT on this rank's
        # track.  Reporting only — None is bitwise-invisible.
        self.telemetry = telemetry
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

        This is the *service time* of one DMA drain.  With a shared
        ``FabricSim`` attached, ``put_pages``/``get_time`` do not add it
        as a closed-form term: they occupy the card's host-interface FIFO
        resource (``("hostif", rank)``) on the shared timeline for this
        duration, so concurrent operations on one card queue behind each
        other.
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

    # -- bulk region-to-region transfers (KV-page migration) --------------------
    def put_pages(self, dst: int, region: Region, pages: Sequence[int], *,
                  page_nbytes: int = PAGE_BYTES,
                  dst_endpoint: "RdmaEndpoint | None" = None,
                  dst_region: Region | None = None,
                  dst_pages: Sequence[int] | None = None,
                  faults=None, schedule=None, stripes=None,
                  restripe_s: float | None = None,
                  cls: TrafficClass = TrafficClass.BULK) -> float:
        """Bulk one-sided PUT of selected ``page_nbytes``-sized pages of a
        registered region to rank ``dst``; returns the modelled seconds.

        The wire leg is a ``fabric.lower_p2p`` schedule priced by
        ``fabric.estimate`` — multi-hop dimension-ordered unicast on a
        healthy fabric, the BFS detour of the same schedule under a
        ``FaultMap`` (pass ``faults``), ``UnroutableError`` when the map
        partitions the fabric.  A caller that already lowered the route
        (e.g. for hop reporting) passes it as ``schedule`` to skip the
        re-derivation.  On top of the wire: TX-side translation of
        every TLB granule the pages span (§2.2 — hot after registration)
        and the host-interface DMA drain (§2.1 dual-engine model).  When
        the caller hands over the receiving card (``dst_endpoint`` +
        ``dst_region`` [+ ``dst_pages``]), the RX-side translation of the
        landing byte range is charged to *its* TLB — the §2.2 critical
        path of the receive DMA.  (Per-``PAGE_BYTES``-granule, the same
        model as ``translate_region``; the serving allocator's
        one-entry-per-KV-page registration shortcut is separate and
        coarser.)

        **Multi-path striping**: pass ``stripes`` — a sequence of
        ``(schedule, nbytes)`` legs whose bytes sum to the payload — to
        split the PUT across several routes at once (the serving
        cluster's ``route_policy="striped"``).  The legs leave one DMA
        drain together and fly concurrently; the receiver cannot hand the
        pages over until every stripe has landed AND its reorder window
        has matched the out-of-order completions, modelled as one extra
        ``t_receive`` per additional stripe.  ``cls`` tags every timeline
        leg's traffic class (default ``BULK`` — a migration must not
        starve decode on a QoS fabric).

        **Mid-flight re-striping**: with a shared sim attached, pass
        ``restripe_s`` (seconds after the DMA drain) to set a checkpoint:
        the timeline runs to it, each leg's unsent remainder is re-probed
        against the *current* congestion (``fabric.striped_routes``) and
        re-split across the fresh plan — in-flight packets keep their
        per-packet route tags, only the uncommitted remainder moves.  A
        leg the host-IF backlog kept from starting by the checkpoint
        flies as originally planned (best-effort; nothing to re-split
        safely).  Re-striping pays a descriptor re-issue per new sibling,
        so callers trigger it on detected congestion shift, not always.
        """
        self._check_registered(region)
        if page_nbytes <= 0:
            raise ValueError(f"page_nbytes must be > 0, got {page_nbytes}")
        from repro_torch.core import fabric
        t_src = self._translate_pages(self.tlb, region, pages, page_nbytes)
        nbytes = len(pages) * page_nbytes
        if stripes is not None:
            if schedule is not None:
                raise ValueError("pass schedule= or stripes=, not both")
            legs = [(s, float(b)) for s, b in stripes]
            if not legs:
                raise ValueError("stripes must list at least one leg")
            total_b = sum(b for _, b in legs)
            if abs(total_b - nbytes) > 0.5:
                raise ValueError(
                    f"stripe bytes {total_b} != payload {nbytes}")
        else:
            sched = schedule if schedule is not None else fabric.lower_p2p(
                self.torus, self.rank, dst, faults=faults)
            legs = [(sched, float(nbytes))]
        t_dma = self.transfer_time(nbytes)
        t_wire = max(fabric.estimate(s, b, self.net).total_s
                     for s, b in legs)
        # receiver reorder/settle: every stripe past the first is one more
        # out-of-order completion the RX window must match before the
        # landed pages are usable
        t_settle = (len(legs) - 1) * self.net.t_receive
        t_dst = 0.0
        if dst_endpoint is not None and dst_region is not None:
            dst_endpoint._check_registered(dst_region)
            t_dst = self._translate_pages(
                dst_endpoint.tlb, dst_region,
                dst_pages if dst_pages is not None else pages, page_nbytes)
        # the sum-of-isolated price: what this PUT costs on a quiet fabric
        isolated = t_src + t_dma + t_wire + t_settle + t_dst
        if self.sim is None:
            self.last_put_report = {"total_s": isolated,
                                    "isolated_s": isolated,
                                    "dma_s": t_dma, "wire_s": t_wire,
                                    "translate_s": t_src + t_dst,
                                    "stripes": len(legs),
                                    "settle_s": t_settle}
            if self.telemetry is not None:
                self.telemetry.add("rdma.puts")
                self.telemetry.add("rdma.put_bytes", float(nbytes))
                self.telemetry.add("rdma.descriptors")
            return isolated
        # shared timeline: the DMA drain occupies this card's host-IF slot,
        # then the payload walks its route(s) packet by packet — all legs
        # contending with whatever else is in flight on the sim
        start = self.sim.now
        desc = self.descriptor_bytes
        if desc is not None and nbytes > desc:
            # §2.1 per-class command queue: the drain is a CHAIN of
            # descriptor occupancies, preemptible at every boundary
            from repro_torch.core.fabric.cost import hostif_descriptors
            chunks = hostif_descriptors(nbytes, desc)
            dma = None
            for i, cb in enumerate(chunks):
                dma = self.sim.occupy(
                    ("hostif", self.rank), t_dma * (cb / nbytes),
                    start_s=start + t_src,
                    after=(dma,) if dma is not None else (), cls=cls,
                    label=f"put_dma r{self.rank} d{i}")
            n_desc = len(chunks)
        else:
            dma = self.sim.occupy(("hostif", self.rank), t_dma,
                                  start_s=start + t_src, cls=cls,
                                  label=f"put_dma r{self.rank}")
            n_desc = 1
        wire_fids = []
        for i, (s, b) in enumerate(legs):
            route = s.route if s.collective == fabric.P2P else None
            wire_fids.append(self.sim.inject(
                self.rank, dst, b, route=route, after=(dma,), cls=cls,
                label=f"put {self.rank}->{dst}"
                      + (f" stripe{i}" if len(legs) > 1 else "")))
        restriped = 0
        if restripe_s is not None and hasattr(self.sim, "restripe"):
            checkpoint = start + t_src + t_dma + float(restripe_s)
            self.sim.run_until(checkpoint)
            final_fids = []
            for f in wire_fids:
                rem = self.sim.unsent_bytes(f)
                if rem <= 0.5 * page_nbytes:
                    final_fids.append(f)     # landed or nearly so
                    continue
                try:
                    plan = fabric.striped_routes(
                        self.sim, self.rank, dst, rem,
                        k=max(len(legs), 2), faults=faults, cls=cls)
                    got = self.sim.restripe(f, plan)
                except (ValueError, fabric.UnroutableError):
                    got = [f]                # leg not started / no detours
                restriped += len(got) - 1
                final_fids.extend(got)
            wire_fids = final_fids
            # the reorder window matches every landed leg, including the
            # re-striped siblings
            t_settle = (len(wire_fids) - 1) * self.net.t_receive
        wire_end = max(self.sim.finish_s(f) for f in wire_fids)
        total = (wire_end - start) + t_settle + t_dst
        self.last_put_report = {"total_s": total, "isolated_s": isolated,
                                "dma_s": t_dma, "wire_s": t_wire,
                                "translate_s": t_src + t_dst,
                                "stripes": len(legs),
                                "settle_s": t_settle,
                                "descriptors": n_desc,
                                "restriped": restriped}
        tel = self.telemetry
        if tel is not None:
            tel.add("rdma.puts")
            tel.add("rdma.put_bytes", float(nbytes))
            tel.add("rdma.descriptors", float(n_desc))
            tel.add("rdma.restriped", float(restriped))
            tel.event(("rdma", self.rank), f"put->{dst}", start, total,
                      nbytes=float(nbytes), stripes=len(legs),
                      descriptors=n_desc, restriped=restriped)
        return total

    def get_time(self, src: int, nbytes: int, region: Region, *,
                 faults=None) -> float:
        """Modelled one-sided GET of ``nbytes`` from rank ``src`` into a
        local registered region: descriptor out, payload back.

        A GET is a PUT initiated by the reader — a descriptor-sized request
        travels to ``src``, whose card streams the payload back along the
        reversed route; the local landing buffer is translated before the
        RX DMA can scatter into it.  Both legs reroute around ``faults``
        like ``put_pages``.  With a shared ``FabricSim`` attached the
        three legs become chained timeline events (request flow -> remote
        host-IF occupancy -> payload flow) instead of closed-form terms.
        """
        from repro_torch.core import fabric
        if self.telemetry is not None:
            self.telemetry.add("rdma.gets")
            self.telemetry.add("rdma.get_bytes", float(nbytes))
        t_local = self.translate_region(region)
        req = fabric.lower_p2p(self.torus, self.rank, src, faults=faults)
        back = fabric.lower_p2p(self.torus, src, self.rank, faults=faults)
        if self.sim is None:
            t = t_local
            t += fabric.estimate(req, 64, self.net).total_s  # GET descriptor
            t += self.transfer_time(nbytes)                  # remote drain
            t += fabric.estimate(back, nbytes, self.net).total_s
            return t
        start = self.sim.now
        fid_req = self.sim.inject(self.rank, src, 64, route=req.route,
                                  start_s=start + t_local,
                                  cls=TrafficClass.CONTROL,
                                  label=f"get_req {self.rank}->{src}")
        fid_dma = self.sim.occupy(("hostif", src),
                                  self.transfer_time(nbytes),
                                  after=(fid_req,), cls=TrafficClass.BULK,
                                  label=f"get_dma r{src}")
        fid_back = self.sim.inject(src, self.rank, nbytes, route=back.route,
                                   after=(fid_dma,), cls=TrafficClass.BULK,
                                   label=f"get {src}->{self.rank}")
        return self.sim.finish_s(fid_back) - start

    @staticmethod
    def _translate_pages(tlb: Tlb, region: Region, pages: Sequence[int],
                         page_nbytes: int) -> float:
        """Translate every TLB granule the listed pages span."""
        cost = 0.0
        for p in pages:
            if p < 0 or (p + 1) * page_nbytes > region.nbytes:
                raise ValueError(
                    f"page {p} ({page_nbytes} B) outside region of "
                    f"{region.nbytes} bytes")
            base = region.vaddr + p * page_nbytes
            for off in range(0, page_nbytes, PAGE_BYTES):
                _, c = tlb.translate(base + off)
                cost += c
        return cost
