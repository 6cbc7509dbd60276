"""Translation Look-aside Buffer — paper §2.2 (Fig 2).

APEnet+ moved virtual-to-physical translation of RDMA target addresses from
the embedded Nios II soft-CPU (slow path) into a hardware TLB on the FPGA
(fast path), gaining up to 60% receive bandwidth.

In the PyTorch port this shows up twice:

* ``Tlb`` below — a set-associative, LRU registration cache used by the
  serving engine and the RDMA layer to translate logical buffer pages
  (virtual) into device pages (physical).  Its *cost model* reproduces the
  paper's Fig 2 speedup: a hit bypasses the "Nios II" path entirely.

* the CUDA ``paged_attention`` kernel (``repro_torch.kernels``) — the
  page-table lookup happens inside the kernel, i.e. translation at
  "hardware" level, vs. the plain path that gathers pages with tensor
  indexing first ("software" level).  See kernels/csrc/paged_attention.cu.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable

# Cost model constants (seconds per translation), calibrated so that on the
# paper's synthetic receive benchmark a hot TLB yields a ~60% bandwidth gain
# (paper: "speedup of up to 60% in bandwidth ... measured").  The Nios II
# firmware walk took O(microseconds); the HW TLB answers in a few cycles.
T_NIOS_WALK = 1.2e-6   # software page walk on the embedded CPU
T_HW_HIT = 0.05e-6     # hardware TLB hit (a few 250 MHz cycles)
PAGE_BYTES = 4096


@dataclasses.dataclass
class TlbStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0


class Tlb:
    """Set-associative TLB with per-set LRU replacement.

    ``entries`` total entries split into ``ways``-associative sets.  The
    translate() method returns (physical_page, cost_seconds); the cost is the
    Fig 2 model: HW hit vs Nios II walk + fill.
    """

    def __init__(self, entries: int = 512, ways: int = 4,
                 walk: Callable[[int], int] | None = None) -> None:
        if entries % ways:
            raise ValueError("entries must be a multiple of ways")
        self.ways = ways
        self.nsets = entries // ways
        self._sets: list[OrderedDict[int, int]] = [OrderedDict()
                                                   for _ in range(self.nsets)]
        # Default "page table": identity translation (tests override).
        self._walk = walk or (lambda vpage: vpage)
        self.stats = TlbStats()

    def _set_of(self, vpage: int) -> OrderedDict[int, int]:
        return self._sets[vpage % self.nsets]

    def translate(self, vaddr: int) -> tuple[int, float]:
        """Translate a byte address; returns (paddr, model_cost_seconds)."""
        vpage, off = divmod(vaddr, PAGE_BYTES)
        s = self._set_of(vpage)
        if vpage in s:
            s.move_to_end(vpage)  # LRU touch
            self.stats.hits += 1
            return s[vpage] * PAGE_BYTES + off, T_HW_HIT
        # Miss: Nios II walk, then fill (possibly evicting the set's LRU).
        self.stats.misses += 1
        ppage = self._walk(vpage)
        if len(s) >= self.ways:
            s.popitem(last=False)
            self.stats.evictions += 1
        s[vpage] = ppage
        return ppage * PAGE_BYTES + off, T_NIOS_WALK + T_HW_HIT

    def invalidate(self, vaddr: int | None = None) -> None:
        """Shoot down one page (or the whole TLB) on deregistration."""
        if vaddr is None:
            for s in self._sets:
                s.clear()
            return
        vpage = vaddr // PAGE_BYTES
        self._set_of(vpage).pop(vpage, None)

    # -- Fig 2 receive-bandwidth model ----------------------------------------
    def receive_bandwidth(self, nbytes: int, wire_bandwidth: float,
                          hit_rate: float | None = None) -> float:
        """Effective RX bandwidth when every page needs translation.

        ``hit_rate=None`` uses the *measured* stats; otherwise the analytic
        model with the given hit rate is applied.  Translation is on the
        critical path of the RX DMA dispatch (paper §2.2).
        """
        pages = max(1, nbytes // PAGE_BYTES)
        hr = self.stats.hit_rate if hit_rate is None else hit_rate
        t_translate = pages * (hr * T_HW_HIT + (1 - hr) * (T_NIOS_WALK + T_HW_HIT))
        t_wire = nbytes / wire_bandwidth
        return nbytes / (t_wire + t_translate)
