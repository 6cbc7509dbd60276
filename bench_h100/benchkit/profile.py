"""A profiled slice of the window, reduced to what the metrics read.

``torch.profiler`` traces the host and the card over a contiguous slice of
the measured window (a few steps, so the trace stays small in memory; it is
never written out).  The reduction keeps:

* each device kernel's total seconds and launch count, by its short name
  (``paged_partial_kernel``, ``vectorized_elementwise_kernel``);
* ``busy_s``: the seconds in which some operation ran on the card (the
  union of the device intervals) and ``window_s``, the slice's wall
  length;
* the idle gaps between device operations, each labelled with the
  benchmark's innermost host span (``bench.<name>``, a
  ``record_function``) that covers its middle: what the host was doing
  while the card waited;
* the benchmark's spans that fell in the slice.
"""
from __future__ import annotations

import dataclasses
import time

import torch

OUTSIDE = "host outside the benchmark's spans"


def short_name(name: str) -> str:
    """``void (anonymous namespace)::name<T, 128>(args)`` -> ``name``."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    return n.split("<")[0].split("(")[0].split("::")[-1].strip()


@dataclasses.dataclass
class Trace:
    t0: float               # the slice on the host's clock
    t1: float
    window_s: float
    busy_s: float
    kernel_s: dict          # short name -> seconds
    kernel_n: dict          # short name -> launches
    gaps: dict              # host span -> idle seconds
    spans: list             # the benchmark's spans that fell in the slice

    def seconds(self, patterns) -> float:
        """Device seconds of the kernels whose short name holds one of
        ``patterns``."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(p in k for p in patterns))

    def launches(self, patterns) -> int:
        return sum(n for k, n in self.kernel_n.items()
                   if any(p in k for p in patterns))

    @property
    def device_s(self) -> float:
        return sum(self.kernel_s.values())

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


class Slice:
    """``start()`` ... ``stop()`` around a contiguous run of steps, then
    ``trace(spans)`` once the window has closed: stopping takes the
    profiler some time, which ``stop`` returns so the window can leave it
    out, and the reduction waits until the window is over."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.t0 = self.t1 = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Stops the trace; returns the seconds stopping took."""
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        return time.perf_counter() - self.t1

    def trace(self, spans) -> Trace:
        return reduce(self._prof.events(), self.t0, self.t1,
                      [s for s in spans if self.t0 <= s[1] <= self.t1])


def reduce(events, t0_host: float, t1_host: float, spans) -> Trace:
    dev, host = [], []
    kernel_s: dict = {}
    kernel_n: dict = {}
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith("bench."):
                continue        # a host range mirrored on the device's row
            name = short_name(e.name)
            kernel_s[name] = kernel_s.get(name, 0.0) + (t1 - t0) * 1e-6
            kernel_n[name] = kernel_n.get(name, 0) + 1
            dev.append((t0, t1))
        elif e.name.startswith("bench."):
            host.append((t0, t1, e.name))
    dev.sort()
    merged: list = []
    for t0, t1 in dev:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy = sum(t1 - t0 for t0, t1 in merged) * 1e-6
    gaps: dict = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        inside = [(h1 - h0, name) for h0, h1, name in host if h0 <= mid <= h1]
        label = min(inside)[1] if inside else OUTSIDE
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return Trace(t0=t0_host, t1=t1_host, window_s=t1_host - t0_host,
                 busy_s=busy, kernel_s=kernel_s,
                 kernel_n=kernel_n, gaps=gaps, spans=spans)
