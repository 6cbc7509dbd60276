"""The program's own spans, read from its process telemetry hub.

The port records wall-clock spans into one hub a process
(``repro_torch.core.fabric.telemetry.process_hub``), on
``time.perf_counter()``: the clock of the window, of the profiled slice
and of the benchmark's own spans.  Each is an event of the hub's bounded
ring, ``(start, track, name, length, ((arg, value), ...))``.  A reader
takes the spans of one name whose start lies in the window and outside
the profiled slice, the rule of ``Record.quiet_spans``.

Where the program has no such hub, or its ring dropped an event that may
lie in the window, there is nothing to read: ``None``.
"""
from __future__ import annotations


def hub():
    """The program's process hub, or ``None`` where it has none."""
    try:
        from repro_torch.core.fabric.telemetry import process_hub
    except ImportError:
        return None
    return process_hub()


def quiet(rec, name: str, at: str = "start"):
    """[(t0, t1, args)] of the program's ``name`` spans whose start (with
    ``at="end"``: whose end) lies in ``rec.window`` and outside the
    profiled slice; ``None`` without a hub or after a drop."""
    h = hub()
    if h is None:
        return None
    events = list(h.events)
    w0, w1 = rec.window
    # the ring is in order of the spans' ends: every dropped event ended
    # before the oldest one kept did
    if h.dropped and (not events or events[0][0] + events[0][3] >= w0):
        return None
    tr = rec.trace
    out = []
    for ts, _, nm, dur, packed in events:
        if nm != name:
            continue
        t = ts + dur if at == "end" else ts
        if w0 <= t <= w1 and (tr is None or not tr.t0 <= t <= tr.t1):
            out.append((ts, ts + dur, dict(packed)))
    return out
