"""itl_p95_ms: the 95th percentile of every gap between two consecutive
tokens of a request (each delivered at the end of its engine step) that
ends in the window."""
import numpy as np


def read(rec):
    if rec.kind != "serve":
        return None
    t0, t1 = rec.window
    x = [b - a for r in rec.requests for a, b in zip(r.times, r.times[1:])
         if t0 < b <= t1]
    return float(np.percentile(x, 95)) * 1e3 if x else None
