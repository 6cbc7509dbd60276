"""ttft_p90_ms: the 90th percentile, over every request whose first token
came in the window, of the time from the client's sending it to the end
of the engine step that produced its first token."""
import numpy as np


def read(rec):
    if rec.kind != "serve":
        return None
    t0, t1 = rec.window
    x = [r.times[0] - r.sent for r in rec.requests
         if r.times and t0 < r.times[0] <= t1]
    return float(np.percentile(x, 90)) * 1e3 if x else None
