"""queue_wait_p90_ms.serve: the 90th percentile of the program's
``engine.queued`` spans (a request's wait from ``Engine.submit`` to the
start of its own prefill) over the requests whose prefill started in the
window, outside the profiled slice."""
import numpy as np

from benchkit import program_spans


def read(rec):
    s = program_spans.quiet(rec, "engine.queued", at="end")
    if not s:
        return None
    return float(np.percentile([t1 - t0 for t0, t1, _ in s], 90)) * 1e3
