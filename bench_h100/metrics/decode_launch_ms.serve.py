"""decode_launch_ms.serve: the mean host time of the program's
``decode.layers`` span (the decode step's embedding and the enqueue of
its layers, inside ``PagedLM.decode_batch``) over the window's decode
steps outside the profiled slice."""
from benchkit import program_spans


def read(rec):
    s = program_spans.quiet(rec, "decode.layers")
    return 1e3 * sum(t1 - t0 for t0, t1, _ in s) / len(s) if s else None
