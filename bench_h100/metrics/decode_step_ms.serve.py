"""decode_step_ms.serve: the mean time of ``PagedLM.decode_batch`` (the
benchmark's span around it, which ends when the tokens reach the host)
over the window's decode steps outside the profiled slice."""


def read(rec):
    s = rec.quiet_spans("decode")
    return 1e3 * sum(x[2] - x[1] for x in s) / len(s) if s else None
