"""prefill_tokens_per_s.serve: prompt tokens over the time of the
benchmark's spans around ``PagedLM.prefill_slot`` (each ends when the
first token reaches the host), outside the profiled slice."""


def read(rec):
    s = rec.quiet_spans("prefill")
    t = sum(x[2] - x[1] for x in s)
    return sum(x[3]["prompt"] for x in s) / t if t else None
