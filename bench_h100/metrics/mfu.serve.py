"""mfu.serve: useful model FLOPs of the window's engine steps outside the
profiled slice (each prompt and each generated token through the model at
top-k, attention over its context; ``benchkit.flops``) over those steps'
seconds times one H100's bf16 peak."""
from benchkit import cost, flops


def read(rec):
    if rec.kind != "serve" or not rec.steps:
        return None
    m = rec.model
    work = sum(flops.prefill(rec.layout, m, s[3]["prompt"])
               for s in rec.quiet_spans("prefill"))
    work += sum(flops.decode(rec.layout, m, s[3]["context"])
                for s in rec.quiet_spans("decode"))
    return 100.0 * work / (rec.quiet_wall * cost.PEAK_FLOPS)
