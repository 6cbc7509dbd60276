"""mfu.train: useful model FLOPs of the window's training steps outside
the profiled slice (6 x active parameters a token plus attention;
``benchkit.flops``) over those steps' seconds times one H100's bf16
peak."""
from benchkit import cost, flops


def read(rec):
    if rec.kind != "train" or not rec.steps:
        return None
    t = rec.traffic
    n = len(rec.quiet_steps())
    work = n * flops.train_step(rec.layout, rec.model, t["batch"],
                                t["seq_len"])
    return 100.0 * work / (rec.quiet_wall * cost.PEAK_FLOPS)
