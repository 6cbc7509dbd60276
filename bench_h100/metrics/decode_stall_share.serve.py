"""decode_stall_share.serve: the share of the window's engine steps (those
outside the profiled slice) in which prefill work ran while a decode
batch waited: the engine's own ``decode_stall_s`` counter."""


def read(rec):
    steps = rec.quiet_steps() if rec.kind == "serve" else []
    wall = sum(s[1] - s[0] for s in steps)
    return 100.0 * rec.stall / wall if wall else None
