"""idle_share.train: the share of the profiled slice's wall time in which
no operation ran on the card."""


def read(rec):
    tr = rec.trace
    if rec.kind != "train" or tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
