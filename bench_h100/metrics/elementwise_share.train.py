"""elementwise_share.train: the share of the profiled steps' device time
spent in PyTorch's elementwise and copy kernels (the eager update, the
casts, the loss's pointwise work)."""

PATTERNS = ("elementwise_kernel", "CatArrayBatchedCopy", "Memcpy", "Memset")


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device_s:
        return None
    return 100.0 * tr.seconds(PATTERNS) / tr.device_s
