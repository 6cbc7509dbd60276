"""k2_roofline.train: K2 (flash attention, the training forward and its
recomputation) in the profiled steps: the least time its launches could
take on one H100 (each a causal call over a whole row) over its kernels'
device time."""
from benchkit import cost

KERNELS = ("flash_attention",)


def read(rec):
    tr = rec.trace
    if tr is None or not tr.seconds(KERNELS):
        return None
    m, t = rec.model, rec.traffic
    d, H = m["hidden_size"], m["num_attention_heads"]
    hd = m.get("head_dim") or d // H
    f, b = cost.flash_attention(t["batch"], H, m["num_key_value_heads"],
                                t["seq_len"], t["seq_len"], hd, True,
                                rec.itemsize)
    bound = tr.launches(KERNELS) * cost.bound_s(f, b)[0]
    return 100.0 * bound / tr.seconds(KERNELS)
