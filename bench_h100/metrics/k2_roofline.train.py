"""k2_roofline.train: K2 (flash attention, the training forward and its
recomputation) in the profiled steps: the least time its launches could
take on one H100 (each a causal call over the batch's rows at its layer's
attention shape, the layout's ``attention_shapes``; the launches spread
over the layers as the layers are) over its kernels' device time."""
from benchkit import cost

KERNELS = ("flash_attention",)


def read(rec):
    tr = rec.trace
    if tr is None or not tr.seconds(KERNELS):
        return None
    t, m = rec.traffic, rec.model
    bound = 0.0
    for n, (H, Hkv, hd) in rec.layout.attention_shapes(m):
        f, b = cost.flash_attention(t["batch"], H, Hkv, t["seq_len"],
                                    t["seq_len"], hd, True, rec.itemsize)
        share = tr.launches(KERNELS) * n / m["num_hidden_layers"]
        bound += share * cost.bound_s(f, b)[0]
    return 100.0 * bound / tr.seconds(KERNELS)
