"""k2bwd_roofline.train: K2-bwd (flash attention's backward) in the
profiled steps: the least time its calls could take on one H100 (each
call launches one dQ kernel, at its layer's attention shape, the layout's
``attention_shapes``; the calls spread over the layers as the layers are)
over the device time of all its kernels."""
from benchkit import cost

KERNELS = ("attn_bwd_",)
ONE_A_CALL = ("attn_bwd_dq",)


def read(rec):
    tr = rec.trace
    if tr is None or not tr.seconds(KERNELS):
        return None
    t, m = rec.traffic, rec.model
    bound = 0.0
    for n, (H, Hkv, hd) in rec.layout.attention_shapes(m):
        f, b = cost.flash_attention_bwd(t["batch"], H, Hkv, t["seq_len"],
                                        t["seq_len"], hd, True, rec.itemsize)
        share = tr.launches(ONE_A_CALL) * n / m["num_hidden_layers"]
        bound += share * cost.bound_s(f, b)[0]
    return 100.0 * bound / tr.seconds(KERNELS) if bound else None
