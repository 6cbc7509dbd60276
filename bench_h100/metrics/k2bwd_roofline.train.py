"""k2bwd_roofline.train: K2-bwd (flash attention's backward) in the
profiled steps: the least time its calls could take on one H100 (each
call launches one dQ kernel) over the device time of all its kernels."""
from benchkit import cost

KERNELS = ("attn_bwd_",)
ONE_A_CALL = ("attn_bwd_dq",)


def read(rec):
    tr = rec.trace
    if tr is None or not tr.seconds(KERNELS):
        return None
    m, t = rec.model, rec.traffic
    d, H = m["hidden_size"], m["num_attention_heads"]
    hd = m.get("head_dim") or d // H
    f, b = cost.flash_attention_bwd(t["batch"], H, m["num_key_value_heads"],
                                    t["seq_len"], t["seq_len"], hd, True,
                                    rec.itemsize)
    bound = tr.launches(ONE_A_CALL) * cost.bound_s(f, b)[0]
    return 100.0 * bound / tr.seconds(KERNELS) if bound else None
