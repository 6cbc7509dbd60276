"""k2_roofline.serve: K2 (flash attention) in the profiled slice's
prefills: the least time its calls could take on one H100 (one causal
call a layer of each prefill, at the prompt padded to whole pages) over
its kernels' device time."""
from benchkit import cost

KERNELS = ("flash_attention",)


def read(rec):
    tr = rec.trace
    if tr is None or not tr.seconds(KERNELS):
        return None
    m = rec.model
    d, H = m["hidden_size"], m["num_attention_heads"]
    hd = m.get("head_dim") or d // H
    bound = 0.0
    for s in tr.spans:
        if s[0] == "prefill":
            S = s[3]["padded"]
            f, b = cost.flash_attention(1, H, m["num_key_value_heads"], S, S,
                                        hd, True, rec.itemsize)
            bound += m["num_hidden_layers"] * cost.bound_s(f, b)[0]
    return 100.0 * bound / tr.seconds(KERNELS) if bound else None
