"""k1_roofline.serve: K1 (paged decode attention) in the profiled slice:
the least time its calls could take on one H100 (the larger of their
operations over the bf16 peak and their bytes over HBM's, summed over the
calls; one call a layer of each decode step, at that step's context
lengths) over its kernels' device time."""
from benchkit import cost

KERNELS = ("paged_",)


def read(rec):
    tr = rec.trace
    if tr is None or not tr.seconds(KERNELS):
        return None
    m, t = rec.model, rec.traffic
    d, H = m["hidden_size"], m["num_attention_heads"]
    hd = m.get("head_dim") or d // H
    page = t["page_tokens"]
    pages = -(-(t["prompt_tokens"][1] + t["output_tokens"][1]) // page)
    bound = 0.0
    for s in tr.spans:
        if s[0] == "decode":
            f, b, _ = cost.paged_attention(
                len(s[3]["lens"]), H, m["num_key_value_heads"], hd, page,
                pages, s[3]["lens"], rec.itemsize)
            bound += m["num_hidden_layers"] * cost.bound_s(f, b)[0]
    return 100.0 * bound / tr.seconds(KERNELS) if bound else None
