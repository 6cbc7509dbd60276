"""k1_roofline.serve: K1 (paged decode attention) in the profiled slice:
the least time its calls could take on one H100 (the larger of their
operations over the bf16 peak and their bytes over HBM's, summed over the
calls; one call a layer of each decode step, at that step's context
lengths and at the layer's attention shape, the layout's
``attention_shapes``) over its kernels' device time."""
from benchkit import cost

KERNELS = ("paged_",)


def read(rec):
    tr = rec.trace
    if tr is None or not tr.seconds(KERNELS):
        return None
    t = rec.traffic
    page = t["page_tokens"]
    pages = -(-(t["prompt_tokens"][1] + t["output_tokens"][1]) // page)
    shapes = rec.layout.attention_shapes(rec.model)
    bound = 0.0
    for s in tr.spans:
        if s[0] == "decode":
            for n, (H, Hkv, hd) in shapes:
                f, b, _ = cost.paged_attention(
                    len(s[3]["lens"]), H, Hkv, hd, page, pages, s[3]["lens"],
                    rec.itemsize)
                bound += n * cost.bound_s(f, b)[0]
    return 100.0 * bound / tr.seconds(KERNELS) if bound else None
