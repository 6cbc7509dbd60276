"""k2_roofline.serve: K2 (flash attention) in the profiled slice's
prefills: the least time its calls could take on one H100 (one causal
call a layer of each prefill, at the prompt padded to whole pages and at
the layer's attention shape, the layout's ``attention_shapes``) over its
kernels' device time."""
from benchkit import cost

KERNELS = ("flash_attention",)


def read(rec):
    tr = rec.trace
    if tr is None or not tr.seconds(KERNELS):
        return None
    shapes = rec.layout.attention_shapes(rec.model)
    bound = 0.0
    for s in tr.spans:
        if s[0] == "prefill":
            S = s[3]["padded"]
            for n, (H, Hkv, hd) in shapes:
                f, b = cost.flash_attention(1, H, Hkv, S, S, hd, True,
                                            rec.itemsize)
                bound += n * cost.bound_s(f, b)[0]
    return 100.0 * bound / tr.seconds(KERNELS) if bound else None
