"""The reference's logits at the positions a served request was answered.

A request is its prompt and the tokens the program served for it.  The
reference runs once over the prompt followed by the served tokens (the
last one is never an input) and gives, at each answering position, the
row of logits that should have picked the served token there.  It works a
layer at a time over all the requests, drawing each layer's weights again
from the seed, so that it fits beside nothing else on the card.  The
layer, its weights and the head are the configuration's layout's
(``layout``: the module ``manifest.layout`` loads).
"""
from __future__ import annotations

import numpy as np
import torch

from benchkit import weights
from reference import ops


def logit_rows(layout, cfgd: dict, seed: int, requests, device,
               prec: str = "fp32"):
    """requests: [(prompt (P,) ints, served (n,) ints)] -> [(n, V) fp32
    logits]: row j is the reference's logits where served[j] was
    answered."""
    s = layout.Spec.of(cfgd)
    m, dtype = cfgd["model"], weights.DTYPES[cfgd["dtype"]]
    inputs = [np.concatenate([np.asarray(p), np.asarray(o)[:-1]])
              for p, o in requests]
    with torch.no_grad(), ops.exact_fp32():
        ow = layout.outer_weights(m, seed, device, dtype)
        hs = [layout.ref_embed(s, ow, torch.as_tensor(
            x, dtype=torch.long, device=device)).float()[None]
              for x in inputs]
        for i in range(s.layers):
            w = {k: v.float() for k, v in
                 layout.layer_weights(m, seed, i, device, dtype).items()}
            hs = [layout.ref_layer(s, i, w, h, torch.arange(
                h.shape[1], device=device), prec)[0] for h in hs]
            del w
        ow = {k: v.float() for k, v in ow.items()}
        return [layout.ref_head(s, ow, h[0, len(p) - 1:], prec)
                for h, (p, _) in zip(hs, requests)]


def gaps(rows, served) -> dict:
    """How far the served tokens' logits lie below the best logit of
    their rows: the widest gap, the mean gap over every served token, and
    the number of served tokens read."""
    worst, total, n = 0.0, 0.0, 0
    for r, o in zip(rows, served):
        tok = torch.as_tensor(np.asarray(o), dtype=torch.long,
                              device=r.device)
        gap = r.max(-1).values - r.gather(-1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        total += float(gap.sum())
        n += len(o)
    return {"max_logit_gap": worst, "mean_logit_gap": total / max(n, 1),
            "tokens": n}
