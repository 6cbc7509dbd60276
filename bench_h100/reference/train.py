"""The reference's first training steps: loss, gradient and update.

From the weights the seed gives and the rows of the first steps, the
reference computes each step's loss (token cross-entropy, plus an MoE
model's load-balancing loss summed over its layers), the gradient in
fp32, its clipping to the global norm, and AdamW with bias correction,
weight decay on the matrices and the learning rate's linear warm-up and
cosine decay.  Moments are fp32; the weights are held between steps in
the type the configuration states, as the program holds them, so an
update smaller than half a unit in the last place of a weight leaves it
where it was on both sides.  Each layer is recomputed in the backward.

It returns, per optimizer leaf (a layer's weight stacked over the
layers, ``layers/attn/wq``), the norm of the first step's gradient as the
optimizer takes it (after clipping) and the norm of each weight's change
over the steps.  The layers, their weights, the head and the leaves are
the configuration's layout's (``layout``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchkit import weights
from reference import ops


def learning_rate(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_frac`` of it at ``total_steps``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * t))
    return opt["lr"] * warm * frac


def initial_weights(layout, cfgd: dict, seed: int, device) -> dict:
    m, dtype = cfgd["model"], weights.DTYPES[cfgd["dtype"]]
    out = dict(layout.outer_weights(m, seed, device, dtype))
    for i in range(m["num_hidden_layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in
                    layout.layer_weights(m, seed, i, device, dtype).items()})
    return out


def loss_of(layout, s, p: dict, tokens: torch.Tensor, labels: torch.Tensor,
            prec: str) -> torch.Tensor:
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    h = layout.ref_embed(s, p, tokens)
    aux_total = h.new_zeros(())
    for i in range(s.layers):
        w = {k.split(".", 2)[2]: v for k, v in p.items()
             if k.startswith(f"layers.{i}.")}

        def run(h, i=i, w=w):
            return layout.ref_layer(s, i, w, h, pos, prec, capacity=True)
        h, aux = checkpoint(run, h, use_reentrant=False)
        aux_total = aux_total + aux

    def row_loss(h_row, labels_row):
        logits = layout.ref_head(s, p, h_row, prec)
        return F.cross_entropy(logits, labels_row, ignore_index=-1,
                               reduction="sum")
    # the head and the loss a row at a time, each recomputed in the
    # backward: one row's logits (S x V fp32) live at a time
    ce = sum(checkpoint(row_loss, h[b], labels[b], use_reentrant=False)
             for b in range(B))
    return ce / (labels != -1).sum() + aux_total


def leaf_norms(layout, named) -> dict[str, float]:
    """{leaf: norm} of (name, tensor) pairs, taken one at a time."""
    sq: dict[str, float] = {}
    for name, t in named:
        leaf = layout.leaf_of(name)
        sq[leaf] = sq.get(leaf, 0.0) + float(t.float().square().sum())
    return {k: math.sqrt(v) for k, v in sq.items()}


def train(layout, cfgd: dict, seed: int, rows, opt: dict, device,
          prec: str = "fp32", first_grads: dict | None = None) -> dict:
    """rows: [(tokens, labels)] numpy (B, S), one pair a step.  Returns
    {"losses": [...], "grad_norms": {leaf: norm}, "change_norms":
    {leaf: norm}}."""
    s = layout.Spec.of(cfgd)
    with ops.exact_fp32():
        stored = initial_weights(layout, cfgd, seed, device)
        m = {k: torch.zeros(v.shape, dtype=torch.float32, device=device)
             for k, v in stored.items()}
        v2 = {k: torch.zeros_like(t) for k, t in m.items()}
        losses, grad_norms = [], None
        for step, (tok, lab) in enumerate(rows, start=1):
            p = {k: t.float().requires_grad_() for k, t in stored.items()}
            tok, lab = (torch.as_tensor(np.asarray(a), dtype=torch.long,
                                        device=device) for a in (tok, lab))
            loss = loss_of(layout, s, p, tok, lab, prec)
            loss.backward()
            losses.append(float(loss.detach()))
            with torch.no_grad():
                grads = {k: t.grad for k, t in p.items()}
                gnorm = math.sqrt(sum(float(g.square().sum())
                                      for g in grads.values()))
                scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
                if step == 1 and first_grads is not None:     # on the host
                    first_grads.update({k: (g * scale).cpu()
                                        for k, g in grads.items()})
                if step == 1:
                    norms = leaf_norms(layout, grads.items())
                    grad_norms = {k: n * scale for k, n in norms.items()}
                lr = learning_rate(opt, step)
                bc1 = 1 - opt["b1"] ** step
                bc2 = 1 - opt["b2"] ** step
                for k, t in p.items():
                    g = grads[k] * scale
                    m[k].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                    v2[k].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                    delta = (m[k] / bc1) / ((v2[k] / bc2).sqrt() + opt["eps"])
                    if t.dim() >= 2:
                        delta = delta + opt["weight_decay"] * t
                    stored[k] = (t - lr * delta).to(stored[k].dtype)
            del p, grads, loss
        del m, v2
        with torch.no_grad():
            start = initial_weights(layout, cfgd, seed, device)
            change = leaf_norms(layout, (
                (k, stored[k].float() - start[k].float()) for k in stored))
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
