"""The decoder layout: the llama-style layer and OLMoE's expert layer.

A pre-norm layer as the configuration file states it: RMSNorm, causal
self-attention with rotary positions and grouped K/V heads, RMSNorm, and a
SwiGLU feed-forward, dense or a mixture of experts (router softmax in
fp32, the top k renormalised where the file says so, each expert a
SwiGLU; training keeps the rows within each expert's capacity and adds
the Switch load-balancing loss).  Untied head.  Every layer is alike here;
each function takes the layer's index all the same, as a layout whose
layers differ (a dense first layer among expert layers) needs.

A layout is found by the name in a configuration file's ``"layout"``
(``manifest.layout``) and gives the harness, by these names:

* the program: ``arch``, ``lm_module``, ``engine``, ``trainer``,
  ``first_gradient``, ``named_weights``, ``recorded_routes``;
* the seeded weights: ``layer_matrices``, ``layer_weights``,
  ``outer_weights``, ``leaf_of``, ``stack_leaves``, ``TOKEN_LEAF``;
* the reference: ``Spec``, ``ref_embed``, ``ref_layer``, ``ref_head``;
* the counts: ``layer_matmul_params``, ``attention_pair_flops``,
  ``head_params``, ``cache_bytes_per_token``, ``attention_shapes``.

Only the program's functions import the program, and only when called, so
the reference loads nothing of it.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from benchkit import weights
from reference import ops

# ----------------------------------------------------------------------------
# the program
# ----------------------------------------------------------------------------


def arch(cfgd: dict):
    """The program's ``ArchCfg`` for a configuration file: its registry
    entry (``port_config``: family and mechanisms) with every size the
    file states."""
    from repro_torch.configs import get_config

    m = cfgd["model"]
    base = get_config(cfgd["port_config"])
    sizes = dict(n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
                 n_heads=m["num_attention_heads"],
                 n_kv_heads=m["num_key_value_heads"],
                 head_dim=m.get("head_dim") or 0, vocab=m["vocab_size"],
                 norm_eps=m["rms_norm_eps"], rope_theta=m["rope_theta"],
                 tie_embeddings=m["tie_word_embeddings"],
                 dtype=weights.DTYPES[cfgd["dtype"]])
    if base.moe is not None:
        sizes["moe"] = dataclasses.replace(
            base.moe, n_experts=m["num_experts"],
            top_k=m["num_experts_per_tok"], d_expert=m["intermediate_size"],
            capacity_factor=cfgd["assumed"]["moe_capacity_factor_train"],
            router_aux_weight=m["router_aux_loss_coef"])
    sizes["d_ff"] = m["intermediate_size"]
    return dataclasses.replace(base, **sizes)


def lm_module(cfg, cfgd: dict, seed: int, device):
    """The program's model module holding the benchmark's weights."""
    from repro_torch.models.transformer import TransformerLM

    module = TransformerLM(cfg, device=device, generator=None)
    m, dtype = cfgd["model"], weights.DTYPES[cfgd["dtype"]]
    named = dict(module.named_parameters())
    with torch.no_grad():
        for i in range(m["num_hidden_layers"]):
            for k, t in layer_weights(m, seed, i, device, dtype).items():
                named[f"layers.{i}.{k}"].copy_(t)
        for k, t in outer_weights(m, seed, device, dtype).items():
            named[k].copy_(t)
    return module


def engine(cfg, module, traffic: dict, device):
    """(PagedLM, Engine) for a serving traffic mix: ``max_batch`` slots,
    each with pages for the longest prompt and answer, and a pool of
    ``pool_pages`` (default: enough for every slot's longest)."""
    from repro_torch.serving.engine import Engine, PagedLM

    page = traffic["page_tokens"]
    max_seq = traffic["prompt_tokens"][1] + traffic["output_tokens"][1]
    pages = -(-max_seq // page)
    lm = PagedLM(cfg, module, max_batch=traffic["max_batch"],
                 max_seq=pages * page, page_tokens=page,
                 pool_pages=(traffic.get("pool_pages")
                             or traffic["max_batch"] * pages), tp_axes=(),
                 device=device)
    return lm, Engine(lm)


def trainer(cfg, module, traffic: dict, seed: int, device, ckpt_dir: str,
            data):
    """A single-card ``Trainer`` on the benchmark's weights, fed by
    ``data`` (``next_batch()``: numpy tokens and labels)."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(ckpt_dir=ckpt_dir, batch=traffic["batch"],
                         seq_len=traffic["seq_len"], remat=traffic["remat"],
                         comm="single", opt=AdamWConfig(**traffic["optimizer"]),
                         bucket_mb=4.0, seed=seed)
    tr = Trainer(cfg, tcfg, device=device, init_params=module)
    tr.data = data
    return tr


def first_gradient(tr, b1: float) -> dict:
    """{leaf: fp32 tensor on the host} of the gradient the optimizer took
    in its first step, from its first moment (m = (1 - b1) g after one
    step); a layer's leaf is stacked over the layers."""
    return {k: (t / (1 - b1)).to("cpu")
            for k, t in tr.opt_state["m"].items()}


def named_weights(tr):
    """(name, tensor) of the trainer's weights, as step 4 would read them."""
    return ((k, p.detach()) for k, p in tr.params.named_parameters())


@contextlib.contextmanager
def recorded_routes(store: list, calls: int):
    """Appends to ``store`` the expert ids (T K,) that each of the
    program's first ``calls`` calls of its MoE dispatch routes its tokens
    to, in call order."""
    from repro_torch.models import moe

    inner = moe._local_dispatch

    def dispatch(*args, **kwargs):
        out = inner(*args, **kwargs)
        if len(store) < calls:
            store.append(out[3].detach().clone())
        return out
    moe._local_dispatch = dispatch
    try:
        yield store
    finally:
        moe._local_dispatch = inner


# ----------------------------------------------------------------------------
# the seeded weights
#
# Names follow the program's layer (``attn.wq``, ``mlp.w_gate``,
# ``moe.router``, ``ln1.scale``) and outer weights (``embed.tok``,
# ``embed.head``, ``final_norm.scale``); a matrix is stored (in, out), so
# ``x @ w``.  Layer i is part i of ``weights.part_seed``, the outer weights
# part L.  Matrices N(0, 1/fan_in), the token embedding and the fp32 router
# N(0, 0.02^2), norm gains 1.
# ----------------------------------------------------------------------------

TOKEN_LEAF = "embed/tok"       # the optimizer's leaf of the token embedding


def layer_matrices(m: dict, i: int) -> dict[str, tuple[tuple[int, ...], int]]:
    """{name: (shape, fan_in)} of layer ``i``'s matrices in the served
    type."""
    d, H, Hkv = m["hidden_size"], m["num_attention_heads"], \
        m["num_key_value_heads"]
    hd = m.get("head_dim") or d // H
    f = m["intermediate_size"]
    out = {"attn.wq": ((d, H * hd), d), "attn.wk": ((d, Hkv * hd), d),
           "attn.wv": ((d, Hkv * hd), d), "attn.wo": ((H * hd, d), H * hd)}
    if m.get("num_experts"):
        E = m["num_experts"]
        out.update({"moe.w_gate": ((E, d, f), d), "moe.w_up": ((E, d, f), d),
                    "moe.w_down": ((E, f, d), f)})
    else:
        out.update({"mlp.w_gate": ((d, f), d), "mlp.w_up": ((d, f), d),
                    "mlp.w_down": ((f, d), f)})
    return out


def layer_weights(m: dict, seed: int, i: int, device,
                  dtype) -> dict[str, torch.Tensor]:
    """Layer ``i``'s weights: its matrices in ``dtype``, an MoE layer's
    router in fp32, its two norm gains."""
    gen = weights.generator(seed, i, device)
    mats = {k: (s, fan ** -0.5) for k, (s, fan) in layer_matrices(m, i).items()}
    out = weights.draw(mats, gen, device, dtype)
    if m.get("num_experts"):
        out.update(weights.draw({"moe.router": ((m["hidden_size"],
                                                 m["num_experts"]), 0.02)},
                                gen, device, torch.float32))
    d = m["hidden_size"]
    out["ln1.scale"] = torch.ones(d, dtype=dtype, device=device)
    out["ln2.scale"] = torch.ones(d, dtype=dtype, device=device)
    return out


def outer_weights(m: dict, seed: int, device,
                  dtype) -> dict[str, torch.Tensor]:
    """The token embedding, the untied head and the final norm's gain."""
    d, V = m["hidden_size"], m["vocab_size"]
    gen = weights.generator(seed, m["num_hidden_layers"], device)
    out = weights.draw({"embed.tok": ((V, d), 0.02),
                        "embed.head": ((d, V), d ** -0.5)},
                       gen, device, dtype)
    out["final_norm.scale"] = torch.ones(d, dtype=dtype, device=device)
    return out


def leaf_of(name: str) -> str:
    """The optimizer's leaf a weight belongs to: a layer's weights are
    stacked over the layers (``layers.3.attn.wq`` -> ``layers/attn/wq``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = ["layers"] + parts[2:]
    return "/".join(parts)


def stack_leaves(named: dict) -> dict:
    """{weight name: tensor} -> {leaf: tensor}, a layer's weights stacked
    in layer order, as the program's optimizer holds them."""
    groups: dict = {}
    for k, t in named.items():
        i, _ = weights.split(k)
        groups.setdefault(leaf_of(k), []).append((i or 0, t))
    return {leaf: (torch.stack([t for _, t in sorted(v, key=lambda x: x[0])])
                   if leaf.startswith("layers/") else v[0][1])
            for leaf, v in groups.items()}


# ----------------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Spec:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    eps: float
    theta: float
    experts: int = 0
    top_k: int = 0
    norm_topk: bool = True
    capacity_factor: float = 1.25
    aux_coef: float = 0.01

    @classmethod
    def of(cls, cfgd: dict) -> "Spec":
        m = cfgd["model"]
        d, H = m["hidden_size"], m["num_attention_heads"]
        return cls(layers=m["num_hidden_layers"], d=d, heads=H,
                   kv_heads=m["num_key_value_heads"],
                   head_dim=m.get("head_dim") or d // H,
                   ff=m["intermediate_size"], vocab=m["vocab_size"],
                   eps=m["rms_norm_eps"], theta=m["rope_theta"],
                   experts=m.get("num_experts", 0),
                   top_k=m.get("num_experts_per_tok", 0),
                   norm_topk=m.get("norm_topk_prob", True),
                   capacity_factor=cfgd.get("assumed", {}).get(
                       "moe_capacity_factor_train", 1.25),
                   aux_coef=m.get("router_aux_loss_coef", 0.01))


def _attention(s: Spec, w: dict, x: torch.Tensor, pos: torch.Tensor,
               prec: str) -> torch.Tensor:
    """Causal self-attention of one sequence x (S, d)."""
    S, hd, mm = x.shape[0], s.head_dim, ops.mm
    q = ops.rope(mm(x, w["attn.wq"], prec).view(S, s.heads, hd), pos,
                 s.theta)
    k = ops.rope(mm(x, w["attn.wk"], prec).view(S, s.kv_heads, hd), pos,
                 s.theta)
    v = mm(x, w["attn.wv"], prec).view(S, s.kv_heads, hd)
    return mm(ops.causal_attention(q, k, v, prec), w["attn.wo"], prec)


def _moe(s: Spec, w: dict, x: torch.Tensor, prec: str, capacity: bool):
    """(y, aux) of the expert layer over tokens x (T, d); ``capacity``
    keeps, of the rows routed to each expert in (token, k) order, the
    first int(T k / E * factor) (at least k)."""
    T, E, K = x.shape[0], s.experts, s.top_k
    probs = torch.softmax(x @ w["moe.router"], dim=-1)      # fp32 router
    top_p, top_e = torch.topk(probs, K, dim=-1)
    if ops.ROUTES is not None:
        ops.ROUTES.append(top_e.reshape(-1).detach().clone())
    if s.norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    C = max(int(T * K / E * s.capacity_factor), K) if capacity else T * K
    y = ops.experts(x, top_e, top_p, w["moe.w_gate"], w["moe.w_up"],
                    w["moe.w_down"], C, prec)
    counts = torch.bincount(top_e.reshape(-1), minlength=E).float() / (T * K)
    aux = s.aux_coef * E * torch.sum(probs.mean(0) * counts)
    return y, aux


def ref_embed(s: Spec, w: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The input hidden states of token ids (the outer weights ``w``)."""
    return w["embed.tok"][tokens]


def ref_layer(s: Spec, i: int, w: dict, h: torch.Tensor, pos: torch.Tensor,
              prec: str, capacity: bool = False):
    """Layer ``i`` (its weights ``w``) on sequences h (B, S, d) at
    positions pos (S,) -> (h, aux); the experts see the B S tokens
    together."""
    B, S, d = h.shape

    def row(x: torch.Tensor) -> torch.Tensor:
        return _attention(s, w, ops.rms_norm(x, w["ln1.scale"], s.eps), pos,
                          prec)
    # with gradients, each row's attention is recomputed in the backward,
    # so one row's scores (H x S x S fp32) are held at a time
    a = [checkpoint(row, h[b], use_reentrant=False)
         if torch.is_grad_enabled() else row(h[b]) for b in range(B)]
    h = h + torch.stack(a)
    x = ops.rms_norm(h, w["ln2.scale"], s.eps).reshape(B * S, d)
    if s.experts:
        y, aux = _moe(s, w, x, prec, capacity)
    else:
        y = ops.swiglu(x, w["mlp.w_gate"], w["mlp.w_up"], w["mlp.w_down"],
                       prec)
        aux = h.new_zeros(())
    return h + y.view(B, S, d), aux


def ref_head(s: Spec, w: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    """Logits (S, V) of final hidden states h (S, d)."""
    return ops.mm(ops.rms_norm(h, w["final_norm.scale"], s.eps),
                  w["embed.head"], prec)


# ----------------------------------------------------------------------------
# the counts: useful work and bytes, for ``benchkit.flops`` and the
# roofline readers
# ----------------------------------------------------------------------------


def _heads(m: dict) -> tuple[int, int, int]:
    d, H = m["hidden_size"], m["num_attention_heads"]
    return H, m["num_key_value_heads"], m.get("head_dim") or d // H


def layer_matmul_params(m: dict, i: int) -> int:
    """Weights one token multiplies through in layer ``i``: the
    attention's four matrices and the feed-forward's three (an MoE layer:
    its top-k experts' and the router)."""
    d, f = m["hidden_size"], m["intermediate_size"]
    H, Hkv, hd = _heads(m)
    attn = d * (H + 2 * Hkv) * hd + H * hd * d
    ffn = 3 * d * f
    if m.get("num_experts"):
        return attn + m["num_experts_per_tok"] * ffn + d * m["num_experts"]
    return attn + ffn


def attention_pair_flops(m: dict, i: int) -> int:
    """Operations a (query, key) pair costs in layer ``i``: QK^T and PV
    over every head."""
    H, _, hd = _heads(m)
    return 4 * H * hd


def head_params(m: dict) -> int:
    return m["hidden_size"] * m["vocab_size"]


def cache_bytes_per_token(m: dict, itemsize: int) -> int:
    """Bytes a token holds in the serving cache: every layer's K and V."""
    _, Hkv, hd = _heads(m)
    return sum(2 * Hkv * hd * itemsize for _ in range(m["num_hidden_layers"]))


def attention_shapes(m: dict) -> list[tuple[int, tuple[int, int, int]]]:
    """[(layers, (H, Hkv, hd))]: runs of consecutive layers whose
    attention kernels (K1, K2, K2-bwd) see one shape, in layer order."""
    return [(m["num_hidden_layers"], _heads(m))]
