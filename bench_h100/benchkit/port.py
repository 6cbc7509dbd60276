"""The system under test: ``repro_torch``, built from a configuration file.

The only module of the benchmark that imports the program.  It builds the
program's config from its registry entry (``port_config``: family and
mechanisms) with every size the file states, hands it the benchmark's own
weights, and makes the serving engine or the trainer a traffic file asks
for.  What the benchmark reads back: served tokens, the engine's
``decode_stall_s`` counter, the trainer's losses, its first moments and
its weights.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchkit import weights


def arch(cfgd: dict):
    """The program's ``ArchCfg`` for a configuration file."""
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
            for k, t in weights.layer(m, seed, i, device, dtype).items():
                named[f"layers.{i}.{k}"].copy_(t)
        for k, t in weights.outer(m, seed, device, dtype).items():
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


def pages_in_use(lm) -> tuple[int, int]:
    """(pages the slots hold, tokens their caches hold) right now."""
    return (lm.n_pages - len(lm.allocator.free),
            int(lm.seq_lens[list(lm.slot_pages)].sum()))


def request(rid: int, prompt: np.ndarray, max_new: int):
    from repro_torch.serving.engine import Request
    return Request(rid=rid, prompt=prompt, max_new_tokens=max_new)


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


def free_cuda() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
