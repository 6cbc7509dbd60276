"""Decoder-only transformer LM (dense + MoE) — also the VLM backbone.

The counterpart of the JAX package's ``models/transformer.py``.  The layer
stack is an ``nn.ModuleList`` walked with a Python loop (JAX: ``lax.scan``
over stacked parameters), and there is no ``jit``: PyTorch runs eagerly.

Entry points:
  * ``train_loss`` — full-sequence causal LM loss;
  * ``prefill``    — full forward that also returns the KV cache.
The paged decode path lives in ``serving/engine.py``.  Rematerialisation,
the hand-SPMD ``manual_sp`` stack and sharding constraints wait for the
training slice of the port; the configs' ``tp_activations`` and
``moe_impl`` knobs are not read here.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common, moe
from repro_torch.models.common import ArchCfg


class Block(nn.Module):
    """One decoder layer: ln1 -> attention -> ln2 -> MLP or MoE."""

    def __init__(self, cfg: ArchCfg, gen, device) -> None:
        super().__init__()
        self.ln1 = common.init_norm(cfg, device)
        self.ln2 = common.init_norm(cfg, device)
        self.attn = attn.init_attn(cfg, gen, device)
        if cfg.moe is not None:
            self.moe = moe.init_moe(cfg, gen, device)
        else:
            self.mlp = common.init_mlp(cfg, gen, device)


class TransformerLM(nn.Module):
    """Parameters of a decoder-only LM; names follow the JAX pytree
    (``embed.tok``, ``layers.<i>.attn.wq``, ``final_norm.scale``, ...)."""

    def __init__(self, cfg: ArchCfg, *, device,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = common.init_embed(cfg, generator, device)
        self.layers = nn.ModuleList(Block(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = common.init_norm(cfg, device)


def init_lm(cfg: ArchCfg, generator: torch.Generator) -> TransformerLM:
    """Random weights drawn from ``generator``, on the generator's device."""
    return TransformerLM(cfg, device=generator.device, generator=generator)


def _mix(cfg: ArchCfg, lp: Block, h: torch.Tensor, *,
         moe_dropless: bool = False) -> torch.Tensor:
    """The feed-forward half of a layer, on the residual stream h."""
    x2 = common.apply_norm(cfg, lp.ln2, h)
    if cfg.moe is not None:
        m, _ = moe.apply_moe(cfg, lp.moe, x2, dropless=moe_dropless)
        return m
    return common.apply_mlp(cfg, lp.mlp, x2)


def forward(cfg: ArchCfg, params: TransformerLM, h: torch.Tensor, *,
            causal: bool = True):
    """Run the layer stack over embeddings h: (B, S, d) -> (h, aux_loss)."""
    freqs = common.rope_freqs(cfg, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in params.layers:
        a, _ = attn.attn_full(cfg, lp.attn,
                              common.apply_norm(cfg, lp.ln1, h),
                              freqs=freqs, causal=causal)
        h = h + a
        x2 = common.apply_norm(cfg, lp.ln2, h)
        if cfg.moe is not None:
            m, a_l = moe.apply_moe(cfg, lp.moe, x2)
            aux = aux + a_l
        else:
            m = common.apply_mlp(cfg, lp.mlp, x2)
        h = h + m
    return common.apply_norm(cfg, params.final_norm, h), aux


def embed_inputs(cfg: ArchCfg, params: TransformerLM, batch: dict):
    """tokens (+ optional stub-frontend prefix embeddings) -> (h, labels)."""
    h = common.embed_tokens(params.embed, batch["tokens"])
    labels = batch.get("labels")
    if "prefix_embeds" in batch:  # VLM: precomputed patch embeddings
        pre = batch["prefix_embeds"].to(h.dtype)
        h = torch.cat([pre, h], dim=1)
        if labels is not None:
            ignore = torch.full(pre.shape[:2], -1, dtype=labels.dtype,
                                device=labels.device)
            labels = torch.cat([ignore, labels], dim=1)
    return h, labels


def train_loss(cfg: ArchCfg, params: TransformerLM, batch: dict):
    h, labels = embed_inputs(cfg, params, batch)
    h, aux = forward(cfg, params, h, causal=True)
    logits = common.lm_head(cfg, params.embed, h)
    return common.cross_entropy(logits, labels) + aux


def prefill(cfg: ArchCfg, params: TransformerLM, batch: dict, *,
            max_len: int | None = None, return_hidden: bool = False,
            moe_dropless: bool = False):
    """Forward + build the dense KV cache.  Returns (logits_last, cache)
    [+ final hidden states when return_hidden — serving engines pick their
    own logits position for padded prompts].  ``moe_dropless`` forces the
    capacity-free MoE dispatch serving requires.

    cache: {"k", "v"} of shape (L, B, max_len, Hkv, hd)."""
    h, _ = embed_inputs(cfg, params, batch)
    B, S, _ = h.shape
    # VLM prefix embeddings extend S beyond the token budget: the cache must
    # cover the full (prefix + tokens) context
    max_len = max(max_len or S, S)
    freqs = common.rope_freqs(cfg, h.device)
    ks, vs = [], []
    for lp in params.layers:
        x = common.apply_norm(cfg, lp.ln1, h)
        a, (k, v) = attn.attn_full(cfg, lp.attn, x, freqs=freqs, causal=True)
        h = h + a
        h = h + _mix(cfg, lp, h, moe_dropless=moe_dropless)
        pad = max_len - S
        ks.append(torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)))
        vs.append(torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)))
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h[:, -1:])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if return_hidden:
        return logits, cache, h
    return logits, cache
