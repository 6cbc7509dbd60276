"""Decoder-only transformer LM (dense + MoE) — also the VLM backbone.

The counterpart of the JAX package's ``models/transformer.py``.  The layer
stack is an ``nn.ModuleList`` walked with a Python loop (JAX: ``lax.scan``
over stacked parameters), and there is no ``jit``: PyTorch runs eagerly.

Entry points:
  * ``train_loss``  — full-sequence causal LM loss;
  * ``prefill``     — full forward that also returns the KV cache;
  * ``decode_step`` — one token against the dense KV cache (written in
    place, where JAX returns an updated copy).
The paged decode path lives in ``serving/engine.py``.  ``remat=True``
recomputes each layer in the backward (``torch.utils.checkpoint``, as JAX's
``jax.checkpoint`` over the scan body).

Under the GSPMD trainer (a mesh registered with
``sharding.set_runtime_mesh``; each rank holds its shard of every
parameter) the stack runs tensor-parallel when the mesh has a "model"
axis and heads, KV heads and d_ff divide it: every rank computes its
heads and its d_ff slice from its own shards (``spmd.tp_slice``).  How
the residual stream crosses "model" follows ``tp_activations``, as in
JAX: "free" and "megatron" keep it replicated, each sub-block ending in
one all-reduce; "sp" and "manual_sp" shard the sequence, each sub-block
one all-gather before its column-parallel product and one reduce-scatter
after its row-parallel one (``_stack_manual_sp``'s schedule), "sp" with
fp32 on the wire (the partitioner's post-upcast), "manual_sp" the
activation dtype.  "manual_sp" takes JAX's conditions
(``_manual_sp_applicable``, ``_manual_sp_ok`` and its early returns);
where they fail it runs what JAX runs.  Under ``parallelism="dp_only"``
with the sequence over "model" (``batch_specs``, when the batch cannot
cover the grid) each rank computes its slice of the sequence, K/V
gathered a layer.  Every other layer, and a stack TP does not fit, reads
its sharded leaves gathered where it uses them
(``models.common.Params``).  MoE layers pick their dispatch as JAX's do:
``moe_impl="ep_a2a"`` the expert-parallel one (``moe.apply_moe_ep``: two
all-to-alls over "model", JAX's fallback to the global dispatch where it
does not apply), else the global one, which under a batch split over
ranks dispatches the global batch's tokens (``moe.apply_moe_global``);
serving's dropless dispatch and the dense decode step stay global.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common, moe
from repro_torch.models.common import ArchCfg
from repro_torch.parallel import sharding, spmd


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
         moe_dropless: bool = False, ep: bool = False) -> torch.Tensor:
    """The feed-forward half of a layer, on the residual stream h; an MoE
    layer dispatches dropless when asked, else expert-parallel where
    ``ep`` and the config say so (JAX's prefill), else globally (JAX's
    decode step)."""
    x2 = common.apply_norm(cfg, lp.ln2, h)
    if cfg.moe is None:
        return common.apply_mlp(cfg, lp.mlp, x2)
    if moe_dropless:
        return moe.apply_moe(cfg, lp.moe, x2, dropless=True)[0]
    if ep and cfg.moe_impl == "ep_a2a":
        return moe.apply_moe_ep(cfg, lp.moe, x2)[0]
    return moe.apply_moe(cfg, lp.moe, x2)[0]


def _layer_fwd(cfg: ArchCfg, lp: Block, h: torch.Tensor, freqs,
               causal: bool, positions=None, kv=None):
    a, _ = attn.attn_full(cfg, lp.attn, common.apply_norm(cfg, lp.ln1, h),
                          freqs=freqs, causal=causal, positions=positions,
                          kv=kv)
    h = h + a
    x2 = common.apply_norm(cfg, lp.ln2, h)
    if cfg.moe is not None:
        apply = moe.apply_moe_ep if cfg.moe_impl == "ep_a2a" else \
            moe.apply_moe_global
        m, aux = apply(cfg, lp.moe, x2)
    else:
        m = common.apply_mlp(cfg, lp.mlp, x2)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + m, aux


def forward(cfg: ArchCfg, params: TransformerLM, h: torch.Tensor, *,
            causal: bool = True, remat: bool = False):
    """Run the layer stack over embeddings h: (B, S, d) -> (h, aux_loss).

    ``remat`` (under grad) keeps only each layer's input and recomputes the
    layer in the backward, as JAX's ``nothing_saveable`` checkpoint does.
    Under a runtime mesh the stack runs as ``_stack_mode`` says."""
    freqs = common.rope_freqs(cfg, h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    mode = _stack_mode(cfg, h, causal)
    positions = kv = None
    if mode == "kv":    # h is this rank's slice of the sequence
        mesh = sharding.runtime_mesh()
        s = h.shape[1]
        positions = (mesh.axis_index("model") * s
                     + torch.arange(s, device=h.device))[None]
        kv = functools.partial(_gather_kv, mesh=mesh, causal=causal)
    elif mode is not None:
        mesh = sharding.runtime_mesh()
        # this rank's slice of the sequence, unless the batch came so
        seq = mode in ("sp", "manual_sp") \
            and sharding.runtime_batch_spec()[1] is None
        if seq:
            h = sharding.constrain_activations(h, seq_axis="model")
        for lp in params.layers:
            h = common.run_layer(_tp_layer_fwd, remat, cfg, lp, h, freqs,
                                 causal, mode)
        if seq:
            h = spmd.all_gather(h, 1, mesh, "model", tag="seq")
        return common.apply_norm(cfg, params.final_norm, h), aux
    for lp in params.layers:
        h, a = common.run_layer(_layer_fwd, remat, cfg, lp, h, freqs, causal,
                                positions, kv)
        aux = aux + a
    return common.apply_norm(cfg, params.final_norm, h), aux


# ----------------------------------------------------------------------------
# the dense stack under a mesh: Megatron tensor parallelism, and sequence
# parallelism with explicit collectives (JAX: the partitioner's layout under
# _constrain, and _stack_manual_sp's hand-SPMD stack):
#
#   h --ln--> [AG(seq)] -> qkv (local heads) -> attn -> @wo (partial)
#     --AR | RS(seq)--> +residual --ln--> [AG] -> mlp (f-sharded)
#     -> @w_down (partial) --AR | RS--> +residual
#
# and, for dp_only, whose parameters are replicated and whose batch may
# leave the "model" axis the sequence (batch_specs), each rank runs the
# plain layers on its slice of the sequence, with one all-gather of K/V a
# layer: its queries attend the keys of every slice before its own.
#
# autograd through the collectives (parallel/spmd.py) gives the transposed
# ones in the backward.
# ----------------------------------------------------------------------------

def _manual_sp_applicable(cfg: ArchCfg) -> bool:
    return cfg.moe is None and cfg.mlp == "swiglu" and cfg.n_heads > 0


def _manual_sp_ok(cfg: ArchCfg, mesh) -> bool:
    tp = mesh.shape.get("model", 1)
    return (tp > 1 and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
            and cfg.d_ff % tp == 0)


def takes_sequence_slices(cfg: ArchCfg) -> bool:
    """Whether ``train_loss`` runs on a rank's slice of the sequence when
    the GSPMD trainer's batch spec shards it (the dense family: K/V
    gathered over "model"); other families are handed the whole
    sequence."""
    return cfg.family == "dense"


def _stack_mode(cfg: ArchCfg, h: torch.Tensor, causal: bool) -> str | None:
    """How the stack runs under the registered mesh: None (the plain
    stack, its sharded leaves gathered where read), "allreduce" (the
    residual replicated over "model"), "sp" or "manual_sp" (the sequence
    sharded over "model"), "kv" (the plain layers on this rank's slice of
    the sequence).  h is that slice when the registered batch spec shards
    the sequence."""
    mesh = sharding.runtime_mesh()
    if mesh is None:
        return None
    batch, seq = (sharding.spec_axes(e)
                  for e in sharding.runtime_batch_spec())
    if cfg.moe is not None or cfg.n_heads == 0 or "model" in batch:
        return None    # the ranks of a "model" line hold other rows
    S = h.shape[1] * math.prod(mesh.shape[a] for a in seq)
    if cfg.tp_activations == "manual_sp" and causal \
            and _manual_sp_applicable(cfg) and _manual_sp_ok(cfg, mesh):
        # JAX's early returns: a DP axis, S divisible by "model", and the
        # global batch divisible by dp_size (the batch split over every
        # DP axis)
        dpx = sharding.dp_axes(mesh)
        if dpx and not S % mesh.shape["model"] and batch == dpx:
            return "manual_sp"
    if seq:
        return "kv"
    tp = sharding.tp_size(mesh, cfg)
    if tp <= 1 or cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp:
        return None
    if cfg.tp_activations == "sp" and sharding.dp_axes(mesh) \
            and not S % tp:
        return "sp"
    return "allreduce"


def _gather_kv(k: torch.Tensor, v: torch.Tensor, *, mesh, causal: bool):
    """Every slice's K/V (one all-gather over "model"); under ``causal``
    only the slices up to this rank's, whose queries see no later key."""
    kv = spmd.all_gather(torch.stack([k, v]), 2, mesh, "model", tag="kv")
    if causal:
        kv = kv[:, :, :(mesh.axis_index("model") + 1) * k.shape[1]]
    return kv[0], kv[1]


def _seq_gather(x: torch.Tensor, mesh, mode: str) -> torch.Tensor:
    """The full sequence of a sequence-sharded activation."""
    if mode == "sp":   # fp32 on the wire, as the partitioner's upcast
        return spmd.all_gather(x.float(), 1, mesh, "model",
                               tag="seq").to(x.dtype)
    return spmd.all_gather(x, 1, mesh, "model", tag="seq")


def _reduce(part: torch.Tensor, mesh, mode: str, dtype) -> torch.Tensor:
    """The sum over "model" of a row-parallel product's partials: all of
    it ("allreduce"), or this rank's slice of the sequence."""
    if mode == "allreduce":
        return spmd.all_reduce(part.to(dtype), mesh, "model", tag="act")
    if mode == "sp":
        return spmd.reduce_scatter(part.float(), 1, mesh, "model",
                                   tag="seq").to(dtype)
    return spmd.reduce_scatter(part.to(dtype), 1, mesh, "model", tag="seq")


# row-parallel weights: their input dim over "model" (the rest column-
# parallel: their output dim)
_ROW_PARALLEL = {"wo", "w_down"}


def _tp_layer_fwd(cfg: ArchCfg, lp: Block, h: torch.Tensor, freqs,
                  causal: bool, mode: str) -> torch.Tensor:
    """One layer of the shared attention and MLP on this rank's heads and
    d_ff slice, between the collectives of ``mode``."""
    mesh = sharding.runtime_mesh()
    tp, dtype = mesh.shape["model"], h.dtype

    def local(p):
        return lambda name: spmd.tp_slice(
            p.local(name), 0 if name in _ROW_PARALLEL else -1, mesh)

    def gather(x):
        return x if mode == "allreduce" else _seq_gather(x, mesh, mode)

    def reduce(part):
        return _reduce(part, mesh, mode, dtype)

    a, _ = attn.attn_full(cfg, lp.attn,
                          gather(common.apply_norm(cfg, lp.ln1, h)),
                          freqs=freqs, causal=causal, w=local(lp.attn),
                          heads=(cfg.n_heads // tp, cfg.n_kv_heads // tp))
    h = h + reduce(a)
    return h + common.apply_mlp(cfg, lp.mlp,
                                gather(common.apply_norm(cfg, lp.ln2, h)),
                                w=local(lp.mlp), reduce=reduce)


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


def train_loss(cfg: ArchCfg, params: TransformerLM, batch: dict, *,
               remat: bool = True):
    h, labels = embed_inputs(cfg, params, batch)
    h, aux = forward(cfg, params, h, causal=True, remat=remat)
    logits = common.lm_head(cfg, params.embed, h)
    mesh, (_, seq) = sharding.runtime_mesh(), sharding.runtime_batch_spec()
    count = None
    if mesh is not None and seq is not None:
        # a slice of the sequence: its sum over its rows' mean share of
        # their labels, as the trainer averages the loss over the ranks
        n = math.prod(mesh.shape[a] for a in sharding.spec_axes(seq))
        count = spmd.all_reduce((labels != -1).sum().float(), mesh, seq,
                                tag="loss") / n
    return common.cross_entropy(logits, labels, count=count) + aux


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
        h = h + _mix(cfg, lp, h, moe_dropless=moe_dropless, ep=True)
        pad = max_len - S
        ks.append(torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)))
        vs.append(torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)))
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h[:, -1:])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if return_hidden:
        return logits, cache, h
    return logits, cache


def decode_step(cfg: ArchCfg, params: TransformerLM, token: torch.Tensor,
                cache: dict, pos: int):
    """token: (B, 1) int; cache {"k", "v"}: (L, B, S_max, Hkv, hd); pos: the
    position this token writes to.  Returns (logits (B, 1, V), cache), the
    cache written in place."""
    h = common.embed_tokens(params.embed, token)
    freqs = common.rope_freqs(cfg, h.device)
    for i, lp in enumerate(params.layers):
        x = common.apply_norm(cfg, lp.ln1, h)
        a, _, _ = attn.attn_decode(cfg, lp.attn, x, cache["k"][i],
                                   cache["v"][i], pos, freqs=freqs)
        h = h + a
        h = h + _mix(cfg, lp, h)
    h = common.apply_norm(cfg, params.final_norm, h)
    return common.lm_head(cfg, params.embed, h), cache
