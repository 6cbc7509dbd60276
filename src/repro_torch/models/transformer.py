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

import dataclasses
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
         moe_dropless: bool = False, ep: bool = False,
         mode: str | None = None) -> torch.Tensor:
    """The feed-forward half of a layer, on the residual stream h; an MoE
    layer dispatches dropless when asked, else expert-parallel where
    ``ep`` and the config say so (JAX's prefill), else with capacity
    (JAX's decode step), each on the rank's experts under a mesh
    (``moe.apply_moe_tp``).  ``mode`` is serving's under a mesh
    (``_prefill_mode``): "heads" runs the MLP on the rank's d_ff slice
    where d_ff divides; "kv" (h a slice of the sequence) sends the whole
    sequence through an MoE layer and keeps the slice."""
    x2 = common.apply_norm(cfg, lp.ln2, h)
    mesh = sharding.runtime_mesh()
    if cfg.moe is None:
        tp = 1 if mode != "heads" else sharding.tp_size(mesh, cfg)
        if tp <= 1 or cfg.d_ff % tp:
            return common.apply_mlp(cfg, lp.mlp, x2)
        return common.apply_mlp(cfg, lp.mlp, x2, w=_local(lp.mlp, mesh),
                                reduce=_act_sum(mesh))
    if mode == "kv":
        s = x2.shape[1]
        spec = sharding.runtime_batch_spec()
        sharding.set_runtime_mesh(mesh, (spec[0], None))
        try:
            y = _mix_moe(cfg, lp, spmd.all_gather(x2, 1, mesh, "model",
                                                  tag="seq"),
                         moe_dropless, ep)
        finally:
            sharding.set_runtime_mesh(mesh, spec)
        return y.narrow(1, mesh.axis_index("model") * s, s)
    return _mix_moe(cfg, lp, x2, moe_dropless, ep)


def _mix_moe(cfg: ArchCfg, lp: Block, x2: torch.Tensor, dropless: bool,
             ep: bool) -> torch.Tensor:
    if not dropless and ep and cfg.moe_impl == "ep_a2a":
        return moe.apply_moe_ep(cfg, lp.moe, x2)[0]
    return moe.apply_moe_tp(cfg, lp.moe, x2, dropless=dropless)[0]


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

    def gather(x):
        return x if mode == "allreduce" else _seq_gather(x, mesh, mode)

    def reduce(part):
        return _reduce(part, mesh, mode, dtype)

    a, _ = attn.attn_full(cfg, lp.attn,
                          gather(common.apply_norm(cfg, lp.ln1, h)),
                          freqs=freqs, causal=causal,
                          w=_local(lp.attn, mesh),
                          heads=(cfg.n_heads // tp, cfg.n_kv_heads // tp))
    h = h + reduce(a)
    return h + common.apply_mlp(cfg, lp.mlp,
                                gather(common.apply_norm(cfg, lp.ln2, h)),
                                w=_local(lp.mlp, mesh), reduce=reduce)


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

    cache: {"k", "v"} of shape (L, B, max_len, Hkv, hd); under a runtime
    mesh with a "model" axis of more than one rank, this rank's shard of
    it as ``decode_state_specs`` lays it out, and "max_len", the whole
    cache's depth, from which ``decode_step`` reads that layout."""
    mesh = sharding.runtime_mesh()
    rows, seq = sharding.runtime_batch_spec()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        mesh = None
    if mesh is not None and seq is not None and "prefix_embeds" in batch:
        # the prefix and the tokens come cut apart: the whole sequence
        batch = dict(batch, **{k: spmd.all_gather(batch[k], 1, mesh, seq,
                                                  tag="seq")
                               for k in ("tokens", "prefix_embeds")})
        seq = None
    h, _ = embed_inputs(cfg, params, batch)
    sliced = mesh is not None and seq is not None
    n = math.prod(mesh.shape[a] for a in sharding.spec_axes(seq)) \
        if sliced else 1
    B, S = h.shape[0], h.shape[1] * n        # S: the whole sequence
    # VLM prefix embeddings extend S beyond the token budget: the cache must
    # cover the full (prefix + tokens) context
    max_len = max(max_len or S, S)
    freqs = common.rope_freqs(cfg, h.device)
    mode = _prefill_mode(cfg, mesh, S)
    reduce, akw = (lambda a: a), {}
    if mode == "heads":
        tp = mesh.shape["model"]
        akw["heads"] = (cfg.n_heads // tp, cfg.n_kv_heads // tp)
        reduce = _act_sum(mesh)
    elif mode == "kv":             # this rank's slice of the sequence
        s = S // mesh.shape["model"]
        i0 = mesh.axis_index("model") * s
        if not sliced:
            h = h.narrow(1, i0, s)
        akw["positions"] = (i0 + torch.arange(s, device=h.device))[None]
        akw["kv"] = functools.partial(_gather_kv, mesh=mesh, causal=True)
    ks, vs = [], []
    for lp in params.layers:
        x = common.apply_norm(cfg, lp.ln1, h)
        w = _local(lp.attn, mesh) if mode == "heads" else None
        a, (k, v) = attn.attn_full(cfg, lp.attn, x, freqs=freqs, causal=True,
                                   w=w, **akw)
        h = h + reduce(a)
        h = h + _mix(cfg, lp, h, moe_dropless=moe_dropless, ep=True,
                     mode=mode)
        ks.append(k)
        vs.append(v)
    h = common.apply_norm(cfg, params.final_norm, h)
    last = h[:, -1:]
    if mode == "kv":    # the last position is the last slice's
        last = spmd.all_gather(last, 1, mesh, "model", tag="seq")[:, -1:]
        if return_hidden:
            h = spmd.all_gather(h, 1, mesh, "model", tag="seq")
    logits = common.lm_head(cfg, params.embed, last)
    src = (None, rows, "model" if mode == "kv" else None,
           "model" if mode == "heads" else None, None)
    cache = {"k": _cache_out(cfg, ks, src, B, S, max_len, mesh),
             "v": _cache_out(cfg, vs, src, B, S, max_len, mesh)}
    if mesh is not None:
        cache["max_len"] = max_len
    if return_hidden:
        return logits, cache, h
    return logits, cache


def decode_step(cfg: ArchCfg, params: TransformerLM, token: torch.Tensor,
                cache: dict, pos: int):
    """token: (B, 1) int; cache {"k", "v"}: (L, B, S_max, Hkv, hd); pos: the
    position this token writes to.  Returns (logits (B, 1, V), cache), the
    cache written in place.

    Under a runtime mesh with a "model" axis of more than one rank, token
    holds this rank's rows and the cache its shard as
    ``decode_state_specs`` lays out a cache of depth ``cache["max_len"]``
    (for the serving config: TP specs even under dp_only, as JAX's dry run
    serves; ``prefill`` returns it so): attention runs on the
    rank's KV heads ("heads"), or every head on the rank's slice of the
    positions with the slices' log-sum-exp combined ("seq"); any other
    layout is gathered over "model" where a layer reads it and cut back
    after.  The MLP runs on the rank's d_ff slice where d_ff divides, an
    MoE layer on the rank's experts (``moe.apply_moe_tp``)."""
    mesh = sharding.runtime_mesh()
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        return _decode_tp(serving_cfg(cfg), params, token, cache, pos, mesh)
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


# ----------------------------------------------------------------------------
# serving under a mesh: prefill and decode_step as one rank's part of JAX's
# partitioned program (its in_shardings: param_specs, batch_specs,
# decode_state_specs).  Each rank holds its shards; a decode cache is laid
# out by decode_state_specs:
#
#   "heads": (L, B/dp, S, Hkv/tp, hd)  this rank's heads: q/k/v from its
#            column slices, out @ wo's rows --AR--> ; MLP on its d_ff
#            slice --AR-->
#   "seq":   (L, B/dp, S/tp, Hkv, hd)  every head: q/k/v column slices
#            --AG-->, the rank's keys -> (o, m, l) --AR max, AR sum-->
#            combined o, its columns @ wo's rows --AR--> ; MLP as above
#
# prefill returns its cache in that layout, with the whole cache's depth
# ("max_len"), which is what names the layout (a rank's shard alone does
# not: a slice of a deep cache has the shape of a shallow whole one):
# "heads" straight from the rank's heads; "kv" (the sequence over
# "model", from the batch spec under dp_only or where the KV heads do not
# divide) the rank's slice of K/V, moved to its slice of max_len where
# that is deeper; anything else re-laid by spmd.relayout, a layer at a
# time.
# ----------------------------------------------------------------------------

def serving_cfg(cfg: ArchCfg) -> ArchCfg:
    """The config a decode step runs under a mesh: JAX serves with
    TP-sharded parameters even for dp_only-trained archs (its dry run's
    ``build_decode``), since decode is weight-read-bound."""
    if cfg.parallelism == "dp_only":
        return dataclasses.replace(cfg, parallelism="tp_dp")
    return cfg


def _prefill_mode(cfg: ArchCfg, mesh, S: int) -> str | None:
    """How prefill runs under the registered mesh (None: no mesh, or a
    "model" axis of one rank): None (the plain layers on this rank's rows,
    sharded leaves gathered where read), "heads" (attention on the rank's
    heads, the MLP on its d_ff slice where d_ff divides, an MoE layer on
    its experts) or "kv" (the plain layers on the rank's slice of the
    sequence, K/V gathered a layer: the batch spec puts the sequence over
    "model", or the KV heads do not divide and S does).  S is the whole
    sequence, VLM prefix included."""
    if mesh is None or cfg.n_heads == 0:
        return None
    batch, seq = (sharding.spec_axes(e)
                  for e in sharding.runtime_batch_spec())
    if "model" in seq:
        return "kv"
    tp = sharding.tp_size(mesh, cfg)
    if "model" in batch or tp <= 1:
        return None    # the ranks of a "model" line hold other rows
    if not (cfg.n_heads % tp or cfg.n_kv_heads % tp):
        return "heads"
    return None if S % tp else "kv"


def _local(p, mesh):
    """A weight getter of this rank's slices: column-parallel weights by
    their output dim, row-parallel ones by their input dim."""
    return lambda name: spmd.tp_slice(
        p.local(name), 0 if name in _ROW_PARALLEL else -1, mesh)


def _act_sum(mesh):
    """The sum over "model" of a row-parallel product's partials."""
    return functools.partial(spmd.all_reduce, mesh=mesh, entry="model",
                             tag="act")


def _cache_out(cfg: ArchCfg, ts: list, src: tuple, B: int, S: int,
               max_len: int, mesh) -> torch.Tensor:
    """The layers' K or V, each (rows, S, Hkv, hd) as prefill computed it
    under spec ``src`` (its first entry the layers'), padded to
    ``max_len`` and laid out as the decode step takes it: (L, ...) this
    rank's shard.  One layer at a time, so that a rank holds no more than
    one layer's whole sequence beside its shards."""
    pad = (0, 0, 0, 0, 0, max_len - S)
    if mesh is None:
        return torch.nn.functional.pad(torch.stack(ts), pad)
    rows, seq, heads = src[1:4]
    Bg = B * math.prod(mesh.shape[a] for a in sharding.spec_axes(rows))
    _, dst = sharding.cache_layout(serving_cfg(cfg), mesh, Bg, max_len)
    idx, n = spmd.axis_index(mesh, dst[0])      # the layers this rank keeps
    per = len(ts) // n
    out = None
    for i, t in enumerate(ts):
        at = seq
        if seq is not None and (max_len != S or sharding.spec_axes(dst[2])
                                != sharding.spec_axes(seq)):
            t, at = spmd.all_gather(t, 1, mesh, seq, tag="cache"), None
        if at is None and max_len != S:
            t = torch.nn.functional.pad(t, pad)
        t = spmd.relayout(t, (rows, at, heads), dst[1:], mesh, tag="cache")
        if i // per == idx:      # copied out of the whole layer it cuts
            if out is None:
                out = t.new_empty((per,) + tuple(t.shape))
            out[i % per].copy_(t)
    return out


def _attn_seq(cfg: ArchCfg, p, x: torch.Tensor, kc: torch.Tensor,
              vc: torch.Tensor, pos: int, freqs, mesh) -> torch.Tensor:
    """The "seq" layout's attention in a decode step, p the attention's
    parameters and kc and vc (B, S, Hkv, hd) this rank's slice of the
    positions: every head's q, k and v
    (where the heads' widths divide "model", from the rank's column slices
    of wq, wk and wv, the three products gathered at once); the new row
    written by the rank whose slice holds ``pos``; the slice's softmax
    partials combined over "model" (a max and a sum all-reduce); and the
    product with wo (where the widths divide, with the rank's rows of it,
    a partial summed over "model")."""
    tp, idx = mesh.shape["model"], mesh.axis_index("model")
    B, S = x.shape[0], kc.shape[1]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if not 0 <= pos < S * tp:
        raise IndexError(f"decode position {pos} is past a cache of "
                         f"{S * tp}")
    split = not (H * hd % tp or Hkv * hd % tp)
    w = _local(p, mesh) if split else p.__getitem__
    q, k, v = attn.qkv_products(cfg, w, x, x)
    if split:
        nq, nqk = q.shape[-1], q.shape[-1] + k.shape[-1]
        parts = spmd.all_gather(torch.cat([q, k, v], -1)[..., None, :], -2,
                                mesh, "model", tag="qkv")
        q, k, v = (parts[..., nq0:nq1].flatten(-2)
                   for nq0, nq1 in ((0, nq), (nq, nqk), (nqk, None)))
    q, k, v = (q.reshape(B, 1, H, hd), k.reshape(B, 1, Hkv, hd),
               v.reshape(B, 1, Hkv, hd))
    if freqs is not None:
        q, k = attn.rope_at(q, k, pos, freqs)
    start = idx * S
    if start <= pos < start + S:
        kc[:, pos - start] = k[:, 0].to(kc.dtype)
        vc[:, pos - start] = v[:, 0].to(vc.dtype)
    visible = start + torch.arange(S, device=x.device) <= pos
    o, m, l = attn.decode_partials(cfg, q[:, 0], kc, vc, visible)
    o = attn.combine_partials(
        o[None], m[None], l[None],
        rmax=lambda t: spmd.all_reduce_max(t, mesh, "model", tag="combine"),
        rsum=lambda t: spmd.all_reduce(t, mesh, "model", tag="combine"))
    return out_rows(p, o.to(x.dtype).reshape(B, 1, -1), mesh, split)


def out_rows(p, o: torch.Tensor, mesh, split: bool) -> torch.Tensor:
    """o (B, S, H hd), every head's attention output on every rank of a
    "model" line, times wo: with ``split`` (the heads' width divides
    "model") the rank's columns of o by its rows of wo, the partials
    summed over "model"; else o by the whole (gathered) wo."""
    if not split:
        return o @ p["wo"]
    c = o.shape[-1] // mesh.shape["model"]
    return _act_sum(mesh)(o.narrow(-1, mesh.axis_index("model") * c, c)
                          @ _local(p, mesh)("wo"))


def decode_cache_in(cache: dict, layout, spec, mesh) -> dict:
    """The caches {"k", "v"} a decode step's layers read: ``cache`` itself,
    or, where the "other" layout splits the layers, the whole stack of the
    rank's rows (re-laid once; ``decode_cache_out`` lays it back)."""
    if layout == "other" and spec[0] is not None:
        want = sharding.P(None, sharding.runtime_batch_spec()[0], None,
                          None, None)
        return {n: spmd.relayout(cache[n], spec, want, mesh, tag="cache")
                for n in ("k", "v")}
    return cache


def decode_cache_out(cache: dict, work: dict, spec, mesh) -> None:
    """``work``'s rows written back to ``cache``'s shards, where
    ``decode_cache_in`` re-laid the stack."""
    if work is not cache:
        want = sharding.P(None, sharding.runtime_batch_spec()[0], None,
                          None, None)
        for n in ("k", "v"):
            cache[n].copy_(spmd.relayout(work[n], want, spec, mesh))


def decode_attn(cfg: ArchCfg, p, x: torch.Tensor, cache: dict, work: dict,
                i: int, layout, spec, pos: int, freqs, mesh) -> torch.Tensor:
    """Layer ``i``'s self-attention in a decode step's rank program, p its
    parameters, the cache laid out by ``sharding.cache_layout`` (``layout``,
    ``spec``) and read from ``work`` (``decode_cache_in``): the rank's KV
    heads ("heads"), every head on the rank's slice of the positions
    ("seq"), else every head on every key, the layer's cache gathered over
    "model" where read and cut back after.  The result summed over
    "model"."""
    tp = mesh.shape["model"]
    kc, vc = work["k"][i], work["v"][i]
    if layout == "heads":
        return _act_sum(mesh)(attn.attn_decode(
            cfg, p, x, kc, vc, pos, freqs=freqs, w=_local(p, mesh),
            heads=(cfg.n_heads // tp, cfg.n_kv_heads // tp))[0])
    if layout == "seq":
        return _attn_seq(cfg, p, x, kc, vc, pos, freqs, mesh)
    lay = work is cache and layout == "other"
    want = (sharding.runtime_batch_spec()[0], None, None, None)
    if lay:
        kc, vc = (spmd.relayout(t, spec[1:], want, mesh, tag="cache")
                  for t in (kc, vc))
    a = attn.attn_decode(cfg, p, x, kc, vc, pos, freqs=freqs)[0]
    if lay:
        for t, full in ((work["k"][i], kc), (work["v"][i], vc)):
            t.copy_(spmd.relayout(full, want, spec[1:], mesh))
    return a


def _decode_tp(cfg: ArchCfg, params: TransformerLM, token: torch.Tensor,
               cache: dict, pos: int, mesh):
    """``decode_step``'s rank program on a "model" axis of tp > 1 ranks."""
    rows = sharding.runtime_batch_spec()[0]
    B = token.shape[0] * math.prod(mesh.shape[a]
                                   for a in sharding.spec_axes(rows))
    if "max_len" not in cache:
        raise ValueError("decode_step under a mesh takes the cache that "
                         "prefill returns there, with its depth (max_len)")
    layout, spec = sharding.cache_layout(cfg, mesh, B, cache["max_len"])
    whole = (cfg.n_layers, B, cache["max_len"], cfg.n_kv_heads,
             cfg.resolved_head_dim)
    local = tuple(d // spmd.axis_index(mesh, e)[1]
                  for d, e in zip(whole, spec))
    if tuple(cache["k"].shape) != local:
        raise ValueError(f"decode_step: a cache shard of shape "
                         f"{tuple(cache['k'].shape)}, where decode_state_"
                         f"specs gives {local}")
    work = decode_cache_in(cache, layout, spec, mesh)
    h = common.embed_tokens(params.embed, token)
    freqs = common.rope_freqs(cfg, h.device)
    for i, lp in enumerate(params.layers):
        x = common.apply_norm(cfg, lp.ln1, h)
        h = h + decode_attn(cfg, lp.attn, x, cache, work, i, layout, spec,
                            pos, freqs, mesh)
        h = h + _mix(cfg, lp, h, mode="heads")
    decode_cache_out(cache, work, spec, mesh)
    h = common.apply_norm(cfg, params.final_norm, h)
    return common.lm_head(cfg, params.embed, h), cache
