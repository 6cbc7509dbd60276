"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The counterpart of the JAX package's ``models/encdec.py``.  The conv1d mel
frontend is a stub there and here: callers hand in precomputed frame
embeddings (B, n_frames, d_model).  The encoder is a non-causal
transformer over the frames with a learned positional table; the decoder
is a causal transformer (RoPE positions, as in the JAX package) with
cross-attention to the encoder output.  Every attention of the encoder,
of the decoder's prefill and of its cross-attention goes through
``ops.flash_attention``, so through the kernel K2 on the card (K2-bwd for
its gradient); the decoder's self-attention in a decode step is inline
PyTorch against the dense cache (``attention.attn_decode``), as JAX's is
inline jnp.

The layer stacks are ``nn.ModuleList``s walked with Python loops (JAX:
``lax.scan`` over ``enc_layers`` and ``dec_layers``, stacked separately);
``remat=True`` recomputes each layer in the backward
(``torch.utils.checkpoint``, as JAX's ``nothing_saveable`` checkpoint).

Decode state, from ``prefill(..., max_len=)``: ``k``/``v`` the decoder's
self-attention caches (L, B, max_len, Hkv, hd), JAX's layout, written in
place by ``decode_step``; ``cross_k``/``cross_v`` the encoder's K/V for
every decoder layer, kept in the kernel's (L, B, Hkv, F, hd) layout where
JAX keeps (L, B, F, Hkv, hd), so that no decode step copies them.

Under a runtime mesh whose "model" axis has more than one rank, ``prefill``
and ``decode_step`` run one rank's part of JAX's partitioned program (the
section "serving under a mesh" below); the state is then the rank's
``decode_state_specs`` shard (``sharding.encdec_layout``) with its depth.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import common, transformer
from repro_torch.models.common import ArchCfg, dense_init
from repro_torch.parallel import sharding, spmd


class EncLayer(nn.Module):
    """One encoder layer: ln1 -> self-attention, ln2 -> MLP."""

    def __init__(self, cfg: ArchCfg, gen, device) -> None:
        super().__init__()
        self.ln1 = common.init_norm(cfg, device)
        self.ln2 = common.init_norm(cfg, device)
        self.attn = attn.init_attn(cfg, gen, device)
        self.mlp = common.init_mlp(cfg, gen, device)


class DecLayer(nn.Module):
    """One decoder layer: ln1 -> causal self-attention, ln2 ->
    cross-attention to the encoder output, ln3 -> MLP."""

    def __init__(self, cfg: ArchCfg, gen, device) -> None:
        super().__init__()
        self.ln1 = common.init_norm(cfg, device)
        self.ln2 = common.init_norm(cfg, device)
        self.ln3 = common.init_norm(cfg, device)
        self.self_attn = attn.init_attn(cfg, gen, device)
        self.cross_attn = attn.init_attn(cfg, gen, device)
        self.mlp = common.init_mlp(cfg, gen, device)


class EncDecLM(nn.Module):
    """Parameters named like the JAX pytree (``embed.tok``, ``enc_pos``,
    ``enc_layers.<i>.attn.wq``, ``dec_layers.<i>.cross_attn.wk``,
    ``enc_norm.scale``, ``final_norm.scale``, ...)."""

    def __init__(self, cfg: ArchCfg, *, device,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = common.init_embed(cfg, generator, device)
        self.enc_pos = nn.Parameter(
            dense_init(generator, (cfg.n_frames, cfg.d_model), cfg.dtype,
                       device, scale=0.02), requires_grad=False)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, generator, device)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, generator, device)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = common.init_norm(cfg, device)
        self.final_norm = common.init_norm(cfg, device)


def init_lm(cfg: ArchCfg, generator: torch.Generator) -> EncDecLM:
    """Random weights drawn from ``generator``, on the generator's device."""
    return EncDecLM(cfg, device=generator.device, generator=generator)


def _enc_layer(cfg: ArchCfg, lp: EncLayer, h: torch.Tensor,
               kv=None) -> torch.Tensor:
    a, _ = attn.attn_full(cfg, lp.attn, common.apply_norm(cfg, lp.ln1, h),
                          freqs=None, causal=False, kv=kv)
    h = h + a
    return h + common.apply_mlp(cfg, lp.mlp,
                                common.apply_norm(cfg, lp.ln2, h))


def encode(cfg: ArchCfg, params: EncDecLM, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """frames: (B, n_frames, d) stub embeddings -> encoder output."""
    h = frames.to(cfg.dtype) + common.full(params.enc_pos)[None]
    for lp in params.enc_layers:
        h = common.run_layer(_enc_layer, remat, cfg, lp, h)
    return common.apply_norm(cfg, params.enc_norm, h)


def _cross_kv(cfg: ArchCfg, lp: DecLayer, enc_out: torch.Tensor, *,
              w=None, n_kv: int | None = None):
    """One decoder layer's cross-attention K/V from the encoder output, as
    contiguous (B, Hkv, F, hd): the kernel's layout (JAX: (B, F, Hkv, hd)).
    ``w`` reads a weight by name and ``n_kv`` is the KV heads its weights
    give (default: the layer's own; a head-parallel rank's slices)."""
    B, Fr, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    w = w or lp.cross_attn.__getitem__
    k = enc_out @ w("wk")
    v = enc_out @ w("wv")
    if cfg.qkv_bias:
        k, v = k + w("bk"), v + w("bv")
    return tuple(t.reshape(B, Fr, n_kv or cfg.n_kv_heads, hd)
                 .transpose(1, 2).contiguous() for t in (k, v))


def _dec_layer(cfg: ArchCfg, lp: DecLayer, h: torch.Tensor,
               enc_out: torch.Tensor, freqs):
    """One decoder layer over the whole sequence; returns (h, (k, v), ckv):
    the self-attention K/V and the cross K/V."""
    a, kv = attn.attn_full(cfg, lp.self_attn,
                           common.apply_norm(cfg, lp.ln1, h), freqs=freqs,
                           causal=True)
    h = h + a
    ckv = _cross_kv(cfg, lp, enc_out)
    h = h + attn.attn_cross(cfg, lp.cross_attn,
                            common.apply_norm(cfg, lp.ln2, h), ckv)
    h = h + common.apply_mlp(cfg, lp.mlp, common.apply_norm(cfg, lp.ln3, h))
    return h, kv, ckv


def decode_stack(cfg: ArchCfg, params: EncDecLM, h: torch.Tensor,
                 enc_out: torch.Tensor, *, remat: bool = True
                 ) -> torch.Tensor:
    freqs = common.rope_freqs(cfg, h.device)
    for lp in params.dec_layers:
        h = common.run_layer(_dec_layer, remat, cfg, lp, h, enc_out, freqs)[0]
    return common.apply_norm(cfg, params.final_norm, h)


def train_loss(cfg: ArchCfg, params: EncDecLM, batch: dict, *,
               remat: bool = True) -> torch.Tensor:
    enc_out = encode(cfg, params, batch["frames"], remat=remat)
    h = common.embed_tokens(params.embed, batch["tokens"])
    h = decode_stack(cfg, params, h, enc_out, remat=remat)
    logits = common.lm_head(cfg, params.embed, h)
    return common.cross_entropy(logits, batch["labels"])


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------

def prefill(cfg: ArchCfg, params: EncDecLM, batch: dict, *,
            max_len: int | None = None, remat: bool = True):
    """Encode frames + prefill decoder tokens.  Returns (last-token logits
    (B, 1, V), state); the self-attention K/V are padded to ``max_len``
    (default: the prompt length).  ``remat`` only matters under grad.

    Under a runtime mesh whose "model" axis has more than one rank (and
    holds no batch rows), one rank's part of JAX's partitioned prefill
    (``_prefill_tp``): the state is this rank's ``decode_state_specs``
    shard (``sharding.encdec_layout``) and carries "max_len", the self-
    attention caches' whole depth, from which ``decode_step`` reads it."""
    mesh = sharding.serving_mesh(cfg)
    if mesh is not None:
        return _prefill_tp(cfg, params, batch, max_len, mesh)
    enc_out = encode(cfg, params, batch["frames"], remat=remat)
    h = common.embed_tokens(params.embed, batch["tokens"])
    S = h.shape[1]
    pad = (max_len or S) - S
    freqs = common.rope_freqs(cfg, h.device)
    ks, vs, cks, cvs = [], [], [], []
    for lp in params.dec_layers:
        h, (k, v), (ck, cv) = _dec_layer(cfg, lp, h, enc_out, freqs)
        ks.append(F.pad(k, (0, 0, 0, 0, 0, pad)))
        vs.append(F.pad(v, (0, 0, 0, 0, 0, pad)))
        cks.append(ck)
        cvs.append(cv)
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h[:, -1:])
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs)}


def decode_step(cfg: ArchCfg, params: EncDecLM, token: torch.Tensor,
                state: dict, pos: int):
    """token: (B, 1); ``pos``: the position this token writes to.  Returns
    (logits (B, 1, V), state), the self-attention caches written in
    place; the cross K/V are read as they are.

    Under a runtime mesh whose "model" axis has more than one rank, token
    holds this rank's rows and the state its ``decode_state_specs`` shard
    with the caches' depth ("max_len"), as ``prefill`` returns it there:
    one rank's part of JAX's partitioned decode step (``_decode_tp``)."""
    mesh = sharding.serving_mesh(cfg)
    if mesh is not None:
        return _decode_tp(transformer.serving_cfg(cfg), params, token, state,
                          pos, mesh)
    h = common.embed_tokens(params.embed, token)
    freqs = common.rope_freqs(cfg, h.device)
    for i, lp in enumerate(params.dec_layers):
        a, _, _ = attn.attn_decode(cfg, lp.self_attn,
                                   common.apply_norm(cfg, lp.ln1, h),
                                   state["k"][i], state["v"][i], pos,
                                   freqs=freqs)
        h = h + a
        h = h + attn.attn_cross(cfg, lp.cross_attn,
                                common.apply_norm(cfg, lp.ln2, h),
                                (state["cross_k"][i], state["cross_v"][i]))
        h = h + common.apply_mlp(cfg, lp.mlp,
                                 common.apply_norm(cfg, lp.ln3, h))
    h = common.apply_norm(cfg, params.final_norm, h)
    return common.lm_head(cfg, params.embed, h), state


# ----------------------------------------------------------------------------
# serving under a mesh: prefill and decode_step as one rank's part of JAX's
# partitioned program (in_shardings: param_specs, batch_specs,
# decode_state_specs), each rank holding its shards.  The state's layouts
# (sharding.encdec_layout):
#
#   self k/v (L, B, S, Hkv, hd): as a decoder's cache ("heads", "seq", or
#       anything else gathered where read; models/transformer.py)
#   cross k/v (L, B, Hkv, F, hd):
#     "heads":  the rank's KV heads: q from its wq columns, K2 on its
#               heads, out @ its wo rows --AR-->
#     "frames": every head on the rank's frames: q's column slices --AG-->,
#               K2 with its LSE, combined --AR max, AR sum-->, o's columns
#               @ wo's rows --AR-->
#     "layers": the owner computes: q --AG-->, the rank holding the layer
#               runs K2 on all its frames and --broadcast--> o (B, 1, H hd),
#               o's columns @ wo's rows --AR--> (the layer's K/V never
#               moves)
#     None:     the rank's rows whole: as "layers", every rank its own K2
#
# prefill: the encoder on its heads ("heads"), on its slice of the frames
# ("kv": K/V gathered a layer, the output gathered after), or whole; the
# decoder's self-attention as a decoder's prefill (_prefill_mode), its
# cross-attention on the rank's heads or against all of them; each layer's
# cross K/V re-laid to its spec where computed (spmd.layer_out), the self
# K/V by transformer._cache_out.  The MLP runs on the rank's d_ff slice
# where the layer runs its heads.
# ----------------------------------------------------------------------------

def _enc_mode(cfg: ArchCfg, tp: int) -> str | None:
    """How the encoder runs on a "model" line of tp ranks: "heads" where
    the heads, KV heads and d_ff divide tp, else "kv" (the rank's slice of
    the frames) where the frames do, else None (every layer whole)."""
    if not (cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp):
        return "heads"
    return None if cfg.n_frames % tp else "kv"


def _encode_tp(cfg: ArchCfg, params: EncDecLM, frames: torch.Tensor,
               mesh) -> torch.Tensor:
    """``encode`` on a "model" line (``_enc_mode``); every rank ends with
    its rows' whole encoder output."""
    tp = mesh.shape["model"]
    mode = _enc_mode(cfg, tp)
    h = frames.to(cfg.dtype) + common.full(params.enc_pos)[None]
    kv = None
    if mode == "kv":
        n = h.shape[1] // tp
        h = h.narrow(1, mesh.axis_index("model") * n, n)
        kv = functools.partial(transformer._gather_kv, mesh=mesh,
                               causal=False)
    for lp in params.enc_layers:
        if mode == "heads":
            h = transformer._tp_layer_fwd(cfg, lp, h, None, False,
                                          "allreduce")
        else:
            h = _enc_layer(cfg, lp, h, kv)
    h = common.apply_norm(cfg, params.enc_norm, h)
    if mode == "kv":
        h = spmd.all_gather(h, 1, mesh, "model", tag="seq")
    return h


def _mlp_tp(cfg: ArchCfg, lp: DecLayer, h: torch.Tensor, mesh,
            heads: bool) -> torch.Tensor:
    """A decoder layer's MLP: on the rank's d_ff slice where ``heads`` and
    d_ff divides "model" (the partials summed), else whole."""
    x3 = common.apply_norm(cfg, lp.ln3, h)
    if not heads or cfg.d_ff % mesh.shape["model"]:
        return common.apply_mlp(cfg, lp.mlp, x3)
    return common.apply_mlp(cfg, lp.mlp, x3, w=transformer._local(lp.mlp,
                                                                  mesh),
                            reduce=transformer._act_sum(mesh))


def _cross_spec_layout(spec) -> str | None:
    """The cross K/V's layout from its spec over (L, B, Hkv, F, hd):
    "layers", "heads", "frames", None (not split over "model") or "other"
    (the batch rows over "model")."""
    at = [i for i, e in enumerate(spec)
          if "model" in sharding.spec_axes(e)]
    return {(): None, (0,): "layers", (2,): "heads",
            (3,): "frames"}.get(tuple(at), "other")


def _prefill_tp(cfg: ArchCfg, params: EncDecLM, batch: dict,
                max_len: int | None, mesh):
    """``prefill``'s rank program on a "model" axis of tp > 1 ranks."""
    enc_out = _encode_tp(cfg, params, batch["frames"], mesh)
    h = common.embed_tokens(params.embed, batch["tokens"])
    rows = sharding.runtime_batch_spec()[0]
    B, S = h.shape[:2]
    Bg = B * math.prod(mesh.shape[a] for a in sharding.spec_axes(rows))
    max_len = max(max_len or S, S)
    tp = mesh.shape["model"]
    L = cfg.n_layers
    freqs = common.rope_freqs(cfg, h.device)
    mode = transformer._prefill_mode(cfg, mesh, S)
    akw, heads, act = {}, None, (lambda a: a)
    if mode == "heads":
        heads = (cfg.n_heads // tp, cfg.n_kv_heads // tp)
        act = transformer._act_sum(mesh)
    elif mode == "kv":              # this rank's slice of the sequence
        s = S // tp
        i0 = mesh.axis_index("model") * s
        h = h.narrow(1, i0, s)
        akw["positions"] = (i0 + torch.arange(s, device=h.device))[None]
        akw["kv"] = functools.partial(transformer._gather_kv, mesh=mesh,
                                      causal=True)
    cspec = sharding.encdec_layout(cfg, mesh, Bg, max_len)["cross_k"][0]
    csrc = (rows, "model" if heads else None, None, None)
    ks, vs, cks, cvs = [], [], [], []
    for i, lp in enumerate(params.dec_layers):
        w = transformer._local(lp.self_attn, mesh) if heads else None
        a, (k, v) = attn.attn_full(cfg, lp.self_attn,
                                   common.apply_norm(cfg, lp.ln1, h),
                                   freqs=freqs, causal=True, w=w,
                                   heads=heads, **akw)
        h = h + act(a)
        w = transformer._local(lp.cross_attn, mesh) if heads else None
        ckv = _cross_kv(cfg, lp, enc_out, w=w, n_kv=heads and heads[1])
        h = h + act(attn.attn_cross(cfg, lp.cross_attn,
                                    common.apply_norm(cfg, lp.ln2, h), ckv,
                                    w=w, heads=heads))
        h = h + _mlp_tp(cfg, lp, h, mesh, heads is not None)
        ks.append(k)
        vs.append(v)
        for kept, t in zip((cks, cvs), ckv):
            t = spmd.layer_out(t, i, L, csrc, cspec, mesh, tag="cross")
            if t is not None:      # a copy: t may view the whole layer
                kept.append(t.clone())
    h = common.apply_norm(cfg, params.final_norm, h)
    last = h[:, -1:]
    if mode == "kv":    # the last position is the last slice's
        last = spmd.all_gather(last, 1, mesh, "model", tag="seq")[:, -1:]
    logits = common.lm_head(cfg, params.embed, last)
    src = (None, rows, "model" if mode == "kv" else None,
           "model" if heads else None, None)
    return logits, {
        "k": transformer._cache_out(cfg, ks, src, B, S, max_len, mesh),
        "v": transformer._cache_out(cfg, vs, src, B, S, max_len, mesh),
        "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs),
        "max_len": max_len}


def _cross_decode(cfg: ArchCfg, p, x: torch.Tensor, state: dict, i: int,
                  cspec, mesh) -> torch.Tensor:
    """Layer ``i``'s cross-attention in a decode step's rank program, by
    the cross K/V's layout (``_cross_spec_layout``); the result summed
    over "model"."""
    tp, idx = mesh.shape["model"], mesh.axis_index("model")
    layout = _cross_spec_layout(cspec)
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    if layout == "heads":
        ckv = (state["cross_k"][i], state["cross_v"][i])
        return transformer._act_sum(mesh)(attn.attn_cross(
            cfg, p, x, ckv, w=transformer._local(p, mesh),
            heads=(H // tp, cfg.n_kv_heads // tp)))
    # every head's q: the rank's column slices gathered where they divide
    split = not H * hd % tp
    if split:
        w = transformer._local(p, mesh)
        q = x @ w("wq")
        if cfg.qkv_bias:
            q = q + w("bq")
        q = spmd.all_gather(q, -1, mesh, "model", tag="q")
    else:
        q = x @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"]
    q = q.reshape(B, 1, H, hd).transpose(1, 2).contiguous()
    if layout == "frames":       # K2's LSE route on the rank's frames
        o, lse = ops.flash_attention(
            q, state["cross_k"][i], state["cross_v"][i], causal=False,
            compute_dtype=attn.compute_dtype(cfg), return_lse=True)
        o = attn.combine_lse(
            o[None], lse[None],
            rmax=lambda t: spmd.all_reduce_max(t, mesh, "model",
                                               tag="combine"),
            rsum=lambda t: spmd.all_reduce(t, mesh, "model",
                                           tag="combine")).to(x.dtype)
        o = o.transpose(1, 2).reshape(B, 1, H * hd)
    elif layout == "layers":      # the owner computes and broadcasts o
        per = cfg.n_layers // tp
        owner = i // per
        if owner == idx:
            ckv = (state["cross_k"][i % per], state["cross_v"][i % per])
            o = _cross_all(cfg, q, ckv)
        else:
            o = x.new_empty((B, 1, H * hd))
        o = spmd.broadcast(o, owner, mesh, "model", tag="cross")
    else:     # the rank's rows whole (re-laid where split otherwise)
        want = (sharding.runtime_batch_spec()[0], None, None, None)
        ckv = tuple(spmd.layer_in(state[n], i, cfg.n_layers, cspec, want,
                                  mesh, tag="cross")
                    for n in ("cross_k", "cross_v"))
        o = _cross_all(cfg, q, ckv)
    return transformer.out_rows(p, o, mesh, split)


def _cross_all(cfg: ArchCfg, q: torch.Tensor, ckv) -> torch.Tensor:
    """q (B, H, 1, hd) against every frame of the cross K/V (K2): the
    output (B, 1, H hd)."""
    o = ops.flash_attention(q, *ckv, causal=False,
                            compute_dtype=attn.compute_dtype(cfg))
    return o.transpose(1, 2).reshape(q.shape[0], 1, -1)


def _decode_tp(cfg: ArchCfg, params: EncDecLM, token: torch.Tensor,
               state: dict, pos: int, mesh):
    """``decode_step``'s rank program on a "model" axis of tp > 1 ranks."""
    if "max_len" not in state:
        raise ValueError("decode_step under a mesh takes the state that "
                         "prefill returns there, with its depth (max_len)")
    rows = sharding.runtime_batch_spec()[0]
    Bg = token.shape[0] * math.prod(mesh.shape[a]
                                    for a in sharding.spec_axes(rows))
    layout = sharding.encdec_layout(cfg, mesh, Bg, state["max_len"])
    sharding.check_state_shards(layout, state, mesh)
    self_layout, spec = sharding.cache_layout(cfg, mesh, Bg,
                                              state["max_len"])
    cspec = layout["cross_k"][0]
    work = transformer.decode_cache_in(state, self_layout, spec, mesh)
    h = common.embed_tokens(params.embed, token)
    freqs = common.rope_freqs(cfg, h.device)
    for i, lp in enumerate(params.dec_layers):
        x = common.apply_norm(cfg, lp.ln1, h)
        h = h + transformer.decode_attn(cfg, lp.self_attn, x, state, work, i,
                                        self_layout, spec, pos, freqs, mesh)
        h = h + _cross_decode(cfg, lp.cross_attn,
                              common.apply_norm(cfg, lp.ln2, h), state, i,
                              cspec, mesh)
        h = h + _mlp_tp(cfg, lp, h, mesh, True)
    transformer.decode_cache_out(state, work, spec, mesh)
    h = common.apply_norm(cfg, params.final_norm, h)
    return common.lm_head(cfg, params.embed, h), state
