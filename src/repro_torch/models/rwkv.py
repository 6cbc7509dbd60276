"""RWKV6 (Finch) LM: token-shift time-mix with data-dependent decay and a
squared-ReLU channel-mix.  Attention-free: the decode state is O(1) in the
context (the token-shift vectors and the (dh x dh) wkv state per head).

The counterpart of the JAX package's ``models/rwkv.py``.  The wkv
recurrence runs through ``ops.rwkv6_scan``: the CUDA kernel K4 on the card,
the chunked plain version on the CPU.  JAX picks the per-token oracle for a
one-token step; the port sends every step, prefill and decode, through
``ops`` with the state in and out, which on the card is K4 with ``S = 1``
(the same function).  The configs' ``scan_impl`` knob is not read: the
tensors' device picks the implementation.  The layer stack is an
``nn.ModuleList`` walked with a Python loop (JAX: ``lax.scan`` over stacked
parameters).  Training (``train_loss(..., remat=True)``, JAX's default)
recomputes each layer in the backward, as JAX checkpoints its scan body;
on the card the scan's gradient is K4-bwd, through ``ops``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import common, transformer
from repro_torch.models.common import ArchCfg, Params, dense_init
from repro_torch.parallel import sharding, spmd

DECAY_LORA = 64


def _heads(cfg: ArchCfg):
    hd = cfg.resolved_head_dim
    return cfg.d_model // hd, hd


def init_time_mix(cfg: ArchCfg, gen, device) -> Params:
    d, dt, f32 = cfg.d_model, cfg.dtype, torch.float32
    H, hd = _heads(cfg)
    return Params(
        mu=torch.full((5, d), 0.5, dtype=dt, device=device),  # r,k,v,w,g
        w_r=dense_init(gen, (d, d), dt, device),
        w_k=dense_init(gen, (d, d), dt, device),
        w_v=dense_init(gen, (d, d), dt, device),
        w_g=dense_init(gen, (d, d), dt, device),
        w_o=dense_init(gen, (d, d), dt, device),
        w0=torch.full((d,), -3.0, dtype=f32, device=device),
        w_lora_a=dense_init(gen, (d, DECAY_LORA), f32, device),
        w_lora_b=dense_init(gen, (DECAY_LORA, d), f32, device, scale=0.01),
        u=dense_init(gen, (H, hd), f32, device, scale=0.1),
        gn_scale=torch.ones((d,), dtype=dt, device=device))


def init_channel_mix(cfg: ArchCfg, gen, device) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return Params(
        mu=torch.full((2, d), 0.5, dtype=dt, device=device),  # k, r
        w_k=dense_init(gen, (d, f), dt, device),
        w_v=dense_init(gen, (f, d), dt, device),
        w_r=dense_init(gen, (d, d), dt, device))


class RwkvBlock(nn.Module):
    """One layer: ln1 -> time-mix, ln2 -> channel-mix."""

    def __init__(self, cfg: ArchCfg, gen, device) -> None:
        super().__init__()
        self.ln1 = common.init_norm(cfg, device)
        self.ln2 = common.init_norm(cfg, device)
        self.tm = init_time_mix(cfg, gen, device)
        self.cm = init_channel_mix(cfg, gen, device)


class RwkvLM(nn.Module):
    """Parameters named like the JAX pytree (``layers.<i>.tm.w_r``, ...)."""

    def __init__(self, cfg: ArchCfg, *, device,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = common.init_embed(cfg, generator, device)
        self.layers = nn.ModuleList(RwkvBlock(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = common.init_norm(cfg, device)


def init_lm(cfg: ArchCfg, generator: torch.Generator) -> RwkvLM:
    """Random weights drawn from ``generator``, on the generator's device."""
    return RwkvLM(cfg, device=generator.device, generator=generator)


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None):
    """x_{t-1} along the sequence; the first step takes ``prev`` (decode)
    or zeros."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([first, x[:, :-1]], 1)


def _lerp(x, xx, mu):
    return x + (xx - x) * mu


def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    lo = torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    return torch.exp(-torch.exp(p["w0"] + lo))


def _head_norm(cfg: ArchCfg, p: Params, y: torch.Tensor,
               scale: torch.Tensor | None = None) -> torch.Tensor:
    """Per-head RMS normalisation of the wkv output (fp32 out); ``scale``
    is the gain of y's columns (default the whole ``gn_scale``: y every
    head)."""
    hd = cfg.resolved_head_dim
    shp = y.shape
    yf = y.float().reshape(shp[:-1] + (shp[-1] // hd, hd))
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + cfg.norm_eps)
    return yf.reshape(shp) * (p["gn_scale"] if scale is None
                              else scale).float()


def time_mix(cfg: ArchCfg, p: Params, x: torch.Tensor, *, state=None,
             return_state: bool = False):
    """x: (B, S, d).  state = (prev_token (B, d), wkv (B, H, dh, dh))."""
    H, hd = _heads(cfg)
    B, S, d = x.shape
    prev, wkv0 = (None, None) if state is None else state
    xx = _shift(x, prev)
    mr, mk, mv, mw, mg = p["mu"]
    r = (_lerp(x, xx, mr) @ p["w_r"]).reshape(B, S, H, hd)
    k = (_lerp(x, xx, mk) @ p["w_k"]).reshape(B, S, H, hd)
    v = (_lerp(x, xx, mv) @ p["w_v"]).reshape(B, S, H, hd)
    g = F.silu((_lerp(x, xx, mg) @ p["w_g"]).float())
    w = _decay(p, _lerp(x, xx, mw)).reshape(B, S, H, hd)
    stateful = return_state or state is not None
    out = ops.rwkv6_scan(r, k, v, w.to(r.dtype), p["u"], s0=wkv0,
                         return_state=stateful)
    y, wkv = out if stateful else (out, None)
    y = _head_norm(cfg, p, y.reshape(B, S, d)) * g
    out = y.to(x.dtype) @ p["w_o"]
    return (out, (x[:, -1], wkv)) if stateful else out


def channel_mix(cfg: ArchCfg, p: Params, x: torch.Tensor, *, state=None,
                return_state: bool = False):
    xx = _shift(x, state)
    mk, mr = p["mu"]
    k = torch.relu((_lerp(x, xx, mk) @ p["w_k"]).float()).square()
    rgate = torch.sigmoid((_lerp(x, xx, mr) @ p["w_r"]).float())
    out = (rgate * (k.to(x.dtype) @ p["w_v"]).float()).to(x.dtype)
    if return_state or state is not None:
        return out, x[:, -1]
    return out


# ----------------------------------------------------------------------------
# LM stack
# ----------------------------------------------------------------------------

def _layer(cfg: ArchCfg, lp: RwkvBlock, h: torch.Tensor) -> torch.Tensor:
    h = h + time_mix(cfg, lp.tm, common.apply_norm(cfg, lp.ln1, h))
    return h + channel_mix(cfg, lp.cm, common.apply_norm(cfg, lp.ln2, h))


def forward(cfg: ArchCfg, params: RwkvLM, h: torch.Tensor, *,
            remat: bool = True) -> torch.Tensor:
    """The layer stack over embeddings h: (B, S, d); ``remat`` (under grad)
    recomputes each layer in the backward."""
    for lp in params.layers:
        h = common.run_layer(_layer, remat, cfg, lp, h)
    return common.apply_norm(cfg, params.final_norm, h)


def train_loss(cfg: ArchCfg, params: RwkvLM, batch: dict, *,
               remat: bool = True) -> torch.Tensor:
    h = common.embed_tokens(params.embed, batch["tokens"])
    logits = common.lm_head(cfg, params.embed,
                            forward(cfg, params, h, remat=remat))
    return common.cross_entropy(logits, batch["labels"])


def init_state(cfg: ArchCfg, batch: int, *, layers: int,
               device="cuda") -> dict:
    H, hd = _heads(cfg)
    d = cfg.d_model
    return {
        "tm_shift": torch.zeros((layers, batch, d), dtype=cfg.dtype,
                                device=device),
        "cm_shift": torch.zeros((layers, batch, d), dtype=cfg.dtype,
                                device=device),
        "wkv": torch.zeros((layers, batch, H, hd, hd), dtype=torch.float32,
                           device=device),
    }


def _step_layers(cfg: ArchCfg, params: RwkvLM, h: torch.Tensor, state):
    """The layer stack with per-layer state in (None: zeros) and out."""
    tms, cms, wkvs = [], [], []
    for i, lp in enumerate(params.layers):
        tm_in = None if state is None else (state["tm_shift"][i],
                                            state["wkv"][i])
        cm_in = None if state is None else state["cm_shift"][i]
        x1 = common.apply_norm(cfg, lp.ln1, h)
        y, (tm, wkv) = time_mix(cfg, lp.tm, x1, state=tm_in,
                                return_state=True)
        h = h + y
        x2 = common.apply_norm(cfg, lp.ln2, h)
        y, cm = channel_mix(cfg, lp.cm, x2, state=cm_in, return_state=True)
        h = h + y
        tms.append(tm)
        cms.append(cm)
        wkvs.append(wkv)
    h = common.apply_norm(cfg, params.final_norm, h)
    return h, {"tm_shift": torch.stack(tms), "cm_shift": torch.stack(cms),
               "wkv": torch.stack(wkvs)}


def prefill(cfg: ArchCfg, params: RwkvLM, batch: dict):
    """Returns (last-token logits (B, 1, V), decode state) — O(1) in S.

    Under a runtime mesh with a "model" axis of more than one rank, this
    rank's part of JAX's partitioned prefill (``_step_layers_tp``): the
    state comes back as this rank's ``decode_state_specs`` shard."""
    mesh = sharding.serving_mesh(cfg)
    if mesh is not None:
        return _step_layers_tp(cfg, params, batch["tokens"], None, mesh)
    h = common.embed_tokens(params.embed, batch["tokens"])
    h, state = _step_layers(cfg, params, h, None)
    return common.lm_head(cfg, params.embed, h[:, -1:]), state


def decode_step(cfg: ArchCfg, params: RwkvLM, token: torch.Tensor,
                state: dict, pos=None):
    """token: (B, 1); state {"tm_shift", "cm_shift", "wkv"} with a leading
    layer axis; ``pos`` is unused (O(1) state).  Returns (logits, state).

    Under a runtime mesh with a "model" axis of more than one rank, token
    holds this rank's rows and state its ``decode_state_specs`` shard, as
    ``prefill`` returns it there (``_step_layers_tp``)."""
    mesh = sharding.serving_mesh(transformer.serving_cfg(cfg))
    if mesh is not None:
        return _step_layers_tp(transformer.serving_cfg(cfg), params, token,
                               state, mesh)
    h = common.embed_tokens(params.embed, token)
    h, state = _step_layers(cfg, params, h, state)
    return common.lm_head(cfg, params.embed, h), state


# ----------------------------------------------------------------------------
# serving under a mesh: prefill and decode_step as one rank's part of JAX's
# partitioned program (its in_shardings: param_specs, batch_specs,
# decode_state_specs).  The residual stream stays whole on every rank of a
# "model" line; each rank reads its own shards of the weights (the column
# slices of w_r, w_k, w_v, w_g, w_o and of the channel-mix's w_k and w_r,
# the rows of its w_v, its share of the decay LoRA's rank) and holds its
# shard of the state, which decode_state_specs lays out as
#
#   wkv  (L, B/dp, H, dh/tp, dh)  dh/tp of the keys of every head: the rank
#        program's own layout (the state's key dim is the readout's
#        contracted dim)
#   tm_shift, cm_shift (L, B/dp, d)  whole, or the layers over "model"
#        where tp divides L (read a layer at a time: the rank that holds
#        it broadcasts it)
#
# decode, a layer (tp > 1, dh divisible by tp):
#   time-mix: r|k|v|g column slices --AG--> every rank slices its keys of
#     r, k (and of the decay, whose LoRA partial is reduce-scattered
#     straight onto those keys); K4's split-key route: the rank's rows of
#     the state and its part of the readout --AR--> the head norm, the
#     gate, and w_o's column slice --AG-->
#   channel-mix: relu(x w_k[:, f slice])^2 @ w_v[f slice] --RS--> times
#     sigmoid(x w_r[:, d slice]) --AG-->
# prefill, a layer (tp dividing the heads): the time-mix on the rank's
#   heads through K4 at full width (the decay's LoRA reduce-scattered onto
#   the rank's columns, u's rows re-laid by one all-to-all, w_o's rows
#   likewise; its partial --AR-->), the channel-mix as above; the final
#   wkv state re-laid from the rank's heads to its keys one layer at a
#   time (spmd.layer_out).
# Where the split does not divide, a layer runs the plain path with its
# weights gathered where read and its state re-laid a layer at a time.
# ----------------------------------------------------------------------------

_STATE = ("tm_shift", "cm_shift", "wkv")


def _col(p: Params, name: str, mesh) -> torch.Tensor:
    """This rank's column slice of weight ``name`` (its output dim)."""
    return spmd.tp_slice(p.local(name), -1, mesh)


def _row(p: Params, name: str, mesh) -> torch.Tensor:
    """This rank's row slice of weight ``name`` (its input dim)."""
    return spmd.tp_slice(p.local(name), 0, mesh)


def _lora_part(p: Params, xw: torch.Tensor, mesh) -> torch.Tensor | None:
    """The rank's part of the decay LoRA, tanh(xw A[:, r]) B[r, :] over its
    slice r of the LoRA's rank (summed over "model" it is the whole); None
    where the rank does not divide."""
    if DECAY_LORA % mesh.shape["model"]:
        return None
    return torch.tanh(xw.float() @ _col(p, "w_lora_a", mesh)) \
        @ _row(p, "w_lora_b", mesh)


def _time_mix_keys(cfg: ArchCfg, p: Params, x: torch.Tensor, prev, wkv0,
                   mesh):
    """One decode step of the time-mix on this rank's keys: x (B, 1, d)
    whole, prev (B, d) the layer's token shift, wkv0 (B, H, dh/tp, dh) the
    rank's rows of the state.  Returns (out (B, 1, d) whole, (x's last
    token, the new state rows))."""
    H, hd = _heads(cfg)
    B, S, d = x.shape
    tp, idx = mesh.shape["model"], mesh.axis_index("model")
    dk = hd // tp
    xx = _shift(x, prev)
    mr, mk, mv, mw, mg = p["mu"]
    parts = torch.stack([_lerp(x, xx, m) @ _col(p, n, mesh) for m, n in (
        (mr, "w_r"), (mk, "w_k"), (mv, "w_v"), (mg, "w_g"))])
    r, k, v, g = spmd.all_gather(parts, -1, mesh, "model",
                                 tag="rkvg").unbind(0)
    keys = slice(idx * dk, (idx + 1) * dk)

    def mine(t):                        # the rank's keys of every head
        return t.reshape(B, S, H, hd)[..., keys].contiguous()

    xw = _lerp(x, xx, mw)
    part = _lora_part(p, xw, mesh)
    if part is None:
        lo = mine(torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"])
    else:       # reduce-scattered onto the keys: (tp, B, S, H, dk) summed
        lo = spmd.reduce_scatter(
            part.reshape(B, S, H, tp, dk).movedim(3, 0).contiguous(), 0,
            mesh, "model", tag="lora")[0]
    w0 = p["w0"].reshape(H, hd)[:, keys]
    w = torch.exp(-torch.exp(w0 + lo))
    r = mine(r)
    y, wkv = ops.rwkv6_scan_split(r, mine(k),
                                  v.reshape(B, S, H, hd).contiguous(),
                                  w.to(r.dtype).contiguous(),
                                  _col(p, "u", mesh), s0=wkv0)
    y = spmd.all_reduce(y, mesh, "model", tag="readout").to(r.dtype)
    y = _head_norm(cfg, p, y.reshape(B, S, d)) * F.silu(g.float())
    out = spmd.all_gather(y.to(x.dtype) @ _col(p, "w_o", mesh), -1, mesh,
                          "model", tag="act")
    return out, (x[:, -1], wkv)


def _time_mix_heads(cfg: ArchCfg, p: Params, x: torch.Tensor, mesh):
    """The prefill's time-mix on this rank's heads (tp dividing them):
    x (B, S, d) whole.  Returns (out (B, S, d) whole, (x's last token, the
    final state of the rank's heads (B, H/tp, dh, dh)))."""
    H, hd = _heads(cfg)
    B, S, d = x.shape
    tp, idx = mesh.shape["model"], mesh.axis_index("model")
    c = d // tp
    xx = _shift(x)
    mr, mk, mv, mw, mg = p["mu"]
    # the kernel takes contiguous rows; a product with a column slice of
    # a weight need not come out so
    r, k, v = ((_lerp(x, xx, m) @ _col(p, n, mesh)).reshape(B, S, -1, hd)
               .contiguous()
               for m, n in ((mr, "w_r"), (mk, "w_k"), (mv, "w_v")))
    g = F.silu((_lerp(x, xx, mg) @ _col(p, "w_g", mesh)).float())
    xw = _lerp(x, xx, mw)
    part = _lora_part(p, xw, mesh)
    if part is None:
        lo = (torch.tanh(xw.float() @ p["w_lora_a"])
              @ p["w_lora_b"]).narrow(-1, idx * c, c)
    else:            # reduce-scattered onto the rank's columns
        lo = spmd.reduce_scatter(part, -1, mesh, "model", tag="lora")
    w = torch.exp(-torch.exp(p["w0"].narrow(0, idx * c, c) + lo))
    y, wkv = ops.rwkv6_scan(r, k, v, w.reshape(B, S, -1, hd).to(
        r.dtype).contiguous(), _row(p, "u", mesh), return_state=True)
    y = _head_norm(cfg, p, y.reshape(B, S, c),
                   p["gn_scale"].narrow(0, idx * c, c)) * g
    out = spmd.all_reduce(y.to(x.dtype) @ _row(p, "w_o", mesh), mesh,
                          "model", tag="act")
    return out, (x[:, -1], wkv)


def _channel_mix_tp(cfg: ArchCfg, p: Params, x: torch.Tensor, state,
                    mesh):
    """The channel-mix on this rank's d_ff slice (the plain one, weights
    gathered, where d_ff or d does not divide): x (B, S, d) whole, state
    the token shift (None: zeros).  Returns (out whole, x's last
    token)."""
    tp = mesh.shape["model"]
    if cfg.d_ff % tp or cfg.d_model % tp:
        return channel_mix(cfg, p, x, state=state, return_state=True)
    xx = _shift(x, state)
    mk, mr = p["mu"]
    k = torch.relu((_lerp(x, xx, mk) @ _col(p, "w_k", mesh)).float()
                   ).square()
    kv = spmd.reduce_scatter(k.to(x.dtype) @ _row(p, "w_v", mesh), -1, mesh,
                             "model", tag="act")
    rgate = torch.sigmoid((_lerp(x, xx, mr) @ _col(p, "w_r", mesh)).float())
    out = spmd.all_gather((rgate * kv.float()).to(x.dtype), -1, mesh,
                          "model", tag="act")
    return out, x[:, -1]


def _step_layers_tp(cfg: ArchCfg, params: RwkvLM, tokens: torch.Tensor,
                    state: dict | None, mesh):
    """``prefill`` (state None, tokens the rank's rows of the prompt) or
    ``decode_step`` (tokens (B, 1), state the rank's shard) as this rank's
    part of the partitioned program; returns (logits, the state's shard
    under ``decode_state_specs``)."""
    seq = sharding.runtime_batch_spec()[1]
    if seq is not None:      # the recurrence takes the whole sequence
        tokens = spmd.all_gather(tokens, 1, mesh, seq, tag="seq")
    H, hd = _heads(cfg)
    tp = mesh.shape["model"]
    # the wkv state's keys (decode) or heads (prefill) over "model" where
    # they divide
    if state is not None:
        split = {} if hd % tp else {"wkv": 2}
    else:
        split = {} if H % tp else {"wkv": 1}
    st = spmd.RankStates(cfg, mesh, tokens.shape[0], state,
                         lambda b: init_state(cfg, b, layers=cfg.n_layers,
                                              device="meta"), _STATE, split)
    h = common.embed_tokens(params.embed, tokens)
    for i, lp in enumerate(params.layers):
        tm_in = cm_in = None
        if state is not None:
            tm_in, cm_in, wkv0 = (st.read(i, n) for n in _STATE)
        x1 = common.apply_norm(cfg, lp.ln1, h)
        if not st.split:
            y, (tm, wkv) = time_mix(cfg, lp.tm, x1, return_state=True,
                                    state=None if state is None
                                    else (tm_in, wkv0))
        elif state is None:
            y, (tm, wkv) = _time_mix_heads(cfg, lp.tm, x1, mesh)
        else:
            y, (tm, wkv) = _time_mix_keys(cfg, lp.tm, x1, tm_in, wkv0, mesh)
        h = h + y
        y, cm = _channel_mix_tp(cfg, lp.cm, common.apply_norm(cfg, lp.ln2, h),
                                cm_in, mesh)
        h = h + y
        for n, t in zip(_STATE, (tm, cm, wkv)):
            st.write(i, n, t)
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h[:, -1:])
    return logits, st.stacks()
