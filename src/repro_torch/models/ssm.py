"""Mamba2 (SSD) mixer block and LM stack (n_groups = 1).

The counterpart of the JAX package's ``models/ssm.py``: a fused input
projection giving (z, x, B, C, dt), a depthwise causal conv over
(x | B | C), softplus dt, the SSD scan, a gated RMSNorm and the output
projection.  The scan goes through ``ops.mamba2_scan``: the CUDA kernel K3
on the card (state in and out included), the chunked plain version on the
CPU; under grad on the card its gradient is K3-bwd.  ``x``, ``B`` and
``C`` reach it as strided views of the conv output (the kernels take their
strides; nothing is copied).  The configs' ``scan_impl`` knob is not read:
the tensors' device picks the implementation.  Training
(``train_loss(..., remat=True)``, JAX's default) recomputes each layer in
the backward, as JAX checkpoints its scan body.  One-token decode
(``mamba_decode_step``) is inline PyTorch, as the JAX version is inline
jnp: no kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import common, transformer
from repro_torch.models.common import ArchCfg, Params, dense_init
from repro_torch.parallel import sharding, spmd


def _dims(cfg: ArchCfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.d_state, s.conv_width


def init_mamba(cfg: ArchCfg, gen, device) -> Params:
    d_inner, H, ds, cw = _dims(cfg)
    d, dt, f32 = cfg.d_model, cfg.dtype, torch.float32
    conv_ch = d_inner + 2 * ds
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device))
    return Params(
        # packed projection: z | x | B | C | dt
        w_in=dense_init(gen, (d, 2 * d_inner + 2 * ds + H), dt, device),
        conv_w=dense_init(gen, (cw, conv_ch), dt, device,
                          scale=cw ** -0.5),
        conv_b=torch.zeros((conv_ch,), dtype=dt, device=device),
        dt_bias=torch.zeros((H,), dtype=f32, device=device),
        A_log=a_log,
        D=torch.ones((H,), dtype=f32, device=device),
        norm_scale=torch.ones((d_inner,), dtype=dt, device=device),
        w_out=dense_init(gen, (d_inner, d), dt, device))


def _split_proj(cfg: ArchCfg, proj: torch.Tensor):
    d_inner, H, ds, _ = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner, ds, ds, H], -1)


def _gated_norm(cfg: ArchCfg, p: Params, y: torch.Tensor, z: torch.Tensor):
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + cfg.norm_eps)
    return (yf * p["norm_scale"].float()).to(y.dtype)


def _dt(cfg: ArchCfg, p: Params, dt: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt.float() + p["dt_bias"]).clamp_min(cfg.ssm.dt_min)


def apply_mamba(cfg: ArchCfg, p: Params, hx: torch.Tensor, *,
                return_state: bool = False):
    """Full-sequence mixer: hx (B, S, d) -> (B, S, d).

    With return_state=True also returns (conv_tail, ssd_state), the O(1)
    decode state after the sequence."""
    d_inner, H, ds, cw = _dims(cfg)
    B, S, _ = hx.shape
    z, x, bm, cm, dt = _split_proj(cfg, hx @ p["w_in"])
    # depthwise causal conv over (x | B | C), summed in JAX's order
    pad = F.pad(torch.cat([x, bm, cm], -1), (0, 0, cw - 1, 0))
    conv = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(cw))
    xbc = F.silu((conv + p["conv_b"]).float()).to(hx.dtype)
    x, bm, cm = torch.split(xbc, [d_inner, ds, ds], -1)
    A = -torch.exp(p["A_log"])
    xh = x.reshape(B, S, H, cfg.ssm.head_dim)        # a strided view
    out = ops.mamba2_scan(xh, _dt(cfg, p, dt), A, bm, cm, p["D"],
                          return_state=return_state)
    y, ssd = out if return_state else (out, None)
    out = _gated_norm(cfg, p, y.reshape(B, S, d_inner), z) @ p["w_out"]
    if return_state:
        return out, (pad[:, S:], ssd)   # the last cw-1 raw conv inputs
    return out


# -- decode (single step, O(1) state) -----------------------------------------

def init_mamba_state(cfg: ArchCfg, batch: int, *, layers: int,
                     device="cuda") -> dict:
    d_inner, H, ds, cw = _dims(cfg)
    return {
        "conv": torch.zeros((layers, batch, cw - 1, d_inner + 2 * ds),
                            dtype=cfg.dtype, device=device),
        "ssd": torch.zeros((layers, batch, H, ds, cfg.ssm.head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_decode_step(cfg: ArchCfg, p: Params, hx: torch.Tensor,
                      conv_state: torch.Tensor, ssd_state: torch.Tensor):
    """hx: (B, 1, d) -> (out (B, 1, d), conv_state, ssd_state)."""
    d_inner, H, ds, cw = _dims(cfg)
    hd = cfg.ssm.head_dim
    B = hx.shape[0]
    z, x, bm, cm, dt = _split_proj(cfg, hx[:, 0] @ p["w_in"])
    window = torch.cat([conv_state, torch.cat([x, bm, cm], -1)[:, None]], 1)
    conv = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc = F.silu(conv.float()).to(hx.dtype)
    x, bm, cm = torch.split(xbc, [d_inner, ds, ds], -1)
    dtv = _dt(cfg, p, dt)                                       # (B, H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(A[None] * dtv)
    xh = x.reshape(B, H, hd).float()
    inject = torch.einsum("bs,bhd->bhsd", bm.float(), xh * dtv[..., None])
    ssd_state = ssd_state * decay[..., None, None] + inject
    y = torch.einsum("bs,bhsd->bhd", cm.float(), ssd_state)
    y = y.reshape(B, d_inner) + p["D"].repeat_interleave(hd) \
        * x.float().reshape(B, d_inner)
    y = _gated_norm(cfg, p, y.to(hx.dtype), z)
    return (y @ p["w_out"])[:, None], window[:, 1:], ssd_state


# ----------------------------------------------------------------------------
# the pure-mamba LM stack (the zamba2 hybrid is models/hybrid.py)
# ----------------------------------------------------------------------------

class MambaBlock(nn.Module):
    """One backbone layer: ln -> mixer."""

    def __init__(self, cfg: ArchCfg, gen, device) -> None:
        super().__init__()
        self.ln = common.init_norm(cfg, device)
        self.mixer = init_mamba(cfg, gen, device)


class MambaLM(nn.Module):
    """Parameters named like the JAX pytree (``layers.<i>.mixer.w_in``)."""

    def __init__(self, cfg: ArchCfg, *, device,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = common.init_embed(cfg, generator, device)
        self.layers = nn.ModuleList(MambaBlock(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = common.init_norm(cfg, device)


def init_lm(cfg: ArchCfg, generator: torch.Generator) -> MambaLM:
    """Random weights drawn from ``generator``, on the generator's device."""
    return MambaLM(cfg, device=generator.device, generator=generator)


def layer(cfg: ArchCfg, lp: MambaBlock, h: torch.Tensor) -> torch.Tensor:
    """One backbone layer with its residual: h + mixer(ln(h))."""
    return h + apply_mamba(cfg, lp.mixer, common.apply_norm(cfg, lp.ln, h))


def forward(cfg: ArchCfg, params: MambaLM, h: torch.Tensor, *,
            remat: bool = True) -> torch.Tensor:
    """The layer stack over embeddings h: (B, S, d); ``remat`` (under grad)
    recomputes each layer in the backward."""
    for lp in params.layers:
        h = common.run_layer(layer, remat, cfg, lp, h)
    return common.apply_norm(cfg, params.final_norm, h)


def train_loss(cfg: ArchCfg, params: MambaLM, batch: dict, *,
               remat: bool = True) -> torch.Tensor:
    h = common.embed_tokens(params.embed, batch["tokens"])
    logits = common.lm_head(cfg, params.embed,
                            forward(cfg, params, h, remat=remat))
    return common.cross_entropy(logits, batch["labels"])


def prefill(cfg: ArchCfg, params: MambaLM, batch: dict):
    """Returns (last-token logits (B, 1, V), decode state) — O(1) in S.

    Under a runtime mesh with a "model" axis of more than one rank, this
    rank's part of JAX's partitioned prefill (``prefill_layer``
    below): the state comes back as this rank's ``decode_state_specs``
    shard."""
    mesh = sharding.serving_mesh(cfg)
    tokens = batch["tokens"]
    if mesh is not None:
        tokens = whole_sequence(tokens, mesh)
        st = rank_states(cfg, mesh, tokens.shape[0], None,
                         lambda b: init_mamba_state(
                             cfg, b, layers=cfg.n_layers, device="meta"))
    h = common.embed_tokens(params.embed, tokens)
    convs, ssds = [], []
    for i, lp in enumerate(params.layers):
        if mesh is not None:
            h = prefill_layer(cfg, st, i, lp, h)
            continue
        y, (conv, ssd) = apply_mamba(cfg, lp.mixer,
                                     common.apply_norm(cfg, lp.ln, h),
                                     return_state=True)
        h = h + y
        convs.append(conv)
        ssds.append(ssd)
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h[:, -1:])
    if mesh is not None:
        return logits, st.stacks()
    return logits, {"conv": torch.stack(convs), "ssd": torch.stack(ssds)}


def decode_step(cfg: ArchCfg, params: MambaLM, token: torch.Tensor,
                state: dict, pos=None):
    """token: (B, 1); state {"conv", "ssd"} with a leading layer axis;
    ``pos`` is unused (O(1) state).

    Under a runtime mesh with a "model" axis of more than one rank, token
    holds this rank's rows and state its ``decode_state_specs`` shard, as
    ``prefill`` returns it there."""
    cfg = transformer.serving_cfg(cfg)
    mesh = sharding.serving_mesh(cfg)
    if mesh is not None:
        st = rank_states(cfg, mesh, token.shape[0], state,
                         lambda b: init_mamba_state(
                             cfg, b, layers=cfg.n_layers, device="meta"))
    h = common.embed_tokens(params.embed, token)
    convs, ssds = [], []
    for i, lp in enumerate(params.layers):
        if mesh is not None:
            h = decode_layer(cfg, st, i, lp, h)
            continue
        y, conv, ssd = mamba_decode_step(
            cfg, lp.mixer, common.apply_norm(cfg, lp.ln, h),
            state["conv"][i], state["ssd"][i])
        h = h + y
        convs.append(conv)
        ssds.append(ssd)
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h)
    if mesh is not None:
        return logits, st.stacks()
    return logits, {"conv": torch.stack(convs), "ssd": torch.stack(ssds)}


# ----------------------------------------------------------------------------
# serving under a mesh: one rank's part of JAX's partitioned prefill and
# decode step (its in_shardings: param_specs, batch_specs,
# decode_state_specs), shared by mamba2 and zamba2's backbone.  The
# residual stream stays whole on every rank of a "model" line; each rank
# reads its column slice of w_in and its row slice of w_out (and its
# norm_scale slice), and holds its shard of the state, which
# decode_state_specs lays out as
#
#   ssd  (L, B/dp, H, ds/tp, dh)  ds/tp of the state dim of every head:
#        the rank program's own layout in decode (ds is the readout's
#        contracted dim)
#   conv (L, B/dp, cw - 1, conv_ch)  whole, or the layers over "model"
#        where tp divides L (read a layer at a time: the rank that holds
#        it broadcasts it)
#
# decode, a layer (tp > 1, ds divisible by tp):
#   x w_in[:, column slice] --AG--> z, x, B, C, dt whole; the depthwise
#   conv on every channel (its small weights gathered with the (H,)
#   vectors, one all-gather each); the state's ds slice decayed and
#   injected with the rank's B, its readout with the rank's C --AR-->
#   + D x (once, after the sum); the gated norm over the whole d_inner,
#   the rank's d_inner slice @ w_out's rows --AR-->
# prefill, a layer (tp dividing the SSM heads): the same projection and
#   conv, the rank's heads through K3 at full ds; the gated norm's sum of
#   squares --AR-->, the rank's slice @ w_out's rows --AR-->; the final
#   state re-laid from the rank's heads to its ds slice one layer at a
#   time (spmd.layer_out).
# Where the split does not divide, a layer runs the plain mixer with its
# weights gathered where read and its state re-laid a layer at a time.
# ----------------------------------------------------------------------------

def whole_sequence(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """A rank's prompt rows whole: the recurrence takes the whole
    sequence, which a batch spec may put over an axis."""
    seq = sharding.runtime_batch_spec()[1]
    if seq is None:
        return tokens
    return spmd.all_gather(tokens, 1, mesh, seq, tag="seq")


def _gathered(p: Params, names, mesh) -> list[torch.Tensor]:
    """Several small parameters whole: one all-gather of their shards
    stacked where each is split on its last dim over "model" alone, else
    each read gathered."""
    ts = [p.local(n) for n in names]

    def last_only(t):
        spec = tuple(getattr(t, "spec", None) or ())
        spec += (None,) * (t.dim() - len(spec))
        return spec[-1] == "model" and not any(spec[:-1])

    if not all(last_only(t) for t in ts) \
            or len({t.shape[-1] for t in ts}) != 1:
        return [p[n] for n in names]
    rows = [t.reshape(-1, t.shape[-1]) for t in ts]
    whole = spmd.all_gather(torch.cat(rows), -1, mesh, "model", tag="param")
    out, at = [], 0
    for t, r in zip(ts, rows):
        out.append(whole[at:at + r.shape[0]].reshape(
            t.shape[:-1] + (whole.shape[-1],)))
        at += r.shape[0]
    return out


def _proj_conv(cfg: ArchCfg, p: Params, hx: torch.Tensor, mesh,
               conv_state=None):
    """The input projection and the depthwise conv on every rank: hx (B,
    S, d) -> (z, x, B, C, dt whole, the conv window's raw inputs
    (B, cw - 1 + S, conv_ch)).  The projection is the rank's column slice,
    gathered (or, where its width does not divide, read whole)."""
    d_inner, H, ds, cw = _dims(cfg)
    B, S, _ = hx.shape
    w_in = p.local("w_in")
    if w_in.shape[-1] * mesh.shape["model"] == 2 * d_inner + 2 * ds + H:
        proj = spmd.all_gather(hx @ spmd.tp_slice(w_in, -1, mesh), -1, mesh,
                               "model", tag="proj")
    else:
        proj = hx @ p["w_in"]
    z, x, bm, cm, dt = _split_proj(cfg, proj)
    raw = torch.cat([x, bm, cm], -1)
    if conv_state is None:
        pad = F.pad(raw, (0, 0, cw - 1, 0))
    else:
        pad = torch.cat([conv_state, raw], 1)
    conv_w, conv_b = _gathered(p, ("conv_w", "conv_b"), mesh)
    if conv_state is None:      # summed in JAX's order
        conv = sum(pad[:, i:i + S] * conv_w[i] for i in range(cw))
    else:
        conv = torch.einsum("bwc,wc->bc", pad, conv_w)[:, None]
    xbc = F.silu((conv + conv_b).float()).to(hx.dtype)
    x, bm, cm = torch.split(xbc, [d_inner, ds, ds], -1)
    return z, x, bm, cm, dt, pad


def _gated_out(cfg: ArchCfg, p: Params, y: torch.Tensor, z: torch.Tensor,
               mesh, *, whole: bool) -> torch.Tensor:
    """The gated norm and the output projection on the rank's d_inner
    slice: y and z (B, S, d_inner) whole (``whole``: the norm's mean
    taken here) or the rank's slice (its sum of squares summed over
    "model"); the slice @ w_out's rows, summed over "model"."""
    d_inner = _dims(cfg)[0]
    tp, idx = mesh.shape["model"], mesh.axis_index("model")
    c = d_inner // tp
    yf = y.float() * F.silu(z.float())
    if whole:
        yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True)
                              + cfg.norm_eps)
        yf = yf.narrow(-1, idx * c, c)
    else:
        ss = spmd.all_reduce((yf * yf).sum(-1, keepdim=True), mesh, "model",
                             tag="norm")
        yf = yf * torch.rsqrt(ss / d_inner + cfg.norm_eps)
    scale = spmd.tp_slice(p.local("norm_scale"), 0, mesh)
    out = (yf * scale.float()).to(y.dtype) @ spmd.tp_slice(
        p.local("w_out"), 0, mesh)
    return spmd.all_reduce(out, mesh, "model", tag="act")


def mamba_heads(cfg: ArchCfg, p: Params, hx: torch.Tensor, mesh):
    """The prefill's mixer on this rank's SSM heads (tp dividing them):
    hx (B, S, d) whole -> (out (B, S, d) whole, (the conv tail (B, cw - 1,
    conv_ch), the final state of the rank's heads (B, H/tp, ds, dh)))."""
    d_inner, H, ds, cw = _dims(cfg)
    B, S, _ = hx.shape
    tp, idx = mesh.shape["model"], mesh.axis_index("model")
    n, c = H // tp, d_inner // tp
    z, x, bm, cm, dt, pad = _proj_conv(cfg, p, hx, mesh)
    heads = slice(idx * n, (idx + 1) * n)
    dt_bias, a_log, D = (spmd.tp_slice(p.local(k), 0, mesh)
                         for k in ("dt_bias", "A_log", "D"))
    dtv = F.softplus(dt[..., heads].float() + dt_bias).clamp_min(
        cfg.ssm.dt_min)
    xh = x.reshape(B, S, H, cfg.ssm.head_dim)[:, :, heads]   # strided view
    y, ssd = ops.mamba2_scan(xh, dtv, -torch.exp(a_log), bm, cm, D,
                             return_state=True)
    out = _gated_out(cfg, p, y.reshape(B, S, c),
                     z.narrow(-1, idx * c, c), mesh, whole=False)
    return out, (pad[:, S:], ssd)


def mamba_decode_ds(cfg: ArchCfg, p: Params, hx: torch.Tensor,
                    conv_state: torch.Tensor, ssd_state: torch.Tensor, mesh):
    """One decode step of the mixer on this rank's slice of ds (tp
    dividing it): hx (B, 1, d) whole, conv_state (B, cw - 1, conv_ch)
    whole, ssd_state (B, H, ds/tp, dh) the rank's rows.  Returns (out
    (B, 1, d) whole, the conv state, the new state rows)."""
    d_inner, H, ds, cw = _dims(cfg)
    hd = cfg.ssm.head_dim
    B = hx.shape[0]
    tp, idx = mesh.shape["model"], mesh.axis_index("model")
    n = ds // tp
    z, x, bm, cm, dt, window = _proj_conv(cfg, p, hx, mesh, conv_state)
    x, bm, cm, z, dt = x[:, 0], bm[:, 0], cm[:, 0], z[:, 0], dt[:, 0]
    dt_bias, a_log, D = _gathered(p, ("dt_bias", "A_log", "D"), mesh)
    dtv = F.softplus(dt.float() + dt_bias).clamp_min(cfg.ssm.dt_min)
    decay = torch.exp(-torch.exp(a_log)[None] * dtv)
    xh = x.reshape(B, H, hd).float()
    mine = slice(idx * n, (idx + 1) * n)
    inject = torch.einsum("bs,bhd->bhsd", bm[:, mine].float(),
                          xh * dtv[..., None])
    ssd_state = ssd_state * decay[..., None, None] + inject
    y = torch.einsum("bs,bhsd->bhd", cm[:, mine].float(), ssd_state)
    y = spmd.all_reduce(y, mesh, "model", tag="readout")
    y = y.reshape(B, d_inner) + D.repeat_interleave(hd) \
        * x.float().reshape(B, d_inner)
    out = _gated_out(cfg, p, y.to(hx.dtype)[:, None], z[:, None], mesh,
                     whole=True)
    return out, window[:, 1:], ssd_state


_LEAVES = ("conv", "ssd")


def rank_states(cfg: ArchCfg, mesh, rows_here: int, state, init, *,
                prefix: str = "") -> spmd.RankStates:
    """The mamba layers' states of one rank's serving program
    (``spmd.RankStates``): the ssd state's ds over "model" in decode
    (``state`` this rank's shard), its heads in prefill (``state``
    None), where "model" divides them; ``init(batch)`` the family's own
    whole state on meta."""
    _, H, ds, _ = _dims(cfg)
    tp = mesh.shape["model"]
    if state is not None:
        split = {} if ds % tp else {"ssd": 2}
    else:
        split = {} if H % tp else {"ssd": 1}
    return spmd.RankStates(cfg, mesh, rows_here, state, init, _LEAVES,
                           split, prefix=prefix)


def prefill_layer(cfg: ArchCfg, st: spmd.RankStates, i: int,
                  lp: "MambaBlock", h: torch.Tensor) -> torch.Tensor:
    """One backbone layer of a rank's prefill, h whole: h + mixer(ln(h)),
    its states written to ``st``."""
    x = common.apply_norm(cfg, lp.ln, h)
    if st.split:
        y, (conv, ssd) = mamba_heads(cfg, lp.mixer, x, st.mesh)
    else:
        y, (conv, ssd) = apply_mamba(cfg, lp.mixer, x, return_state=True)
    st.write(i, "conv", conv)
    st.write(i, "ssd", ssd)
    return h + y


def decode_layer(cfg: ArchCfg, st: spmd.RankStates, i: int,
                 lp: "MambaBlock", h: torch.Tensor) -> torch.Tensor:
    """One backbone layer of a rank's decode step, h whole."""
    conv, ssd = st.read(i, "conv"), st.read(i, "ssd")
    x = common.apply_norm(cfg, lp.ln, h)
    if st.split:
        y, conv, ssd = mamba_decode_ds(cfg, lp.mixer, x, conv, ssd, st.mesh)
    else:
        y, conv, ssd = mamba_decode_step(cfg, lp.mixer, x, conv, ssd)
    st.write(i, "conv", conv)
    st.write(i, "ssd", ssd)
    return h + y
