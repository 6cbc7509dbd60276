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
from repro_torch.models import common
from repro_torch.models.common import ArchCfg, Params, dense_init

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


def _head_norm(cfg: ArchCfg, p: Params, y: torch.Tensor) -> torch.Tensor:
    """Per-head RMS normalisation of the wkv output (fp32 out)."""
    H, hd = _heads(cfg)
    shp = y.shape
    yf = y.float().reshape(shp[:-1] + (H, hd))
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + cfg.norm_eps)
    return yf.reshape(shp) * p["gn_scale"].float()


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
    """Returns (last-token logits (B, 1, V), decode state) — O(1) in S."""
    h = common.embed_tokens(params.embed, batch["tokens"])
    h, state = _step_layers(cfg, params, h, None)
    return common.lm_head(cfg, params.embed, h[:, -1:]), state


def decode_step(cfg: ArchCfg, params: RwkvLM, token: torch.Tensor,
                state: dict, pos=None):
    """token: (B, 1); state {"tm_shift", "cm_shift", "wkv"} with a leading
    layer axis; ``pos`` is unused (O(1) state).  Returns (logits, state)."""
    h = common.embed_tokens(params.embed, token)
    h, state = _step_layers(cfg, params, h, state)
    return common.lm_head(cfg, params.embed, h), state
