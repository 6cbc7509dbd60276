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
from repro_torch.models import common
from repro_torch.models.common import ArchCfg, Params, dense_init


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
    """Returns (last-token logits (B, 1, V), decode state) — O(1) in S."""
    h = common.embed_tokens(params.embed, batch["tokens"])
    convs, ssds = [], []
    for lp in params.layers:
        y, (conv, ssd) = apply_mamba(cfg, lp.mixer,
                                     common.apply_norm(cfg, lp.ln, h),
                                     return_state=True)
        h = h + y
        convs.append(conv)
        ssds.append(ssd)
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h[:, -1:])
    return logits, {"conv": torch.stack(convs), "ssd": torch.stack(ssds)}


def decode_step(cfg: ArchCfg, params: MambaLM, token: torch.Tensor,
                state: dict, pos=None):
    """token: (B, 1); state {"conv", "ssd"} with a leading layer axis;
    ``pos`` is unused (O(1) state)."""
    h = common.embed_tokens(params.embed, token)
    convs, ssds = [], []
    for i, lp in enumerate(params.layers):
        y, conv, ssd = mamba_decode_step(
            cfg, lp.mixer, common.apply_norm(cfg, lp.ln, h),
            state["conv"][i], state["ssd"][i])
        h = h + y
        convs.append(conv)
        ssds.append(ssd)
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h)
    return logits, {"conv": torch.stack(convs), "ssd": torch.stack(ssds)}

