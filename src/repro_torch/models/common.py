"""Shared model building blocks: config, norms, embeddings, RoPE, MLPs.

The counterpart of the JAX package's ``models/common.py``.  Parameters live
in ``nn.Module``s whose names follow the JAX pytree's keys (``p["scale"]``,
``p["w_gate"]``, ...), so the two packages read alike and the weights
bridge (``repro_torch.weights``) maps one onto the other by name.  The
layer stack is an ``nn.ModuleList`` walked with a Python loop where JAX
used ``lax.scan``.

Rounding points follow the JAX package exactly, so bf16 runs agree:
norms and RoPE run in fp32 and cast back; the MLP multiplies in the working
dtype, upcasts, applies the activation in fp32 and casts back; ``lm_head``
multiplies in the working dtype and *then* casts to fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal

import torch
import torch.nn.functional as F
from torch import nn

# ----------------------------------------------------------------------------
# configuration
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SsmCfg:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    dt_min: float = 1e-3
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ArchCfg:
    """One architecture = one frozen config (see repro_torch/configs/*)."""

    name: str
    family: Literal["dense", "moe", "mamba2", "rwkv6", "zamba2", "encdec",
                    "vlm"]
    n_layers: int
    d_model: int
    n_heads: int          # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0     # 0 -> d_model // n_heads
    norm: Literal["rms", "ln"] = "rms"
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    moe: MoeCfg | None = None
    ssm: SsmCfg | None = None
    # zamba2: one shared attention+MLP block applied every `attn_every`
    # mamba layers
    attn_every: int = 6
    # encdec: encoder depth (decoder gets n_layers); frontend emits frames
    n_enc_layers: int = 0
    n_frames: int = 1500
    # vlm: number of stub patch embeddings prepended to the text sequence
    n_patches: int = 256
    # dtypes
    dtype: Any = torch.bfloat16     # activations / layer params
    # True for archs whose attention is quadratic in context
    full_attention: bool = True
    # The next four select JAX-side implementations (recurrent scan,
    # GSPMD activation policy, MoE dispatch, parallelism).  They are kept so
    # the configs stay the same data in both packages; this slice of the
    # port reads none of them.
    scan_impl: str = "auto"
    tp_activations: str = "free"
    moe_impl: str = "global"
    parallelism: str = "tp_dp"
    # attention operand dtype: "f32" (exact) or "bf16" (operands rounded to
    # bf16, accumulation in fp32) — see kernels/ref.py::mha_attention
    attn_dtype: str = "f32"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def reduced(self, **overrides) -> "ArchCfg":
        """A tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 if self.family != "zamba2" else 4),
            d_model=min(self.d_model, 64),
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=min(self.d_ff, 128),
            vocab=min(self.vocab, 512),
            head_dim=16 if self.n_heads else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frames=min(self.n_frames, 8),
            n_patches=min(self.n_patches, 4),
            attn_every=2,
            dtype=torch.float32,
        )
        if self.moe:
            small["moe"] = dataclasses.replace(self.moe, n_experts=4, top_k=2,
                                               d_expert=32)
        if self.ssm:
            small["ssm"] = dataclasses.replace(self.ssm, d_state=8,
                                               head_dim=8)
        # zamba2 kv heads = heads in the shared block
        if self.family == "zamba2":
            small["n_kv_heads"] = small["n_heads"]
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ----------------------------------------------------------------------------
# parameters and initialisation helpers
# ----------------------------------------------------------------------------

class Params(nn.Module):
    """One named group of parameters — one dict of the JAX pytree.

    Indexing (``p["wq"]``) and membership (``"bias" in p``) read like the
    JAX code.  Parameters carry no gradient: this slice of the port serves.
    """

    def __init__(self, **tensors: torch.Tensor) -> None:
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters


def dense_init(gen: torch.Generator | None, shape, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    """N(0, scale^2) with scale = fan_in^-0.5 by default, drawn in fp32
    from ``gen`` and cast to ``dtype``.  ``gen=None`` leaves the tensor
    uninitialised (for weights that are loaded afterwards)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------

def init_norm(cfg: ArchCfg, device, dtype=None) -> Params:
    dtype = dtype or cfg.dtype
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return Params(**p)


def apply_norm(cfg: ArchCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rms":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + cfg.norm_eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------------------
# rotary position embeddings
# ----------------------------------------------------------------------------

def rope_freqs(cfg: ArchCfg, device) -> torch.Tensor:
    hd = cfg.resolved_head_dim
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (cfg.rope_theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    angles = positions[..., None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------

def init_mlp(cfg: ArchCfg, gen, device) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    if cfg.mlp == "swiglu":
        return Params(w_gate=dense_init(gen, (d, f), dt, device),
                      w_up=dense_init(gen, (d, f), dt, device),
                      w_down=dense_init(gen, (f, d), dt, device))
    return Params(w_up=dense_init(gen, (d, f), dt, device),
                  b_up=torch.zeros((f,), dtype=dt, device=device),
                  w_down=dense_init(gen, (f, d), dt, device),
                  b_down=torch.zeros((d,), dtype=dt, device=device))


def apply_mlp(cfg: ArchCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        g = F.silu((x @ p["w_gate"]).float())
        u = (x @ p["w_up"]).float()
        return (g * u).to(x.dtype) @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu((x @ p["w_up"] + p["b_up"]).float(), approximate="tanh")
    return h.to(x.dtype) @ p["w_down"] + p["b_down"]


# ----------------------------------------------------------------------------
# embeddings / head
# ----------------------------------------------------------------------------

def init_embed(cfg: ArchCfg, gen, device) -> Params:
    p = {"tok": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype, device,
                           scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.dtype,
                               device)
    return Params(**p)


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_head(cfg: ArchCfg, p: Params, h: torch.Tensor) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return (h @ w).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in fp32; labels == ignore_id are masked."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None].long())
    nll = logz - gold[..., 0]
    mask = (labels != ignore_id).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
