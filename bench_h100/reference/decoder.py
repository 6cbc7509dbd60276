"""Plain PyTorch decoder: the benchmark's reference for both families.

A pre-norm decoder as the configuration file states it: RMSNorm, rotary
positions on the two halves of each head (the rotate-half form), causal
softmax attention with grouped K/V heads, and a SwiGLU feed-forward, dense
or a mixture of experts (router softmax in fp32, the top k renormalised,
each expert a SwiGLU; training drops the rows past each expert's capacity
in token order and adds the Switch load-balancing loss).  Untied head.

Everything is computed in fp32 from the stored weights, with TF32 off.
``prec="fp8"`` is the control: every product's operands are rounded to
float8 e4m3 with a per-tensor scale (the gradient flowing back to e5m2)
and multiplied in fp32 — the next precision below the configuration's
bf16.

This file imports no part of the program under test.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Spec:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    eps: float
    theta: float
    experts: int = 0
    top_k: int = 0
    norm_topk: bool = True
    capacity_factor: float = 1.25
    aux_coef: float = 0.01

    @classmethod
    def of(cls, cfgd: dict) -> "Spec":
        m = cfgd["model"]
        d, H = m["hidden_size"], m["num_attention_heads"]
        return cls(layers=m["num_hidden_layers"], d=d, heads=H,
                   kv_heads=m["num_key_value_heads"],
                   head_dim=m.get("head_dim") or d // H,
                   ff=m["intermediate_size"], vocab=m["vocab_size"],
                   eps=m["rms_norm_eps"], theta=m["rope_theta"],
                   experts=m.get("num_experts", 0),
                   top_k=m.get("num_experts_per_tok", 0),
                   norm_topk=m.get("norm_topk_prob", True),
                   capacity_factor=cfgd.get("assumed", {}).get(
                       "moe_capacity_factor_train", 1.25),
                   aux_coef=m.get("router_aux_loss_coef", 0.01))


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the reference's products, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ----------------------------------------------------------------------------
# products, in fp32 or the fp8 control
# ----------------------------------------------------------------------------

def _fq(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` (a float8 type) under a per-tensor scale that
    maps its largest magnitude to the type's largest finite value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fq(a, torch.float8_e4m3fn), _fq(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fq(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        return _Fp8Product.apply(a, b)
    return a @ b


# ----------------------------------------------------------------------------
# the layer
# ----------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gain


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) at positions pos (S,): each (i, i + hd/2) pair turned
    by pos * theta^(-2i/hd)."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = pos.float()[:, None] * inv                     # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(s: Spec, w: dict, x: torch.Tensor, pos: torch.Tensor,
              prec: str) -> torch.Tensor:
    """Causal self-attention of one sequence x (S, d)."""
    S, hd = x.shape[0], s.head_dim
    q = rope(mm(x, w["attn.wq"], prec).view(S, s.heads, hd), pos, s.theta)
    k = rope(mm(x, w["attn.wk"], prec).view(S, s.kv_heads, hd), pos, s.theta)
    v = mm(x, w["attn.wv"], prec).view(S, s.kv_heads, hd)
    g = s.heads // s.kv_heads
    q = q.view(S, s.kv_heads, g, hd).permute(1, 2, 0, 3)   # (Hkv, g, S, hd)
    k, v = k.permute(1, 0, 2)[:, None], v.permute(1, 0, 2)[:, None]
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    out = torch.empty_like(q)
    for h in range(s.kv_heads):        # one K/V head at a time: less memory
        sc = mm(q[h], k[h].transpose(-1, -2), prec) * hd ** -0.5
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        out[h] = mm(p, v[h].expand(g, S, hd), prec)
    out = out.permute(2, 0, 1, 3).reshape(S, s.heads * hd)
    return mm(out, w["attn.wo"], prec)


def swiglu(x, wg, wu, wd, prec):
    return mm(F.silu(mm(x, wg, prec)) * mm(x, wu, prec), wd, prec)


# a list, when set, takes the expert ids (T K,) of each expert layer's
# call, in call order (``control.py --routes`` reads them)
ROUTES: list | None = None


def moe(s: Spec, w: dict, x: torch.Tensor, prec: str, capacity: bool):
    """(y, aux) of the expert layer over tokens x (T, d); ``capacity``
    keeps, of the rows routed to each expert in (token, k) order, the
    first int(T k / E * factor) (at least k)."""
    T, E, K = x.shape[0], s.experts, s.top_k
    probs = torch.softmax(x @ w["moe.router"], dim=-1)      # fp32 router
    top_p, top_e = torch.topk(probs, K, dim=-1)
    if ROUTES is not None:
        ROUTES.append(top_e.reshape(-1).detach().clone())
    if s.norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    C = max(int(T * K / E * s.capacity_factor), K) if capacity else T * K
    rows = torch.zeros(T * K, x.shape[1], dtype=x.dtype, device=x.device)
    for e in range(E):
        idx = (flat_e == e).nonzero()[:C, 0]
        if idx.numel():
            t = idx // K
            y = swiglu(x[t], w["moe.w_gate"][e], w["moe.w_up"][e],
                       w["moe.w_down"][e], prec)
            rows = rows.index_put((idx,), y * flat_p[idx, None])
    y = rows.view(T, K, -1).sum(1)
    counts = torch.bincount(flat_e, minlength=E).float() / (T * K)
    aux = s.aux_coef * E * torch.sum(probs.mean(0) * counts)
    return y, aux


def layer(s: Spec, w: dict, h: torch.Tensor, pos: torch.Tensor, prec: str,
          capacity: bool = False):
    """One layer on sequences h (B, S, d) at positions pos (S,) -> (h,
    aux); the experts see the B S tokens together."""
    B, S, d = h.shape
    a = [attention(s, w, rms_norm(h[b], w["ln1.scale"], s.eps), pos, prec)
         for b in range(B)]
    h = h + torch.stack(a)
    x = rms_norm(h, w["ln2.scale"], s.eps).reshape(B * S, d)
    if s.experts:
        y, aux = moe(s, w, x, prec, capacity)
    else:
        y = swiglu(x, w["mlp.w_gate"], w["mlp.w_up"], w["mlp.w_down"], prec)
        aux = h.new_zeros(())
    return h + y.view(B, S, d), aux


def head(s: Spec, w: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    """Logits (S, V) of final hidden states h (S, d)."""
    return mm(rms_norm(h, w["final_norm.scale"], s.eps), w["embed.head"],
              prec)
