"""Plain PyTorch operations the reference layers are built from.

A layout (``bench_h100/layouts/<layout>.py``) composes its reference layer
from these: products, RMSNorm, rotary positions on the two halves of each
head (the rotate-half form), causal softmax attention with grouped K/V
heads, a SwiGLU feed-forward, and the expert loop of a mixture of experts
(each routed row through its expert, the rows past an expert's capacity
dropped in token order).

Everything is computed in fp32 from the stored weights, with TF32 off.
``prec="fp8"`` is the control: every product's operands are rounded to
float8 e4m3 with a per-tensor scale (the gradient flowing back to e5m2)
and multiplied in fp32 — the next precision below the configurations'
bf16.

This file imports no part of the program under test.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


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
# the pieces of a layer
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


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     prec: str) -> torch.Tensor:
    """Causal softmax attention of one sequence: q (S, H, dq) against k
    (S, Hkv, dq) and v (S, Hkv, dv), each K/V head shared by H / Hkv query
    heads, scores scaled by dq^-0.5 -> (S, H dv)."""
    S, H, dq = q.shape
    Hkv, dv = k.shape[1], v.shape[-1]
    g = H // Hkv
    q = q.view(S, Hkv, g, dq).permute(1, 2, 0, 3)          # (Hkv, g, S, dq)
    k, v = k.permute(1, 0, 2)[:, None], v.permute(1, 0, 2)[:, None]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = q.new_empty(Hkv, g, S, dv)
    for h in range(Hkv):               # one K/V head at a time: less memory
        sc = mm(q[h], k[h].transpose(-1, -2), prec) * dq ** -0.5
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        out[h] = mm(p, v[h].expand(g, S, dv), prec)
    return out.permute(2, 0, 1, 3).reshape(S, H * dv)


def swiglu(x, wg, wu, wd, prec):
    return mm(F.silu(mm(x, wg, prec)) * mm(x, wu, prec), wd, prec)


# a list, when set, takes the expert ids (T K,) of each expert layer's
# call, in call order (``control.py --routes`` reads them); a layout's
# router appends to it
ROUTES: list | None = None


def experts(x: torch.Tensor, top_e: torch.Tensor, top_p: torch.Tensor,
            w_gate, w_up, w_down, C: int, prec: str) -> torch.Tensor:
    """The routed experts over tokens x (T, d): each token's k rows (its
    experts ``top_e`` (T, k), weighted by ``top_p``) through SwiGLU
    experts, of the rows routed to each expert in (token, k) order the
    first ``C`` kept, the kept rows summed a token."""
    T, K = top_e.shape
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    rows = torch.zeros(T * K, x.shape[1], dtype=x.dtype, device=x.device)
    for e in range(w_gate.shape[0]):
        idx = (flat_e == e).nonzero()[:C, 0]
        if idx.numel():
            t = idx // K
            y = swiglu(x[t], w_gate[e], w_up[e], w_down[e], prec)
            rows = rows.index_put((idx,), y * flat_p[idx, None])
    return rows.view(T, K, -1).sum(1)
