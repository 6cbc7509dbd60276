"""GQA attention with RoPE: the full-sequence path of training and prefill.

The counterpart of the JAX package's ``models/attention.py``.  The JAX
prefill computes ``ref.mha_attention``; here the same function goes through
``ops.flash_attention``, which runs the CUDA kernel K2 on the card and the
plain version on the CPU.  Decode against a dense cache (``attn_decode``)
and cross-attention are not ported yet: the serving engine decodes through
its paged pool.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ArchCfg, Params, apply_rope, dense_init


def init_attn(cfg: ArchCfg, gen, device) -> Params:
    hd = cfg.resolved_head_dim
    d, dt = cfg.d_model, cfg.dtype
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dt, device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dt, device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dt, device),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=device)
    return Params(**p)


def _project_qkv(cfg: ArchCfg, p: Params, xq: torch.Tensor,
                 xkv: torch.Tensor):
    hd = cfg.resolved_head_dim
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, Sq, cfg.n_heads, hd)
    k = k.reshape(B, Skv, cfg.n_kv_heads, hd)
    v = v.reshape(B, Skv, cfg.n_kv_heads, hd)
    return q, k, v


def compute_dtype(cfg: ArchCfg) -> torch.dtype:
    return torch.bfloat16 if cfg.attn_dtype == "bf16" else torch.float32


def attn_full(cfg: ArchCfg, p: Params, x: torch.Tensor, *, freqs=None,
              causal: bool = True, positions=None):
    """Full-sequence self-attention (training / prefill).

    Returns (out, (k, v)) so prefill can persist the cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, x)
    if freqs is not None:
        pos = positions if positions is not None else \
            torch.arange(S, device=x.device)[None]
        q = apply_rope(q, pos, freqs)
        k = apply_rope(k, pos, freqs)
    # the kernel takes contiguous (B, H, S, D)
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), causal=causal,
                              compute_dtype=compute_dtype(cfg))
    out = out.transpose(1, 2).reshape(B, S, -1)
    return out @ p["wo"], (k, v)
