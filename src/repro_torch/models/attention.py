"""GQA attention with RoPE: training / prefill and decode on a dense cache.

The counterpart of the JAX package's ``models/attention.py``.  The JAX
prefill computes ``ref.mha_attention``; here the same function goes through
``ops.flash_attention``, which runs the CUDA kernel K2 on the card and the
plain version on the CPU.  ``attn_decode`` is one token against a dense
(B, S_max, Hkv, hd) cache, inline PyTorch as the JAX version is inline
jnp; unlike JAX it writes the new K/V row into the cache in place.  Under
tensor-parallel serving it runs on a rank's heads (``w=``, ``heads=``, as
``attn_full``); a rank that holds a slice of the cache's positions takes
its slice's softmax partials (``decode_partials``), which are combined by
their log-sum-exp (``combine_partials``).  The
serving engine decodes through its paged pool instead (K1).
``attn_cross`` (the encoder-decoder family) is non-causal attention of the
decoder's queries against the encoder's precomputed K/V, through the same
``ops.flash_attention``; it takes those K/V in the kernel's (B, Hkv, F, hd)
layout, where JAX keeps (B, F, Hkv, hd), so a decode step copies none.  A
rank that holds a slice of the frames takes its slice's output and
log-sum-exp (K2's LSE route), and the slices are joined by their
log-sum-exp (``combine_lse``).
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


def qkv_products(cfg: ArchCfg, w, xq: torch.Tensor, xkv: torch.Tensor):
    """xq @ wq, xkv @ wk and xkv @ wv, biases added, unsplit into heads;
    ``w`` reads a weight by name."""
    q, k, v = xq @ w("wq"), xkv @ w("wk"), xkv @ w("wv")
    if cfg.qkv_bias:
        q, k, v = q + w("bq"), k + w("bk"), v + w("bv")
    return q, k, v


def _project_qkv(cfg: ArchCfg, p: Params, xq: torch.Tensor,
                 xkv: torch.Tensor, *, w=None, heads=None):
    """q (B, Sq, H, hd), k and v (B, Skv, Hkv, hd).  ``w`` reads a weight
    by name (default ``p[name]``) and ``heads`` is the (H, Hkv) its
    weights give (default the config's): the tensor-parallel stack passes
    its rank's slices and head counts."""
    H, Hkv = heads or (cfg.n_heads, cfg.n_kv_heads)
    hd = cfg.resolved_head_dim
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    q, k, v = qkv_products(cfg, w or p.__getitem__, xq, xkv)
    q = q.reshape(B, Sq, H, hd)
    k = k.reshape(B, Skv, Hkv, hd)
    v = v.reshape(B, Skv, Hkv, hd)
    return q, k, v


def compute_dtype(cfg: ArchCfg) -> torch.dtype:
    return torch.bfloat16 if cfg.attn_dtype == "bf16" else torch.float32


def attn_full(cfg: ArchCfg, p: Params, x: torch.Tensor, *, freqs=None,
              causal: bool = True, positions=None, w=None, heads=None,
              kv=None):
    """Full-sequence self-attention (training / prefill).

    ``w`` and ``heads`` as in ``_project_qkv``; ``kv`` maps this call's
    (k, v) to the keys and values its queries attend to (default: those;
    the sequence-sliced stack gathers the other ranks' in front of its
    own, so causal keys stay right-aligned).  Returns (out, (k, v)) so
    prefill can persist the cache; out is the product with ``w("wo")``."""
    w = w or p.__getitem__
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, x, w=w, heads=heads)
    if freqs is not None:
        pos = positions if positions is not None else \
            torch.arange(S, device=x.device)[None]
        q = apply_rope(q, pos, freqs)
        k = apply_rope(k, pos, freqs)
    ka, va = kv(k, v) if kv is not None else (k, v)
    # the kernel takes contiguous (B, H, S, D)
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              ka.transpose(1, 2).contiguous(),
                              va.transpose(1, 2).contiguous(), causal=causal,
                              compute_dtype=compute_dtype(cfg))
    out = out.transpose(1, 2).reshape(B, S, -1)
    return out @ w("wo"), (k, v)


def attn_cross(cfg: ArchCfg, p: Params, x: torch.Tensor, kv_cache, *,
               w=None, heads=None):
    """Cross-attention against precomputed (k, v) from the encoder.

    x: (B, S, d); k, v: contiguous (B, Hkv, F, hd), the kernel's layout.
    Non-causal, so a query row sees every key: only F = 0 leaves a row
    empty, and that row gives 0 (``ref.mha_attention``, K2).  ``w`` and
    ``heads`` as in ``attn_full`` (the head-parallel rank's slices and
    head counts: k and v then hold its KV heads, and the result is its
    partial product with wo)."""
    w = w or p.__getitem__
    B, S, _ = x.shape
    H = heads[0] if heads else cfg.n_heads
    hd = cfg.resolved_head_dim
    q = x @ w("wq")
    if cfg.qkv_bias:
        q = q + w("bq")
    q = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
    k, v = kv_cache
    out = ops.flash_attention(q, k, v, causal=False,
                              compute_dtype=compute_dtype(cfg))
    out = out.transpose(1, 2).reshape(B, S, -1)
    return out @ w("wo")


def combine_lse(o, lse, *, rmax=None, rsum=None):
    """The attention over every slice of the keys from the slices' (o,
    lse), stacked on a leading dim (each slice's output and fp32 log-sum-
    exp, ``ops.flash_attention(..., return_lse=True)``): ``combine_partials``
    with m = lse and l = 1 (an empty slice, lse = +inf, with m = -inf and
    l = 0).  fp32; ``rmax`` and ``rsum`` as there."""
    seen = torch.isfinite(lse)
    m = torch.where(seen, lse, float("-inf"))
    return combine_partials(o.float(), m, seen.float(), rmax=rmax,
                            rsum=rsum)


def init_kv_cache(cfg: ArchCfg, batch: int, max_len: int, *, layers: int,
                  device="cuda") -> dict:
    """{"k", "v"}: zeros of (layers, batch, max_len, Hkv, hd) in cfg.dtype."""
    hd = cfg.resolved_head_dim
    shape = (layers, batch, max_len, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def attn_decode(cfg: ArchCfg, p: Params, x: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int, *,
                freqs=None, w=None, heads=None):
    """One-token decode against a dense cache.

    x: (B, 1, d); k_cache/v_cache: (B, S_max, Hkv, hd); pos: the index this
    token writes to (== the current context length).  The new K/V row is
    written into the caches IN PLACE (JAX returns updated copies); returns
    (out, k_cache, v_cache) with the caches the same tensors.  ``w`` and
    ``heads`` as in ``attn_full`` (the head-parallel rank's slices: its
    caches hold its KV heads, and ``out`` is its partial product with
    wo)."""
    w = w or p.__getitem__
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, x, w=w, heads=heads)
    if freqs is not None:                      # (B,1,H,hd)/(B,1,Hkv,hd)
        q, k = rope_at(q, k, pos, freqs)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    visible = torch.arange(k_cache.shape[1], device=x.device) <= pos
    out = attend_decode(cfg, q[:, 0], k_cache, v_cache, visible)
    return out.to(x.dtype).reshape(B, 1, -1) @ w("wo"), k_cache, v_cache


def rope_at(q: torch.Tensor, k: torch.Tensor, pos: int, freqs):
    """RoPE on a decode step's q (B, 1, H, hd) and k (B, 1, Hkv, hd), both
    at position ``pos``."""
    posb = torch.full((q.shape[0], 1), pos, device=q.device)
    return apply_rope(q, posb, freqs), apply_rope(k, posb, freqs)


def _scores(cfg: ArchCfg, q, k_cache, v_cache, visible):
    """The logits of q (B, H, hd) against a cache (B, S, Hkv, hd), -inf
    where not ``visible``, and ``pv(probs)``: the (B, H, hd) fp32 product
    with the values.  Under bf16 compute q * scale and the probabilities
    are rounded to bf16, the cache is read in its own dtype and the
    grouped-query products accumulate in fp32 (JAX's ``attn_decode``);
    else fp32 with the KV heads repeated over their group."""
    B, H, hd = q.shape
    Hkv = k_cache.shape[2]
    group = H // Hkv
    if compute_dtype(cfg) == torch.bfloat16:
        qf = (q.float() * hd ** -0.5).to(torch.bfloat16).float()
        q4 = qf.reshape(B, Hkv, group, hd)
        logits = torch.einsum("bkgd,bskd->bkgs", q4, k_cache.float())
        logits = logits.masked_fill(~visible, float("-inf"))
        return logits, lambda probs: torch.einsum(
            "bkgs,bskd->bkgd", probs.to(torch.bfloat16).float(),
            v_cache.float()).reshape(B, H, hd)
    qf = q.float() * hd ** -0.5
    kf, vf = k_cache.float(), v_cache.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", qf, kf)
    logits = logits.masked_fill(~visible, float("-inf"))
    return logits, lambda probs: torch.einsum("bhs,bshd->bhd", probs, vf)


def attend_decode(cfg: ArchCfg, q, k_cache, v_cache, visible):
    """q (B, H, hd) over the whole cache's ``visible`` positions: (B, H,
    hd) fp32, one softmax over the sequence."""
    logits, pv = _scores(cfg, q, k_cache, v_cache, visible)
    return pv(torch.softmax(logits, -1))


def decode_partials(cfg: ArchCfg, q, k_cache, v_cache, visible):
    """``attend_decode`` over one slice of the positions: (o, m, l), o
    (B, H, hd) fp32 the slice's own softmax applied to its values, m and l
    (B, H) its largest logit and its sum of exp(logit - m).  A slice with
    no visible position gives m = -inf, l = 0 and o = 0.  Under bf16
    compute the slice's probabilities are rounded to bf16, where the whole
    sequence's are (``attend_decode``): the two part by that rounding."""
    logits, pv = _scores(cfg, q, k_cache, v_cache, visible)
    m = logits.amax(-1)
    e = torch.exp(logits - torch.where(torch.isfinite(m), m, 0)[..., None])
    l = e.sum(-1)
    o = pv(e / torch.where(l > 0, l, 1)[..., None])
    B, H = q.shape[:2]
    return o, m.reshape(B, H), l.reshape(B, H)


def combine_partials(o, m, l, *, rmax=None, rsum=None):
    """The whole sequence's decode attention from its slices' partials,
    stacked on a leading dim (``decode_partials``): with m* the largest m,
    o = sum_r e^(m_r - m*) l_r o_r / sum_r e^(m_r - m*) l_r.  ``rmax`` and
    ``rsum`` reduce over the slices keeping that dim (default: over the
    stack; a rank of a "model" line holding one slice passes the max and
    sum all-reduces).  An empty slice weighs 0; a row with none visible
    gives 0."""
    rmax = rmax or (lambda t: t.amax(0, keepdim=True))
    rsum = rsum or (lambda t: t.sum(0, keepdim=True))
    top = rmax(m)
    wgt = torch.exp(m - torch.where(torch.isfinite(top), top, 0)) * l
    nd = rsum(torch.cat([wgt[..., None] * o, wgt[..., None]], -1))[0]
    den = nd[..., -1:]
    return nd[..., :-1] / torch.where(den > 0, den, 1)
