"""Plain PyTorch versions of the attention kernels.

The counterparts of the JAX package's ``kernels/ref.py`` oracles for the
two kernels of the serving path.  ``ops`` runs them for tensors on the CPU
(the tests), and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.  The main path never runs them when a card is present.

One deliberate difference from the JAX references: a query row that sees
no key (``seq_len == 0``, or causal ``Sq > Skv`` above the first key)
returns 0, as the Pallas kernels and the CUDA kernels do, where the JAX
references return NaN from a softmax over nothing.
"""
from __future__ import annotations

import torch


def _softmax_rows(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of the unmasked entries; a row with no
    unmasked entry gives all zeros (not NaN)."""
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    return p / torch.where(denom == 0, torch.ones_like(denom), denom)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float | None = None,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Multi-head attention with grouped KV heads.

    q: (B, H, Sq, D);  k, v: (B, Hkv, Skv, D) with H % Hkv == 0.  Causal
    keys are right-aligned: query i sees keys <= i + (Skv - Sq).
    Returns (B, H, Sq, D) in q.dtype; softmax in fp32.

    ``compute_dtype`` is the dtype the products' operands are rounded to
    (``q*scale``, ``k``, ``v`` and the probabilities); accumulation is fp32
    either way.
    """
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    group = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = (q.float() * scale).to(compute_dtype).float()
    kf = k.to(compute_dtype).float()
    vf = v.to(compute_dtype).float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        ki = torch.arange(Skv, device=q.device)[None, :]
        mask = ki <= qi
    else:
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    probs = _softmax_rows(logits, mask)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(compute_dtype).float(), vf)
    return out.to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """Decode attention for one new token per sequence over a paged KV cache.

    q:          (B, H, D)      — current-step queries
    k_pages:    (P, page, Hkv, D) — physical page pool
    v_pages:    (P, page, Hkv, D)
    page_table: (B, max_pages) int32 — virtual->physical translation
    seq_lens:   (B,) int32     — valid tokens per sequence (cache length)
    Returns (B, H, D) in q.dtype.

    The "software walk": gather every sequence's pages with tensor indexing
    first, then dense attention.
    """
    B, H, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    max_pages = page_table.shape[1]
    group = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    pt = page_table.long()
    k_seq = k_pages[pt].reshape(B, max_pages * page, Hkv, D)
    v_seq = v_pages[pt].reshape(B, max_pages * page, Hkv, D)
    qf = q.float() * scale
    kf = k_seq.float()
    vf = v_seq.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", qf, kf)
    pos = torch.arange(max_pages * page, device=q.device)
    mask = (pos[None, :] < seq_lens[:, None].long())[:, None, :]
    probs = _softmax_rows(logits, mask)
    out = torch.einsum("bhs,bshd->bhd", probs, vf)
    return out.to(q.dtype)
