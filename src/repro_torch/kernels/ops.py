"""Public kernel API: dispatch by the tensors' device.

  * tensors on the CPU take the plain PyTorch version (``kernels/ref.py``);
  * tensors on a CUDA device take the CUDA kernel, which raises if it cannot
    build or launch — there is no quiet fallback to the plain version;
  * any other device raises.

Signatures and layouts are the JAX package's ``kernels/ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no implementation for device {x.device}")


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    compute_dtype: torch.dtype = torch.float32):
    """q: (B,H,Sq,D), k/v: (B,Hkv,Skv,D) -> (B,H,Sq,D)."""
    if _on_cuda(q, "flash_attention"):
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                   compute_dtype=compute_dtype)
    return ref.mha_attention(q, k, v, causal=causal, scale=scale,
                             compute_dtype=compute_dtype)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                    scale=None):
    """q: (B,H,D); pages: (P,page,Hkv,D); page_table: (B,max_pages) int32;
    seq_lens: (B,) int32 -> (B,H,D)."""
    if _on_cuda(q, "paged_attention"):
        return _pa.paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                                   scale=scale)
    return ref.paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                               scale=scale)
