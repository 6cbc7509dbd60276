"""Public kernel API: dispatch by the tensors' device.

  * tensors on the CPU take the plain PyTorch version (``kernels/ref.py``);
  * tensors on a CUDA device take the CUDA kernel, which raises if it cannot
    build or launch — there is no quiet fallback to the plain version; with
    grad enabled and an input requiring grad, attention takes K2 with its
    backward kernel K2-bwd, the Mamba2 scan K3 with K3-bwd and the RWKV6
    scan K4 with K4-bwd (each pair an autograd Function), and paged
    attention (K1, which only serving runs, and which has no backward)
    raises in its wrapper rather than return an output cut off from the
    graph;
  * any other device raises.

Signatures and layouts are the JAX package's ``kernels/ops.py``, without
its ``impl=`` knob: the device picks the implementation.  On the CPU the
scans take their chunked plain versions, as JAX's ``impl="auto"`` does off
the TPU; on the card the kernels K3 and K4 take the ``h0``/``s0`` and
``return_state`` contract themselves, where the Pallas kernels leave it to
the chunked jnp reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_scan as _m2
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _rw


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no implementation for device {x.device}")


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    compute_dtype: torch.dtype = torch.float32):
    """q: (B,H,Sq,D), k/v: (B,Hkv,Skv,D) -> (B,H,Sq,D).  On the card with
    grad enabled and an input requiring grad, K2 runs inside an autograd
    Function whose backward is K2-bwd."""
    if _on_cuda(q, "flash_attention"):
        if _wants_grad(q, k, v):
            return _fa.FlashAttentionFn.apply(q, k, v, causal, scale,
                                              compute_dtype)
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


def mamba2_scan(x, dt, A, Bmat, Cmat, D, *, h0=None,
                return_state: bool = False):
    """x: (B,S,H,dh), dt: (B,S,H), A/D: (H,), Bmat/Cmat: (B,S,ds), h0:
    (B,H,ds,dh) -> y like x [, final state (B,H,ds,dh) fp32].  On the card
    with grad enabled and an input requiring grad, K3 runs inside an
    autograd Function whose backward is K3-bwd."""
    if _on_cuda(x, "mamba2_scan"):
        if _wants_grad(x, dt, A, Bmat, Cmat, D, h0):
            return _m2.Mamba2ScanFn.apply(x, dt, A, Bmat, Cmat, D, h0,
                                          return_state)
        return _m2.mamba2_scan(x, dt, A, Bmat, Cmat, D, h0=h0,
                               return_state=return_state)
    return ref.mamba2_scan_chunked(x, dt, A, Bmat, Cmat, D, h0=h0,
                                   return_state=return_state)


def rwkv6_scan(r, k, v, w, u, *, s0=None, return_state: bool = False):
    """r/k/v/w: (B,S,H,dh), u: (H,dh), s0: (B,H,dh,dh) -> y like r
    [, final state (B,H,dh,dh) fp32].  On the card with grad enabled and an
    input requiring grad, K4 runs inside an autograd Function whose
    backward is K4-bwd."""
    if _on_cuda(r, "rwkv6_scan"):
        if _wants_grad(r, k, v, w, u, s0):
            return _rw.Rwkv6ScanFn.apply(r, k, v, w, u, s0, return_state)
        return _rw.rwkv6_scan(r, k, v, w, u, s0=s0,
                              return_state=return_state)
    return ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0,
                                  return_state=return_state)
