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

``sharded_flash_attention(mesh)`` and ``sharded_paged_attention(mesh)``
are the JAX module's ``shard_map``'d wrappers as one program a rank: the
callable each returns takes this rank's blocks of the inputs under JAX's
specs (batch over the data axes, query heads and the page pools' KV heads
over the model axis; ``in_specs`` / ``out_spec`` on the callable) and
returns its block of the output, the attention above on the local slice.
Heads are independent, so no attention state crosses ranks.
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


# ----------------------------------------------------------------------------
# per-rank wrappers over a mesh: batch over the data axes, heads over the
# model axis (JAX: ``shard_map`` with these specs); each rank passes its
# blocks (``parallel.spmd.shard``) and gets its block of the output
# (``parallel.spmd.unshard`` gathers the global one)
# ----------------------------------------------------------------------------

def _sharded(fn, mesh, in_specs, out_spec):
    def call(*blocks):
        if len(blocks) != len(in_specs):
            raise TypeError(f"expected {len(in_specs)} blocks, got "
                            f"{len(blocks)}")
        return fn(*blocks)

    call.mesh, call.in_specs, call.out_spec = mesh, in_specs, out_spec
    return call


def sharded_flash_attention(mesh, *, data_axes=("data",),
                            model_axis="model", **kw):
    """(q, k, v) blocks -> this rank's block of ``flash_attention(q, k, v,
    **kw)``: (B, H, S, D) laid out as P(data_axes, model_axis, None,
    None) for q, k, v and the output."""
    spec = (tuple(data_axes), model_axis, None, None)
    return _sharded(lambda q, k, v: flash_attention(q, k, v, **kw), mesh,
                    (spec,) * 3, spec)


def sharded_paged_attention(mesh, *, data_axes=("data",),
                            model_axis="model", **kw):
    """(q, k_pages, v_pages, page_table, seq_lens) blocks -> this rank's
    block of ``paged_attention(...)``: q and the output (B, H, D) over
    (data_axes, model_axis), the page pools over their KV heads, the
    table and lengths over data_axes."""
    qspec = (tuple(data_axes), model_axis, None)
    kvspec = (None, None, model_axis, None)
    return _sharded(
        lambda q, kp, vp, pt, sl: paged_attention(q, kp, vp, pt, sl, **kw),
        mesh, (qspec, kvspec, kvspec, (tuple(data_axes), None),
               (tuple(data_axes),)), qspec)
