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
  * tensors on the ``meta`` device (the dry run's, ``launch/dryrun.py``)
    take no implementation at all: the kernel's outputs, of its shapes
    and dtypes (K2's LSE included), with no values, and the kernel's cost
    (``kernels/cost.py``) reported to the active analysis; under grad an
    autograd Function whose backward reports K2-bwd, K3-bwd or K4-bwd, and
    K1 raises as on the card.  Meta computes nothing, so it stands in for
    neither the card nor the plain versions;
  * any other device raises.

The card's wrappers report the same cost for each launch.

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

from repro_torch.kernels import _build, cost
from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_scan as _m2
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _rw


def _route(x: torch.Tensor, name: str) -> str:
    """"cuda", "cpu" or "meta": where ``name`` runs for tensors like x."""
    if x.device.type in ("cuda", "cpu", "meta"):
        return x.device.type
    raise ValueError(f"{name}: no implementation for device {x.device}")


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    compute_dtype: torch.dtype = torch.float32,
                    return_lse: bool = False):
    """q: (B,H,Sq,D), k/v: (B,Hkv,Skv,D) -> (B,H,Sq,D).  On the card with
    grad enabled and an input requiring grad, K2 runs inside an autograd
    Function whose backward is K2-bwd.  ``return_lse`` (serving only: no
    gradient) returns (out, fp32 LSE (B,H,Sq) of the scaled logits, +inf
    where a row sees no key), on the card through K2's LSE route
    (``flash_attention_lse``)."""
    route = _route(q, "flash_attention")
    if return_lse:
        return _attention_lse(route, q, k, v, causal, scale, compute_dtype)
    if route == "meta":
        if _wants_grad(q, k, v):
            return _MetaAttentionFn.apply(q, k, v, causal)
        return _meta_attention(q, k, causal)
    if route == "cuda":
        if _wants_grad(q, k, v):
            return _fa.FlashAttentionFn.apply(q, k, v, causal, scale,
                                              compute_dtype)
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                   compute_dtype=compute_dtype)
    return ref.mha_attention(q, k, v, causal=causal, scale=scale,
                             compute_dtype=compute_dtype)


def _attention_lse(route, q, k, v, causal, scale, compute_dtype):
    if route == "cuda":
        return _fa.flash_attention_lse(q, k, v, causal=causal, scale=scale,
                                       compute_dtype=compute_dtype)
    _build.refuse_grad("flash_attention_lse", "serving runs it only",
                       q, k, v)
    if route == "meta":
        B, H, Sq, D = q.shape
        cost.launched("flash_attention_lse", cost.flash_attention, B, H,
                      k.shape[1], Sq, k.shape[2], D, causal,
                      q.element_size(), lse=True)
        return torch.empty_like(q), torch.empty(
            (B, H, Sq), dtype=torch.float32, device="meta")
    return ref.mha_attention(q, k, v, causal=causal, scale=scale,
                             compute_dtype=compute_dtype, return_lse=True)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                    scale=None):
    """q: (B,H,D); pages: (P,page,Hkv,D); page_table: (B,max_pages) int32;
    seq_lens: (B,) int32 -> (B,H,D)."""
    route = _route(q, "paged_attention")
    if route == "meta":
        _build.refuse_grad("paged_attention",
                           f"see {_build.NO_BACKWARD}", q, k_pages, v_pages)
        # no values to read: every row counted at the table's capacity
        B, H, D = q.shape
        cost.launched("paged_attention", cost.paged_attention, B, H,
                      k_pages.shape[2], D, k_pages.shape[1],
                      page_table.shape[1],
                      [page_table.shape[1] * k_pages.shape[1]] * B,
                      q.element_size())
        return torch.empty_like(q)
    if route == "cuda":
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
    route = _route(x, "mamba2_scan")
    if route == "meta":
        if _wants_grad(x, dt, A, Bmat, Cmat, D, h0):
            return _MetaMamba2Fn.apply(x, dt, A, Bmat, Cmat, D, h0,
                                       return_state)
        return _meta_mamba2(x, Bmat, h0, return_state)
    if route == "cuda":
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
    route = _route(r, "rwkv6_scan")
    if route == "meta":
        if _wants_grad(r, k, v, w, u, s0):
            return _MetaRwkv6Fn.apply(r, k, v, w, u, s0, return_state)
        return _meta_rwkv6(r, s0, return_state)
    if route == "cuda":
        if _wants_grad(r, k, v, w, u, s0):
            return _rw.Rwkv6ScanFn.apply(r, k, v, w, u, s0, return_state)
        return _rw.rwkv6_scan(r, k, v, w, u, s0=s0,
                              return_state=return_state)
    return ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0,
                                  return_state=return_state)


def rwkv6_scan_split(r, k, v, w, u, s0=None):
    """One decode step on a slice of the key channels (a rank's share of a
    wkv state split over "model"): r/k/w (B,1,H,dk), v (B,1,H,dv), u
    (H,dk), s0 (B,H,dk,dv) -> (y_part (B,1,H,dv) fp32, the slice's part of
    the readout; the new state rows (B,H,dk,dv) fp32).  Serving only: on
    the card it has no backward, and raises under grad."""
    route = _route(r, "rwkv6_scan_split")
    if route == "cuda":
        _build.refuse_grad("rwkv6_scan_split", "serving runs it only",
                           r, k, v, w, u, s0)
        return _rw.rwkv6_scan_split(r, k, v, w, u, s0)
    if route == "meta":
        B, _, H, dk = r.shape
        dv = v.shape[-1]
        cost.launched("rwkv6_scan_split", cost.rwkv6_scan_split, B, H, dk,
                      dv, r.element_size(), state_in=s0 is not None)
        return (torch.empty((B, 1, H, dv), dtype=torch.float32,
                            device="meta"),
                torch.empty((B, H, dk, dv), dtype=torch.float32,
                            device="meta"))
    return ref.rwkv6_scan_split(r, k, v, w, u, s0)


def launch_counts() -> dict[str, int]:
    """Each hand-written kernel's launches in this process, by wrapper."""
    return {fn.__name__: fn.launches for fn in (
        _pa.paged_attention, _fa.flash_attention, _fa.flash_attention_lse,
        _fa.flash_attention_bwd,
        _m2.mamba2_scan, _m2.mamba2_scan_bwd, _rw.rwkv6_scan,
        _rw.rwkv6_scan_split, _rw.rwkv6_scan_bwd, _adamw.fused_adamw)}


# ----------------------------------------------------------------------------
# the meta route: the kernels' outputs with no values, their cost reported
# ----------------------------------------------------------------------------

def _meta_attention(q, k, causal):
    B, H, Sq, D = q.shape
    cost.launched("flash_attention", cost.flash_attention, B, H, k.shape[1],
                  Sq, k.shape[2], D, causal, q.element_size())
    return torch.empty_like(q)


class _MetaAttentionFn(torch.autograd.Function):
    """K2 with its LSE, and K2-bwd, on meta tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = _meta_attention(q, k, causal)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, _, _ = ctx.saved_tensors
        B, H, Sq, D = q.shape
        cost.launched("flash_attention_bwd", cost.flash_attention_bwd, B, H,
                      k.shape[1], Sq, k.shape[2], D, ctx.causal,
                      q.element_size())
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None)


def _meta_mamba2(x, Bmat, h0, return_state):
    B, S, H, dh = x.shape
    ds = Bmat.shape[-1]
    cost.launched("mamba2_scan", cost.mamba2_scan, B, S, H, dh, ds,
                  x.element_size(), state_in=h0 is not None,
                  state_out=return_state)
    y = torch.empty((B, S, H, dh), dtype=x.dtype, device=x.device)
    if not return_state:
        return y
    return y, torch.empty((B, H, ds, dh), dtype=torch.float32,
                          device=x.device)


class _MetaMamba2Fn(torch.autograd.Function):
    """K3 and K3-bwd on meta tensors (gradients in the inputs' dtypes, as
    ``Mamba2ScanFn`` gives them)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, D, h0, return_state):
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, D, h0)
        return _meta_mamba2(x, Bmat, h0, return_state)

    @staticmethod
    def backward(ctx, *grads):
        x, dt, A, Bmat, Cmat, D, h0 = ctx.saved_tensors
        B, S, H, dh = x.shape
        cost.launched("mamba2_scan_bwd", cost.mamba2_scan_bwd, B, S, H, dh,
                      Bmat.shape[-1], x.element_size())
        need_dh0 = h0 is not None and ctx.needs_input_grad[6]
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                *(torch.empty_like(t) for t in (dt, A)),
                *(torch.empty(t.shape, dtype=x.dtype, device=x.device)
                  for t in (Bmat, Cmat)),
                torch.empty_like(D),
                torch.empty_like(h0) if need_dh0 else None, None)


def _meta_rwkv6(r, s0, return_state):
    B, S, H, dh = r.shape
    cost.launched("rwkv6_scan", cost.rwkv6_scan, B, S, H, dh,
                  r.element_size(), state_in=s0 is not None,
                  state_out=return_state)
    y = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    if not return_state:
        return y
    return y, torch.empty((B, H, dh, dh), dtype=torch.float32,
                          device=r.device)


class _MetaRwkv6Fn(torch.autograd.Function):
    """K4 and K4-bwd on meta tensors (gradients in the inputs' dtypes, as
    ``Rwkv6ScanFn`` gives them)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, return_state):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _meta_rwkv6(r, s0, return_state)

    @staticmethod
    def backward(ctx, *grads):
        r, k, v, w, u, s0 = ctx.saved_tensors
        B, S, H, dh = r.shape
        cost.launched("rwkv6_scan_bwd", cost.rwkv6_scan_bwd, B, S, H, dh,
                      r.element_size())
        need_ds0 = s0 is not None and ctx.needs_input_grad[5]
        return (*(torch.empty(t.shape, dtype=r.dtype, device=r.device)
                  for t in (r, k, v, w)),
                torch.empty_like(u),
                torch.empty_like(s0) if need_ds0 else None, None)


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
