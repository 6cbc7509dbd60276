"""K2: blocked causal GQA attention — wrapper of ``csrc/flash_attention.cu``,
and its backward K2-bwd — wrapper of ``csrc/flash_attention_bwd.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``, computing the
function of ``repro/kernels/ref.py::mha_attention`` that whole-prompt
prefill and every training layer run, ``compute_dtype`` included.  Unlike
the Pallas kernel it needs no block-divisible sequence lengths: ragged
tails are masked.  Its plain version is ``kernels/ref.py::mha_attention``;
``kernels/ops.py`` picks between them by the tensors' device.

Routes, by width and dtype (``last_kernel``; ``routes`` counts each): bf16
with D = 64 or 128 takes the tensor-core kernel, fp32 with D = 64 or 128
the FMA kernel, and any other D up to ``MAX_HEAD_DIM`` (the reduced
configs' 16) the small-width route, the FMA kernel laid out 64 or 128 wide
with the columns past D zero, in either dtype.  A wider head raises.
K2-bwd's routes follow the same rule: bf16 with D = 64 takes its ``wgmma``
pair, bf16 with D = 128 the same pair at 128 columns (``wgmma128``), fp32
with D = 64 or 128 its FMA pair (``fma``), any other D the FMA pair at a
small width (``small``).

``flash_attention_lse`` is the same kernel writing its per-row log-sum-
exp beside the output, as a serving route of its own (its own count): a
rank holding a slice of the keys (the encoder-decoder's cross K/V split
over its frames) joins the slices by their LSE.

The Pallas kernel has no backward (JAX trains through the jnp attention).
Here the gradient is a kernel too: ``FlashAttentionFn`` runs the forward
with its per-row log-sum-exp and the backward through
``flash_attention_bwd``, so a training step on the card never leaves the
hand-written kernels; its plain version is autograd through
``ref.mha_attention``.  The wrappers take CUDA tensors only and never fall
back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COMPUTE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)      # the fast routes' widths
MAX_HEAD_DIM = 128         # the small-width route takes any other D up to it
# K2's device kernel and route, by the id its C entry point writes to its
# ``kernel`` out-parameter
KERNELS = ("flash_attention_kernel", "flash_attention_mma_kernel",
           "flash_attention_kernel")
ROUTES = ("fp32", "mma", "small")
_route = ctypes.c_int(-1)
_ROUTE_ADDR = ctypes.addressof(_route)
# K2-bwd's device kernels (dK/dV, dQ) and route, by the id its C entry
# point writes: the FMA pair (fp32), the wgmma pair at D = 64 (bf16), the
# FMA pair at a small width, the wgmma pair at D = 128 (bf16)
BWD_KERNELS = (("attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel"),
               ("attn_bwd_dkdv_wgmma_kernel<64>",
                "attn_bwd_dq_wgmma_kernel<64>"),
               ("attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel"),
               ("attn_bwd_dkdv_wgmma_kernel<128>",
                "attn_bwd_dq_wgmma_kernel<128>"))
BWD_ROUTES = ("fma", "wgmma", "small", "wgmma128")
BWD_WGMMA = {64: 1, 128: 3}  # bf16 head width -> its wgmma pair's id
_bwd_route = ctypes.c_int(-1)
_BWD_ROUTE_ADDR = ctypes.addressof(_bwd_route)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           compute_dtype: torch.dtype, what: str = "flash_attention"):
    if any(t.device.type != "cuda" or t.device != q.device
           for t in (q, k, v)):
        raise ValueError(f"{what} kernel: q, k, v must lie on the same CUDA "
                         "device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel: q/k/v must share a dtype in "
                        f"{list(DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"{what} kernel: compute_dtype must be one of "
                        f"{list(COMPUTE_DTYPES)}, got {compute_dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what} kernel: expected q (B,H,Sq,D), k/v "
                         "(B,Hkv,Skv,D)")
    B, H, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{what} kernel: head width D={D} is above the "
                         f"widest this kernel takes, {MAX_HEAD_DIM}")
    if Dk != D or Bk != B or v.shape != k.shape or H % Hkv:
        raise ValueError(
            f"{what} kernel: unsupported shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what} kernel: tensors must be contiguous")


def _forward(q, k, v, causal, scale, compute_dtype, lse, counted=None):
    """One launch of K2, counted under ``counted`` (default
    ``flash_attention``), its LSE written where ``lse`` is given."""
    counted = counted or flash_attention
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.load("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             0 if lse is None else lse.data_ptr(),
             B, H, Hkv, Sq, Skv, D, int(causal), float(scale),
             COMPUTE_DTYPES[compute_dtype], DTYPES[q.dtype], _ROUTE_ADDR,
             _build.raw_stream(q.device))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    _build.count(counted, ROUTES[_route.value])
    cost.launched(counted.__name__, cost.flash_attention, B, H, Hkv, Sq, Skv,
                  D, causal, q.element_size(),
                  lse=counted is flash_attention_lse)
    counted.last_kernel = KERNELS[_route.value]
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """q: (B,H,Sq,D), k/v: (B,Hkv,Skv,D) -> (B,H,Sq,D) in q.dtype.  The
    output carries no gradient, so under grad it raises: training goes
    through ``FlashAttentionFn`` (``ops.flash_attention`` picks it)."""
    _build.refuse_grad("flash_attention", "differentiate through "
                       "FlashAttentionFn (ops.flash_attention picks it)",
                       q, k, v)
    _check(q, k, v, compute_dtype)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _forward(q, k, v, causal, scale, compute_dtype, None)


flash_attention.launches = 0
flash_attention.routes = {}
flash_attention.last_kernel = None


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None,
                        compute_dtype: torch.dtype = torch.float32):
    """K2 with its per-row log-sum-exp as a serving route of its own: (out
    (B,H,Sq,D) in q.dtype, fp32 lse (B,H,Sq) of the scaled logits, +inf
    where a row sees no key).  A rank of a "model" line that holds a slice
    of the keys (the cross-attention's frames) combines the slices' outputs
    by their LSE.  Counted apart from ``flash_attention``; serving only, so
    it raises under grad."""
    _build.refuse_grad("flash_attention_lse", "serving runs it only",
                       q, k, v)
    _check(q, k, v, compute_dtype, "flash_attention_lse")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = _forward(q, k, v, causal, scale, compute_dtype, lse,
                   counted=flash_attention_lse)
    return out, lse


flash_attention_lse.launches = 0
flash_attention_lse.routes = {}
flash_attention_lse.last_kernel = None


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        scale: float | None = None,
                        compute_dtype: torch.dtype = torch.float32):
    """K2-bwd: (dq, dk, dv) of ``ref.mha_attention`` at (q, k, v), given the
    forward's ``out`` and fp32 ``lse`` (B, H, Sq) and the output gradient
    ``dout`` (q's shape and dtype).  One count per call (three kernels);
    ``flash_attention_bwd.last_kernel`` names the dK/dV and dQ kernels the
    call launched."""
    _check(q, k, v, compute_dtype, "flash_attention_bwd")
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("flash_attention_bwd kernel: out and dout must have "
                         "q's shape and dtype")
    if lse.dtype != torch.float32 or lse.shape != q.shape[:3]:
        raise ValueError("flash_attention_bwd kernel: lse must be fp32 "
                         f"{tuple(q.shape[:3])}")
    if any(t.device != q.device or not t.is_contiguous()
           for t in (out, dout, lse)):
        raise ValueError("flash_attention_bwd kernel: out, dout and lse "
                         "must be contiguous on q's device")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # TMA copies need 16-byte-aligned tensors: a view that starts off that
    # grid is copied (fresh allocations are aligned)
    q, k, v, out, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                          for t in (q, k, v, out, dout))
    # fp32 workspace: per row LSE * log2(e) and D_i, padded to whole 64-row
    # tiles, and under compute_dtype=bf16 the operand bf16(q * scale) (the
    # wgmma routes' pre-pass; the FMA pair reads D_i alone)
    sq_pad = -(-Sq // 64) * 64
    n = 2 * B * H * sq_pad
    if compute_dtype == torch.bfloat16:
        n += q.numel() // 2
    scratch = torch.empty(n, dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention_bwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), scratch.data_ptr(), B, H, Hkv, Sq, Skv, D,
             int(causal), float(scale), COMPUTE_DTYPES[compute_dtype],
             DTYPES[q.dtype], _BWD_ROUTE_ADDR, _build.raw_stream(q.device))
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _build.count(flash_attention_bwd, BWD_ROUTES[_bwd_route.value])
    cost.launched("flash_attention_bwd", cost.flash_attention_bwd, B, H, Hkv,
                  Sq, Skv, D, causal, q.element_size())
    flash_attention_bwd.last_kernel = BWD_KERNELS[_bwd_route.value]
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = {}
flash_attention_bwd.last_kernel = None


class FlashAttentionFn(torch.autograd.Function):
    """K2 forward (with its log-sum-exp) and K2-bwd as one differentiable
    function of (q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, compute_dtype):
        _check(q, k, v, compute_dtype)
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, causal, scale, compute_dtype, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.compute_dtype = causal, scale, compute_dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            scale=ctx.scale, compute_dtype=ctx.compute_dtype)
        return dq, dk, dv, None, None, None

