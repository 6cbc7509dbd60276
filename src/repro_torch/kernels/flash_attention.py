"""K2: blocked causal GQA attention — wrapper of ``csrc/flash_attention.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``, computing the
function of ``repro/kernels/ref.py::mha_attention`` that whole-prompt
prefill runs, ``compute_dtype`` included.  Unlike the Pallas kernel it
needs no block-divisible sequence lengths: ragged tails are masked.  Its
plain version is ``kernels/ref.py::mha_attention``; ``kernels/ops.py``
picks between them by the tensors' device.  This wrapper takes CUDA tensors
only and never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COMPUTE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """q: (B,H,Sq,D), k/v: (B,Hkv,Skv,D) -> (B,H,Sq,D) in q.dtype."""
    if any(t.device.type != "cuda" or t.device != q.device
           for t in (q, k, v)):
        raise ValueError("flash_attention kernel: q, k, v must lie on the "
                         "same CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel: q/k/v must share a dtype "
                        f"in {list(DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"flash_attention kernel: compute_dtype must be one "
                        f"of {list(COMPUTE_DTYPES)}, got {compute_dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention kernel: expected q (B,H,Sq,D), "
                         "k/v (B,Hkv,Skv,D)")
    B, H, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if D not in HEAD_DIMS or Dk != D or Bk != B or v.shape != k.shape \
            or H % Hkv:
        raise ValueError(
            f"flash_attention kernel: unsupported shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)} (D must be one of "
            f"{HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel: tensors must be contiguous")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.load("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, Hkv, Sq, Skv, D, int(causal), float(scale),
             COMPUTE_DTYPES[compute_dtype], DTYPES[q.dtype],
             _build.raw_stream(q.device))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
