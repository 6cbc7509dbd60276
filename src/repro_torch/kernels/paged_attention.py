"""K1: paged decode attention — wrapper of ``csrc/paged_attention.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
``repro/kernels/paged_attention.py::paged_attention``: one-token decode
attention over a paged K/V pool, with the page table read inside the kernel
(the §2.2 hardware TLB).  Its plain version is ``kernels/ref.py::
paged_attention``; ``kernels/ops.py`` picks between them by the tensors'
device.  This wrapper takes CUDA tensors only and never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B,H,D); k_pages/v_pages: (P,page,Hkv,D); page_table:
    (B,max_pages) int32; seq_lens: (B,) int32 -> (B,H,D) in q.dtype.

    Page ids are trusted (the caller's page table must hold ids < P), as
    the Pallas kernel trusts its scalar-prefetched table."""
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("paged_attention kernel: every tensor must lie on "
                         "the same CUDA device")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel: q/k/v must share a dtype "
                        f"in {list(DTYPES)}, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention kernel: page_table and seq_lens "
                        "must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or page_table.dim() != 2:
        raise ValueError("paged_attention kernel: expected q (B,H,D), pages "
                         "(P,page,Hkv,D), page_table (B,max_pages)")
    B, H, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    if D not in HEAD_DIMS or Dk != D or v_pages.shape != k_pages.shape \
            or H % Hkv or page_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(
            f"paged_attention kernel: unsupported shapes q {tuple(q.shape)}, "
            f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
            f"page_table {tuple(page_table.shape)}, seq_lens "
            f"{tuple(seq_lens.shape)} (D must be one of {HEAD_DIMS})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel: tensors must be contiguous")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.load("paged_attention")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
             B, H, Hkv, D, page, page_table.shape[1], float(scale),
             DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
