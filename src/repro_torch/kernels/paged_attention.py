"""K1: paged decode attention — wrapper of ``csrc/paged_attention.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
``repro/kernels/paged_attention.py::paged_attention``: one-token decode
attention over a paged K/V pool, with the page table read inside the kernel
(the §2.2 hardware TLB).  Its plain version is ``kernels/ref.py::
paged_attention``; ``kernels/ops.py`` picks between them by the tensors'
device.  This wrapper takes CUDA tensors only and never falls back.

The kernel is split-K (flash-decoding): partitions of ``PART_KEYS`` keys,
one block each, write partials to an fp32 scratch that a second kernel of
the same call combines.  The number of partitions comes from the page
table's shape alone: the wrapper never reads ``seq_lens`` on the host, so
it does not synchronise with the card.  ``paged_attention.last_blocks``
holds the partial kernel's grid size as the last launch set it.

That split-K route takes D = 64 and 128.  Any other D up to
``MAX_HEAD_DIM`` (the reduced configs' 16) takes the small-width route,
``paged_small_kernel``: one block a (head, sequence), scalar loads through
the page table, one key a thread, fp32 online softmax.  ``routes`` counts
the launches of each route ("split_k", "small"); a wider head raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)      # the split-K route's widths
MAX_HEAD_DIM = 128         # the small-width route takes any other D up to it
PART_KEYS = 128   # keys a partition (one block per partition and KV head)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B,H,D); k_pages/v_pages: (P,page,Hkv,D); page_table:
    (B,max_pages) int32; seq_lens: (B,) int32 -> (B,H,D) in q.dtype.

    Page ids are trusted (the caller's page table must hold ids < P), as
    the Pallas kernel trusts its scalar-prefetched table."""
    _build.refuse_grad("paged_attention", f"see {_build.NO_BACKWARD}", q,
                       k_pages, v_pages)
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
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"paged_attention kernel: head width D={D} is "
                         f"above the widest this kernel takes, "
                         f"{MAX_HEAD_DIM}")
    if Dk != D or v_pages.shape != k_pages.shape \
            or H % Hkv or page_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(
            f"paged_attention kernel: unsupported shapes q {tuple(q.shape)}, "
            f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
            f"page_table {tuple(page_table.shape)}, seq_lens "
            f"{tuple(seq_lens.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel: tensors must be contiguous")
    small = D not in HEAD_DIMS
    if not small and any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention kernel: q and the pools must be "
                         "16-byte aligned (rows are read 16 bytes at a "
                         "time)")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    max_pages = page_table.shape[1]
    n_split = -(-max_pages * page // PART_KEYS)
    if out.numel() == 0 or n_split == 0:
        return out.zero_()
    # the small-width route keeps no partials
    part = torch.empty(1 if small else B * H * n_split * (D + 2),
                       dtype=torch.float32, device=q.device)
    fn = _build.load("paged_attention")
    blocks = ctypes.c_int(0)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), part.data_ptr(),
             out.data_ptr(), B, H, Hkv, D, page, max_pages, PART_KEYS,
             float(scale), DTYPES[q.dtype], ctypes.byref(blocks),
             _build.raw_stream(q.device))
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    _build.count(paged_attention, "small" if small else "split_k")
    if cost.active():   # the resident keys: read back only under analysis
        cost.launched("paged_attention", cost.paged_attention, B, H, Hkv, D,
                      page, max_pages, seq_lens.tolist(), q.element_size())
    paged_attention.last_blocks = blocks.value
    return out


paged_attention.launches = 0
paged_attention.routes = {}
paged_attention.last_blocks = 0
