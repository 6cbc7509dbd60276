"""K4: RWKV6 wkv recurrence — wrapper of ``csrc/rwkv6_scan.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
``repro/kernels/rwkv6_scan.py::rwkv6_scan``, computing the function of
``repro/kernels/ref.py::rwkv6_scan`` with its ``s0`` / ``return_state``
contract (the Pallas kernel takes no state and gives none back) for any
``S >= 1``.  Its plain version is ``kernels/ref.py::rwkv6_scan_chunked``;
``kernels/ops.py`` picks between them by the tensors' device.  This wrapper
takes CUDA tensors only and never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64,)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *,
               s0: torch.Tensor | None = None, return_state: bool = False):
    """r/k/v/w: (B,S,H,dh) of one dtype, contiguous; u: (H,dh); s0:
    (B,H,dh,dh) or None -> y (B,S,H,dh) in r.dtype [, final state (B,H,dh,dh)
    fp32].  ``u`` and ``s0`` are read as fp32 (cast here if they are not)."""
    seq = (r, k, v, w)
    if any(t.device.type != "cuda" or t.device != r.device
           for t in seq + (u,) + ((s0,) if s0 is not None else ())):
        raise ValueError("rwkv6_scan kernel: every tensor must lie on the "
                         "same CUDA device")
    if r.dtype not in DTYPES or any(t.dtype != r.dtype for t in seq):
        raise TypeError(f"rwkv6_scan kernel: r/k/v/w must share a dtype in "
                        f"{list(DTYPES)}, got {[t.dtype for t in seq]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in seq):
        raise ValueError(f"rwkv6_scan kernel: r/k/v/w must be (B,S,H,dh) of "
                         f"one shape, got {[tuple(t.shape) for t in seq]}")
    B, S, H, dh = r.shape
    if dh not in HEAD_DIMS or tuple(u.shape) != (H, dh) or (
            s0 is not None and tuple(s0.shape) != (B, H, dh, dh)):
        raise ValueError(
            f"rwkv6_scan kernel: unsupported shapes r {tuple(r.shape)}, u "
            f"{tuple(u.shape)}, s0 {None if s0 is None else tuple(s0.shape)}"
            f" (dh must be one of {HEAD_DIMS})")
    if not all(t.is_contiguous() for t in seq):
        raise ValueError("rwkv6_scan kernel: r/k/v/w must be contiguous")
    u = u.float().contiguous()
    s0 = None if s0 is None else s0.float().contiguous()
    y = torch.empty_like(r)
    s_out = (torch.empty((B, H, dh, dh), dtype=torch.float32,
                         device=r.device) if return_state else None)
    if B * H:
        fn = _build.load("rwkv6_scan")
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if s0 is None else s0.data_ptr(),
                 y.data_ptr(), None if s_out is None else s_out.data_ptr(),
                 B, S, H, dh, DTYPES[r.dtype],
                 torch.cuda.current_stream(r.device).cuda_stream)
        if err:
            raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA "
                               f"error {err}")
        rwkv6_scan.launches += 1
    return (y, s_out) if return_state else y


rwkv6_scan.launches = 0
