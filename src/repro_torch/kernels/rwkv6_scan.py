"""K4: RWKV6 wkv recurrence — wrapper of ``csrc/rwkv6_scan.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
``repro/kernels/rwkv6_scan.py::rwkv6_scan``, computing the function of
``repro/kernels/ref.py::rwkv6_scan`` with its ``s0`` / ``return_state``
contract (the Pallas kernel takes no state and gives none back) for any
``S >= 1``.  Its plain version is ``kernels/ref.py::rwkv6_scan_chunked``;
``kernels/ops.py`` picks between them by the tensors' device.  This wrapper
takes CUDA tensors only and never falls back.

The C entry point picks one of three device kernels and reports it, read
back as ``rwkv6_scan.last_kernel``: ``rwkv6_scan_mma_kernel`` (bf16,
S > 1: chunk-parallel on the tensor cores), ``rwkv6_scan_decode_kernel``
(S = 1, either dtype) and ``rwkv6_scan_kernel`` (fp32, S > 1).  The decode
step calls this wrapper once a layer, so it keeps its host work short: one
pass of checks, no copies of tensors that are already fp32 and
contiguous, and the stream read as a raw handle.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64,)
# by the id the C entry point writes to its ``kernel`` out-parameter
KERNELS = ("rwkv6_scan_kernel", "rwkv6_scan_mma_kernel",
           "rwkv6_scan_decode_kernel")
_route = ctypes.c_int(-1)
_ROUTE_ADDR = ctypes.addressof(_route)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *,
               s0: torch.Tensor | None = None, return_state: bool = False):
    """r/k/v/w: (B,S,H,dh) of one dtype, contiguous; u: (H,dh); s0:
    (B,H,dh,dh) or None -> y (B,S,H,dh) in r.dtype [, final state (B,H,dh,dh)
    fp32].  ``u`` and ``s0`` are read as fp32 (cast here if they are not)."""
    _build.refuse_grad("rwkv6_scan", f"see {_build.NO_BACKWARD}", r, k, v,
                       w, u, s0)
    dev = r.device
    if dev.type != "cuda" or k.device != dev or v.device != dev \
            or w.device != dev or u.device != dev \
            or (s0 is not None and s0.device != dev):
        raise ValueError("rwkv6_scan kernel: every tensor must lie on the "
                         "same CUDA device")
    dtype = r.dtype
    if dtype not in DTYPES or k.dtype != dtype or v.dtype != dtype \
            or w.dtype != dtype:
        raise TypeError(f"rwkv6_scan kernel: r/k/v/w must share a dtype in "
                        f"{list(DTYPES)}, got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}, {w.dtype}")
    shape = r.shape
    if len(shape) != 4 or k.shape != shape or v.shape != shape \
            or w.shape != shape:
        raise ValueError(f"rwkv6_scan kernel: r/k/v/w must be (B,S,H,dh) of "
                         f"one shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, dh = shape
    if dh not in HEAD_DIMS or u.shape != (H, dh) or (
            s0 is not None and s0.shape != (B, H, dh, dh)):
        raise ValueError(
            f"rwkv6_scan kernel: unsupported shapes r {tuple(r.shape)}, u "
            f"{tuple(u.shape)}, s0 {None if s0 is None else tuple(s0.shape)}"
            f" (dh must be one of {HEAD_DIMS})")
    if not (r.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and w.is_contiguous()):
        raise ValueError("rwkv6_scan kernel: r/k/v/w must be contiguous")
    if u.dtype != torch.float32 or not u.is_contiguous():
        u = u.float().contiguous()
    if s0 is not None and (s0.dtype != torch.float32
                           or not s0.is_contiguous() or s0.data_ptr() % 16):
        # fp32, contiguous and 16-byte aligned (the kernels read whole rows)
        s0 = torch.empty(s0.shape, dtype=torch.float32, device=dev).copy_(s0)
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("rwkv6_scan kernel: r/k/v/w must be 16-byte "
                         "aligned (rows are copied 16 bytes at a time)")
    y = torch.empty_like(r)
    s_out = (torch.empty((B, H, dh, dh), dtype=torch.float32, device=dev)
             if return_state else None)
    if B * H:
        fn = _build.load("rwkv6_scan")
        err = fn(*ptrs, u.data_ptr(), None if s0 is None else s0.data_ptr(),
                 y.data_ptr(), None if s_out is None else s_out.data_ptr(),
                 B, S, H, dh, DTYPES[dtype], _ROUTE_ADDR,
                 _build.raw_stream(dev))
        if err:
            raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA "
                               f"error {err}")
        rwkv6_scan.launches += 1
        rwkv6_scan.last_kernel = KERNELS[_route.value]
    return (y, s_out) if return_state else y


rwkv6_scan.launches = 0
rwkv6_scan.last_kernel = None
