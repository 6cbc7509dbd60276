"""K3: Mamba2 SSD selective scan — wrapper of ``csrc/mamba2_scan.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
``repro/kernels/mamba2_scan.py::mamba2_scan`` (n_groups = 1), computing the
function of ``repro/kernels/ref.py::mamba2_scan_chunked`` with its ``h0`` /
``return_state`` contract (the Pallas kernel takes no state and gives none
back) for any ``S >= 1``.  Its plain version is
``kernels/ref.py::mamba2_scan_chunked``; ``kernels/ops.py`` picks between
them by the tensors' device.  This wrapper takes CUDA tensors only and
never falls back.

``x``, ``Bmat`` and ``Cmat`` come out of a split of the mixer's projection
and are not contiguous: the wrapper passes their batch and step strides to
the kernel instead of copying them (their inner axes must be dense; in
bf16, base pointers and strides must be 16-byte aligned, since rows are
copied 16 bytes at a time).  ``dt``, ``A``, ``D`` and ``h0`` are read as
contiguous fp32 (cast or copied here if they are not; they are small).

The C entry point reports the device kernel it launched, read back as
``mamba2_scan.last_kernel``: ``mamba2_scan_mma_kernel`` (bf16, the chunk
products on the tensor cores) or ``mamba2_scan_kernel`` (fp32).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64,)
STATE_DIMS = (64,)
# by the id the C entry point writes to its ``kernel`` out-parameter
KERNELS = ("mamba2_scan_kernel", "mamba2_scan_mma_kernel")
_route = ctypes.c_int(-1)
_ROUTE_ADDR = ctypes.addressof(_route)


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor, *,
                h0: torch.Tensor | None = None, return_state: bool = False):
    """x: (B,S,H,dh); dt: (B,S,H); A, D: (H,); Bmat, Cmat: (B,S,ds); h0:
    (B,H,ds,dh) or None -> y (B,S,H,dh) contiguous in x.dtype [, final state
    (B,H,ds,dh) fp32]."""
    ts = (x, dt, A, Bmat, Cmat, D) + ((h0,) if h0 is not None else ())
    _build.refuse_grad("mamba2_scan", f"see {_build.NO_BACKWARD}", *ts)
    if any(t.device.type != "cuda" or t.device != x.device for t in ts):
        raise ValueError("mamba2_scan kernel: every tensor must lie on the "
                         "same CUDA device")
    if x.dtype not in DTYPES or Bmat.dtype != x.dtype \
            or Cmat.dtype != x.dtype:
        raise TypeError(f"mamba2_scan kernel: x/Bmat/Cmat must share a dtype "
                        f"in {list(DTYPES)}, got {x.dtype}, {Bmat.dtype}, "
                        f"{Cmat.dtype}")
    if x.dim() != 4 or Bmat.dim() != 3:
        raise ValueError("mamba2_scan kernel: expected x (B,S,H,dh), "
                         "Bmat/Cmat (B,S,ds)")
    B, S, H, dh = x.shape
    ds = Bmat.shape[-1]
    if dh not in HEAD_DIMS or ds not in STATE_DIMS \
            or tuple(Bmat.shape) != (B, S, ds) \
            or tuple(Cmat.shape) != (B, S, ds) \
            or tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or tuple(D.shape) != (H,) \
            or (h0 is not None and tuple(h0.shape) != (B, H, ds, dh)):
        raise ValueError(
            f"mamba2_scan kernel: unsupported shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, Bmat {tuple(Bmat.shape)}, Cmat "
            f"{tuple(Cmat.shape)}, A {tuple(A.shape)}, D {tuple(D.shape)} "
            f"(dh must be one of {HEAD_DIMS}, ds one of {STATE_DIMS})")
    if x.stride(3) != 1 or x.stride(2) != dh or Bmat.stride(2) != 1 \
            or Cmat.stride(2) != 1:
        raise ValueError("mamba2_scan kernel: x must be dense over (H, dh) "
                         "and Bmat/Cmat over ds (batch and step strides are "
                         "free)")
    strides = (x.stride(0), x.stride(1), Bmat.stride(0), Bmat.stride(1),
               Cmat.stride(0), Cmat.stride(1))
    if x.dtype == torch.bfloat16 and (
            any(t.data_ptr() % 16 for t in (x, Bmat, Cmat))
            or any(s % 8 for s in strides)):
        raise ValueError("mamba2_scan kernel: bf16 x/Bmat/Cmat must start "
                         "16-byte aligned with batch and step strides of a "
                         "multiple of 8 elements (rows are copied 16 bytes "
                         f"at a time); got strides {strides}")
    dt, A, D = (t.float().contiguous() for t in (dt, A, D))
    if h0 is not None and (h0.dtype != torch.float32
                           or not h0.is_contiguous() or h0.data_ptr() % 16):
        # fp32, contiguous and 16-byte aligned (the kernels read whole rows)
        h0 = torch.empty(h0.shape, dtype=torch.float32,
                         device=x.device).copy_(h0)
    y = torch.empty((B, S, H, dh), dtype=x.dtype, device=x.device)
    h_out = (torch.empty((B, H, ds, dh), dtype=torch.float32,
                         device=x.device) if return_state else None)
    if B * H:
        fn = _build.load("mamba2_scan")
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                 Cmat.data_ptr(), D.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 None if h_out is None else h_out.data_ptr(),
                 B, S, H, dh, ds, *strides, DTYPES[x.dtype], _ROUTE_ADDR,
                 _build.raw_stream(x.device))
        if err:
            raise RuntimeError(f"mamba2_scan kernel launch failed: CUDA "
                               f"error {err}")
        mamba2_scan.launches += 1
        mamba2_scan.last_kernel = KERNELS[_route.value]
    return (y, h_out) if return_state else y


mamba2_scan.launches = 0
mamba2_scan.last_kernel = None
