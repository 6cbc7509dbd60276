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
``mamba2_scan.last_kernel``: at dh = ds = 64 ``mamba2_scan_mma_kernel``
(bf16, the chunk products on the tensor cores) or ``mamba2_scan_kernel``
(fp32); at any other dh, ds up to ``MAX_DIM`` (the reduced configs' 8) the
small-width route ``mamba2_scan_small_kernel`` (either dtype: one block a
(b, h) stepping t with the state in shared memory).  ``routes`` counts the
launches of each route; a wider head or state raises.

Its backward is K3-bwd (wrapper ``mamba2_scan_bwd``; plain version
``ref.mamba2_scan_bwd``), two routes picked by dtype and reported as
``mamba2_scan_bwd.last_kernel``: bf16 takes
``csrc/mamba2_scan_bwd_chunk.cu`` (``mamba2_scan_bwd_chunk_kernel``:
chunk-parallel, the chunk products on the tensor cores; x, B and C by
their strides, 16-byte aligned as for the bf16 forward), fp32
``csrc/mamba2_scan_bwd.cu`` (``mamba2_scan_bwd_kernel``: sequential on the
CUDA cores, no alignment needed).  Both give the gradients of x, B and C
as contiguous tensors.  Any other dh, ds up to ``MAX_DIM`` takes the
small-width route in either dtype: the sequential kernel with its widths
padded to 64 by zeros (``csrc/mamba2_scan_bwd.cu``).  ``Mamba2ScanFn`` joins K3 and K3-bwd as one
differentiable function, which ``ops.mamba2_scan`` takes under grad.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64,)          # the fast routes' widths (dh = ds = 64)
STATE_DIMS = (64,)
MAX_DIM = 64               # the small-width route takes dh, ds up to it
# by the id the C entry point writes to its ``kernel`` out-parameter
KERNELS = ("mamba2_scan_kernel", "mamba2_scan_mma_kernel",
           "mamba2_scan_small_kernel")
ROUTES = ("fp32", "mma", "small")
_route = ctypes.c_int(-1)
_ROUTE_ADDR = ctypes.addressof(_route)
# K3-bwd, by the id its C entry points write: the fp32 route (one kernel
# and its sum over heads; CHUNK_BWD steps a checkpoint) and the bf16 route
# (chunks of CHUNK steps: the chunk kernel, the state walk before it and
# the sum after it)
BWD_KERNELS = ("mamba2_scan_bwd_kernel", "mamba2_scan_bwd_chunk_kernel",
               "mamba2_scan_bwd_kernel")
BWD_ROUTES = ("fp32", "chunk", "small")
CHUNK_BWD = 8
CHUNK = 64
_bwd_route = ctypes.c_int(-1)
_BWD_ROUTE_ADDR = ctypes.addressof(_bwd_route)


def _check(x, dt, A, Bmat, Cmat, D, h0, name: str):
    """Device, dtype, shape and layout checks shared by K3 and K3-bwd;
    returns (B, S, H, dh, ds, the batch and step strides of x, B, C)."""
    ts = (x, dt, A, Bmat, Cmat, D) + ((h0,) if h0 is not None else ())
    if any(t.device.type != "cuda" or t.device != x.device for t in ts):
        raise ValueError(f"{name} kernel: every tensor must lie on the "
                         "same CUDA device")
    if x.dtype not in DTYPES or Bmat.dtype != x.dtype \
            or Cmat.dtype != x.dtype:
        raise TypeError(f"{name} kernel: x/Bmat/Cmat must share a dtype "
                        f"in {list(DTYPES)}, got {x.dtype}, {Bmat.dtype}, "
                        f"{Cmat.dtype}")
    if x.dim() != 4 or Bmat.dim() != 3:
        raise ValueError(f"{name} kernel: expected x (B,S,H,dh), "
                         "Bmat/Cmat (B,S,ds)")
    B, S, H, dh = x.shape
    ds = Bmat.shape[-1]
    if not (1 <= dh <= MAX_DIM and 1 <= ds <= MAX_DIM):
        raise ValueError(f"{name} kernel: head width dh={dh} or state "
                         f"width ds={ds} is above the widest this kernel "
                         f"takes, {MAX_DIM}")
    if tuple(Bmat.shape) != (B, S, ds) \
            or tuple(Cmat.shape) != (B, S, ds) \
            or tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or tuple(D.shape) != (H,) \
            or (h0 is not None and tuple(h0.shape) != (B, H, ds, dh)):
        raise ValueError(
            f"{name} kernel: unsupported shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, Bmat {tuple(Bmat.shape)}, Cmat "
            f"{tuple(Cmat.shape)}, A {tuple(A.shape)}, D {tuple(D.shape)}")
    if x.stride(3) != 1 or x.stride(2) != dh or Bmat.stride(2) != 1 \
            or Cmat.stride(2) != 1:
        raise ValueError(f"{name} kernel: x must be dense over (H, dh) "
                         "and Bmat/Cmat over ds (batch and step strides are "
                         "free)")
    return B, S, H, dh, ds, (x.stride(0), x.stride(1), Bmat.stride(0),
                             Bmat.stride(1), Cmat.stride(0), Cmat.stride(1))


def _fast(dh: int, ds: int) -> bool:
    """Whether (dh, ds) takes a fast route (else the small-width one)."""
    return dh in HEAD_DIMS and ds in STATE_DIMS


def _check_aligned(x, Bmat, Cmat, strides, name: str) -> None:
    """bf16 x, Bmat and Cmat are copied 16 bytes a row at a time."""
    if any(t.data_ptr() % 16 for t in (x, Bmat, Cmat)) \
            or any(s % 8 for s in strides):
        raise ValueError(f"{name} kernel: bf16 x/Bmat/Cmat must start "
                         "16-byte aligned with batch and step strides of a "
                         "multiple of 8 elements (rows are copied 16 bytes "
                         f"at a time); got strides {strides}")


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor, *,
                h0: torch.Tensor | None = None, return_state: bool = False):
    """x: (B,S,H,dh); dt: (B,S,H); A, D: (H,); Bmat, Cmat: (B,S,ds); h0:
    (B,H,ds,dh) or None -> y (B,S,H,dh) contiguous in x.dtype [, final state
    (B,H,ds,dh) fp32]."""
    B, S, H, dh, ds, strides = _check(x, dt, A, Bmat, Cmat, D, h0,
                                      "mamba2_scan")
    if x.dtype == torch.bfloat16 and _fast(dh, ds):
        _check_aligned(x, Bmat, Cmat, strides, "mamba2_scan")
    dt, A, D, h0 = (_build.fp32(t) for t in (dt, A, D, h0))
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
        _build.count(mamba2_scan, ROUTES[_route.value])
        cost.launched("mamba2_scan", cost.mamba2_scan, B, S, H, dh, ds,
                      x.element_size(), state_in=h0 is not None,
                      state_out=return_state)
        mamba2_scan.last_kernel = KERNELS[_route.value]
    return (y, h_out) if return_state else y


mamba2_scan.launches = 0
mamba2_scan.routes = {}
mamba2_scan.last_kernel = None


def mamba2_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor,
                    dy: torch.Tensor, *, h0: torch.Tensor | None = None,
                    dh_out: torch.Tensor | None = None,
                    need_dh0: bool = True):
    """K3-bwd: the gradient of ``mamba2_scan`` at (x, dt, A, Bmat, Cmat, D,
    h0) for the output gradient ``dy`` (x's shape and dtype) and
    ``dh_out``, the final state's (B,H,ds,dh) or None (zero) -> (dx, ddt,
    dA, dB, dC, dD, dh0): dx, dB, dC contiguous in x.dtype; ddt, dA, dD
    and dh0 fp32 (dh0 None unless ``need_dh0``).  x, Bmat and Cmat are
    read by their strides (in bf16 16-byte aligned).  Any S >= 1; one count
    a call (two device kernels in fp32, three in bf16)."""
    B, S, H, dh, ds, strides = _check(x, dt, A, Bmat, Cmat, D, h0,
                                      "mamba2_scan_bwd")
    dev = x.device
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != dev \
            or (dh_out is not None and (dh_out.shape != (B, H, ds, dh)
                                        or dh_out.device != dev)):
        raise ValueError("mamba2_scan_bwd kernel: dy must have x's shape, "
                         "dtype and device, dh_out the state's shape")
    dy = dy.contiguous()
    chunked = x.dtype == torch.bfloat16 and _fast(dh, ds)
    if chunked:
        _check_aligned(x, Bmat, Cmat, strides, "mamba2_scan_bwd")
        if dy.data_ptr() % 16:         # its rows too go 16 bytes at a time
            dy = dy.clone()
    dt, A, D, h0, dh_out = (_build.fp32(t)
                            for t in (dt, A, D, h0, dh_out))
    dx = torch.empty((B, S, H, dh), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    dB, dC = (torch.empty((B, S, ds), dtype=x.dtype, device=dev)
              for _ in range(2))
    dA, dD = (torch.zeros(H, dtype=torch.float32, device=dev)
              for _ in range(2))
    dh0 = (torch.zeros((B, H, ds, dh), dtype=torch.float32, device=dev)
           if need_dh0 else None)
    if B * H == 0 or S == 0:
        return (dx.zero_(), ddt.zero_(), dA, dB.zero_(), dC.zero_(), dD,
                dh0)
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(), D.data_ptr(),
            None if h0 is None else h0.data_ptr(), dy.data_ptr(),
            None if dh_out is None else dh_out.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
            dD.data_ptr(), None if dh0 is None else dh0.data_ptr())
    if chunked:
        # scratch: each head's parts of dB and dC; each chunk's h_in and
        # G_out; each (b, h, chunk)'s dA and dD partials
        n_chunks = -(-S // CHUNK)
        scratch = torch.empty(2 * B * S * H * ds
                              + 2 * B * H * n_chunks * ds * dh
                              + 2 * B * H * n_chunks,
                              dtype=torch.float32, device=dev)
        fn = _build.load("mamba2_scan_bwd_chunk")
        err = fn(*ptrs, scratch.data_ptr(), B, S, H, dh, ds, *strides,
                 _BWD_ROUTE_ADDR, _build.raw_stream(dev))
    else:
        # scratch, laid out 64 wide whatever dh and ds: each head's parts
        # of dB and dC, the batch's dA and dD partials, the state at every
        # CHUNK_BWD-th step
        n_chunks = -(-S // CHUNK_BWD)
        w = MAX_DIM
        scratch = torch.empty(2 * B * S * H * w + 2 * B * H
                              + B * H * n_chunks * w * w,
                              dtype=torch.float32, device=dev)
        fn = _build.load("mamba2_scan_bwd")
        err = fn(*ptrs, scratch.data_ptr(), B, S, H, dh, ds, *strides,
                 DTYPES[x.dtype], _BWD_ROUTE_ADDR, _build.raw_stream(dev))
    if err:
        raise RuntimeError(f"mamba2_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _build.count(mamba2_scan_bwd, BWD_ROUTES[_bwd_route.value])
    cost.launched("mamba2_scan_bwd", cost.mamba2_scan_bwd, B, S, H, dh, ds,
                  x.element_size())
    mamba2_scan_bwd.last_kernel = BWD_KERNELS[_bwd_route.value]
    return dx, ddt, dA, dB, dC, dD, dh0


mamba2_scan_bwd.launches = 0
mamba2_scan_bwd.routes = {}
mamba2_scan_bwd.last_kernel = None


class Mamba2ScanFn(torch.autograd.Function):
    """K3 forward and K3-bwd as one differentiable function of (x, dt, A,
    Bmat, Cmat, D, h0); with ``return_state`` the final state is an output
    too, and a missing gradient of it counts as zero.  The gradients of the
    strided views x, Bmat and Cmat come back contiguous; every gradient in
    its input's dtype."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, D, h0, return_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, D, h0)
        return mamba2_scan(x, dt, A, Bmat, Cmat, D, h0=h0,
                           return_state=return_state)

    @staticmethod
    def backward(ctx, dy, dh_out=None):
        x, dt, A, Bmat, Cmat, D, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        need_dh0 = h0 is not None and ctx.needs_input_grad[6]
        dx, ddt, dA, dB, dC, dD, dh0 = mamba2_scan_bwd(
            x, dt, A, Bmat, Cmat, D, dy.to(x.dtype), h0=h0, dh_out=dh_out,
            need_dh0=need_dh0)
        return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC,
                dD.to(D.dtype), dh0.to(h0.dtype) if need_dh0 else None,
                None)
