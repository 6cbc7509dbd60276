"""K4: RWKV6 wkv recurrence — wrapper of ``csrc/rwkv6_scan.cu``.

The CUDA counterpart of the JAX package's Pallas kernel
``repro/kernels/rwkv6_scan.py::rwkv6_scan``, computing the function of
``repro/kernels/ref.py::rwkv6_scan`` with its ``s0`` / ``return_state``
contract (the Pallas kernel takes no state and gives none back) for any
``S >= 1``.  Its plain version is ``kernels/ref.py::rwkv6_scan_chunked``;
``kernels/ops.py`` picks between them by the tensors' device.  This wrapper
takes CUDA tensors only and never falls back.

Its backward is K4-bwd (wrapper ``rwkv6_scan_bwd``; plain version
``ref.rwkv6_scan_bwd``), two routes picked by dtype and reported as
``rwkv6_scan_bwd.last_kernel``: bf16 takes ``csrc/rwkv6_scan_bwd_chunk.cu``
(``rwkv6_scan_bwd_chunk_kernel``: chunk-parallel, the chunk states by
tensor-core products, each chunk stepped on its own), fp32
``csrc/rwkv6_scan_bwd.cu`` (``rwkv6_scan_bwd_kernel``: sequential on the
CUDA cores).  ``Rwkv6ScanFn`` joins K4 and K4-bwd as one differentiable
function, which ``ops.rwkv6_scan`` takes under grad.

The C entry point picks one of three device kernels and reports it, read
back as ``rwkv6_scan.last_kernel``: ``rwkv6_scan_mma_kernel`` (bf16,
S > 1: chunk-parallel on the tensor cores), ``rwkv6_scan_decode_kernel``
(S = 1, either dtype) and ``rwkv6_scan_kernel`` (fp32, S > 1), all at
dh = 64; at any other dh up to ``MAX_DIM`` (the reduced configs' 16)
``rwkv6_scan_small_kernel``, the small-width route for any S and either
dtype (one block a (b, h) stepping t with the state in shared memory).
K4-bwd's small-width route is its sequential kernel with dh padded to 64
by zeros.  ``routes`` counts the launches of each route; a wider head
raises.  The decode
step calls this wrapper once a layer, so it keeps its host work short: one
pass of checks, no copies of tensors that are already fp32 and
contiguous, and the stream read as a raw handle.

``rwkv6_scan_split`` is the split-key route (``rwkv6_scan_split_kernel``,
entry point ``rwkv6_scan_split_launch`` of the same source; plain version
``ref.rwkv6_scan_split``): one decode step of a rank that holds dk of the
dv key channels of every head, giving the new rows of the state and the
rank's fp32 part of the readout, which the serving rank program sums over
"model" (``models/rwkv.py``).  It counts its own launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64,)          # the fast routes' width
MAX_DIM = 64               # the small-width route takes any other dh up to it
# by the id the C entry point writes to its ``kernel`` out-parameter
KERNELS = ("rwkv6_scan_kernel", "rwkv6_scan_mma_kernel",
           "rwkv6_scan_decode_kernel", "rwkv6_scan_small_kernel")
ROUTES = ("fp32", "mma", "decode", "small")
_route = ctypes.c_int(-1)
_ROUTE_ADDR = ctypes.addressof(_route)
# K4-bwd, by the id its C entry points write: the fp32 route (one kernel
# and its du reduction; CHUNK_BWD steps a checkpoint) and the bf16 route
# (chunks of CHUNK steps: the chunk kernel, the state walk before it and
# the du sum after it)
BWD_KERNELS = ("rwkv6_scan_bwd_kernel", "rwkv6_scan_bwd_chunk_kernel",
               "rwkv6_scan_bwd_kernel")
BWD_ROUTES = ("fp32", "chunk", "small")
CHUNK_BWD = 8
CHUNK = 64
_bwd_route = ctypes.c_int(-1)
_BWD_ROUTE_ADDR = ctypes.addressof(_bwd_route)


def _check(r, k, v, w, u, s0, name: str) -> tuple[int, int, int, int]:
    """Device, dtype, shape and layout checks shared by K4 and K4-bwd;
    returns (B, S, H, dh)."""
    dev = r.device
    if dev.type != "cuda" or k.device != dev or v.device != dev \
            or w.device != dev or u.device != dev \
            or (s0 is not None and s0.device != dev):
        raise ValueError(f"{name} kernel: every tensor must lie on the "
                         "same CUDA device")
    dtype = r.dtype
    if dtype not in DTYPES or k.dtype != dtype or v.dtype != dtype \
            or w.dtype != dtype:
        raise TypeError(f"{name} kernel: r/k/v/w must share a dtype in "
                        f"{list(DTYPES)}, got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}, {w.dtype}")
    shape = r.shape
    if len(shape) != 4 or k.shape != shape or v.shape != shape \
            or w.shape != shape:
        raise ValueError(f"{name} kernel: r/k/v/w must be (B,S,H,dh) of "
                         f"one shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, dh = shape
    if not 1 <= dh <= MAX_DIM:
        raise ValueError(f"{name} kernel: head width dh={dh} is above the "
                         f"widest this kernel takes, {MAX_DIM}")
    if u.shape != (H, dh) or (
            s0 is not None and s0.shape != (B, H, dh, dh)):
        raise ValueError(
            f"{name} kernel: unsupported shapes r {tuple(r.shape)}, u "
            f"{tuple(u.shape)}, s0 {None if s0 is None else tuple(s0.shape)}"
            )
    if not (r.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and w.is_contiguous()):
        raise ValueError(f"{name} kernel: r/k/v/w must be contiguous")
    return B, S, H, dh


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *,
               s0: torch.Tensor | None = None, return_state: bool = False):
    """r/k/v/w: (B,S,H,dh) of one dtype, contiguous; u: (H,dh); s0:
    (B,H,dh,dh) or None -> y (B,S,H,dh) in r.dtype [, final state (B,H,dh,dh)
    fp32].  ``u`` and ``s0`` are read as fp32 (cast here if they are not)."""
    B, S, H, dh = _check(r, k, v, w, u, s0, "rwkv6_scan")
    dev = r.device
    u, s0 = _build.fp32(u), _build.fp32(s0)
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr())
    if dh in HEAD_DIMS and any(p % 16 for p in ptrs):
        raise ValueError("rwkv6_scan kernel: r/k/v/w must be 16-byte "
                         "aligned (rows are copied 16 bytes at a time)")
    y = torch.empty_like(r)
    s_out = (torch.empty((B, H, dh, dh), dtype=torch.float32, device=dev)
             if return_state else None)
    if B * H:
        fn = _build.load("rwkv6_scan")
        err = fn(*ptrs, u.data_ptr(), None if s0 is None else s0.data_ptr(),
                 y.data_ptr(), None if s_out is None else s_out.data_ptr(),
                 B, S, H, dh, DTYPES[r.dtype], _ROUTE_ADDR,
                 _build.raw_stream(dev))
        if err:
            raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA "
                               f"error {err}")
        _build.count(rwkv6_scan, ROUTES[_route.value])
        cost.launched("rwkv6_scan", cost.rwkv6_scan, B, S, H, dh,
                      r.element_size(), state_in=s0 is not None,
                      state_out=return_state)
        rwkv6_scan.last_kernel = KERNELS[_route.value]
    return (y, s_out) if return_state else y


rwkv6_scan.launches = 0
rwkv6_scan.routes = {}
rwkv6_scan.last_kernel = None


def rwkv6_scan_split(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: torch.Tensor | None = None):
    """One decode step on a slice of the key channels: r, k, w (B, 1, H,
    dk) and v (B, 1, H, dv) of one dtype, contiguous, dk dividing dv; u
    (H, dk); s0 (B, H, dk, dv) or None (zeros) -> (y_part (B, 1, H, dv)
    fp32, the slice's part of the readout; the new state rows (B, H, dk,
    dv) fp32).  ``u`` and ``s0`` are read as fp32."""
    dev, dtype = r.device, r.dtype
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, w, u)) \
            or (s0 is not None and s0.device != dev):
        raise ValueError("rwkv6_scan_split kernel: every tensor must lie on "
                         "the same CUDA device")
    if dtype not in DTYPES or any(t.dtype != dtype for t in (k, v, w)):
        raise TypeError(f"rwkv6_scan_split kernel: r/k/v/w must share a "
                        f"dtype in {list(DTYPES)}")
    if r.dim() != 4 or r.shape[1] != 1:
        raise ValueError(f"rwkv6_scan_split kernel: r must be (B, 1, H, dk),"
                         f" got {tuple(r.shape)}")
    B, _, H, dk = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape \
            or tuple(v.shape) != (B, 1, H, dv) or dv % dk \
            or tuple(u.shape) != (H, dk) or (
                s0 is not None and tuple(s0.shape) != (B, H, dk, dv)):
        raise ValueError(
            f"rwkv6_scan_split kernel: unsupported shapes r/k/w "
            f"{[tuple(t.shape) for t in (r, k, w)]}, v {tuple(v.shape)}, u "
            f"{tuple(u.shape)}, s0 "
            f"{None if s0 is None else tuple(s0.shape)} (dk must divide dv)")
    if not all(t.is_contiguous() for t in (r, k, v, w)):
        raise ValueError("rwkv6_scan_split kernel: r/k/v/w must be "
                         "contiguous")
    u, s0 = _build.fp32(u), _build.fp32(s0)
    y = torch.empty((B, 1, H, dv), dtype=torch.float32, device=dev)
    s_out = torch.empty((B, H, dk, dv), dtype=torch.float32, device=dev)
    if B * H:
        fn = _build.load("rwkv6_scan_split")
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if s0 is None else s0.data_ptr(),
                 y.data_ptr(), s_out.data_ptr(), B, H, dk, dv, DTYPES[dtype],
                 _build.raw_stream(dev))
        if err:
            raise RuntimeError(f"rwkv6_scan_split kernel launch failed: "
                               f"CUDA error {err}")
        _build.count(rwkv6_scan_split, "split")
        cost.launched("rwkv6_scan_split", cost.rwkv6_scan_split, B, H, dk,
                      dv, r.element_size(), state_in=s0 is not None)
    return y, s_out


rwkv6_scan_split.launches = 0
rwkv6_scan_split.routes = {}


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor, *,
                   s0: torch.Tensor | None = None,
                   ds_out: torch.Tensor | None = None,
                   need_ds0: bool = True):
    """K4-bwd: the gradient of ``rwkv6_scan`` at (r, k, v, w, u, s0) for
    the output gradient ``dy`` (r's shape and dtype) and ``ds_out``, the
    final state's (B,H,dh,dh) or None (zero) -> (dr, dk, dv, dw) in r.dtype,
    du (H,dh) fp32 and ds0 (B,H,dh,dh) fp32 (None unless ``need_ds0``).
    Any S >= 1; one count a call (two device kernels in fp32, three in
    bf16)."""
    B, S, H, dh = _check(r, k, v, w, u, s0, "rwkv6_scan_bwd")
    dev = r.device
    if dy.shape != r.shape or dy.dtype != r.dtype or dy.device != dev \
            or (ds_out is not None and (ds_out.shape != (B, H, dh, dh)
                                        or ds_out.device != dev)):
        raise ValueError("rwkv6_scan_bwd kernel: dy must have r's shape, "
                         "dtype and device, ds_out the state's shape")
    dy = dy.contiguous()
    chunked = r.dtype == torch.bfloat16 and dh in HEAD_DIMS
    if chunked:                        # rows are read 16 bytes at a time
        if any(t.data_ptr() % 16 for t in (r, k, v, w)):
            raise ValueError("rwkv6_scan_bwd kernel: bf16 r/k/v/w must be "
                             "16-byte aligned")
        if dy.data_ptr() % 16:
            dy = dy.clone()
    u, s0, ds_out = (_build.fp32(t) for t in (u, s0, ds_out))
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du = torch.zeros((H, dh), dtype=torch.float32, device=dev)
    ds0 = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
           if need_ds0 else None)
    if B * H == 0 or S == 0:
        return (dr.zero_(), dk.zero_(), dv.zero_(), dw.zero_(), du, ds0)
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            dy.data_ptr(), None if ds_out is None else ds_out.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), None if ds0 is None else ds0.data_ptr())
    if chunked:
        # scratch: each chunk's S_in and G_out, then its du partial
        n_chunks = -(-S // CHUNK)
        scratch = torch.empty(B * H * n_chunks * dh * (2 * dh + 1),
                              dtype=torch.float32, device=dev)
        fn = _build.load("rwkv6_scan_bwd_chunk")
        err = fn(*ptrs, scratch.data_ptr(), B, S, H, dh, _BWD_ROUTE_ADDR,
                 _build.raw_stream(dev))
    else:
        # scratch, laid out 64 wide whatever dh: the batch's du partials,
        # then S at every 8th step
        n_chunks = -(-S // CHUNK_BWD)
        w = MAX_DIM
        scratch = torch.empty(B * H * w * (1 + n_chunks * w),
                              dtype=torch.float32, device=dev)
        fn = _build.load("rwkv6_scan_bwd")
        err = fn(*ptrs, scratch.data_ptr(), scratch[B * H * w:].data_ptr(),
                 B, S, H, dh, DTYPES[r.dtype], _BWD_ROUTE_ADDR,
                 _build.raw_stream(dev))
    if err:
        raise RuntimeError(f"rwkv6_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _build.count(rwkv6_scan_bwd, BWD_ROUTES[_bwd_route.value])
    cost.launched("rwkv6_scan_bwd", cost.rwkv6_scan_bwd, B, S, H, dh,
                  r.element_size())
    rwkv6_scan_bwd.last_kernel = BWD_KERNELS[_bwd_route.value]
    return dr, dk, dv, dw, du, ds0


rwkv6_scan_bwd.launches = 0
rwkv6_scan_bwd.routes = {}
rwkv6_scan_bwd.last_kernel = None


class Rwkv6ScanFn(torch.autograd.Function):
    """K4 forward and K4-bwd as one differentiable function of (r, k, v, w,
    u, s0); with ``return_state`` the final state is an output too, and a
    missing gradient of it counts as zero.  Gradients come back in the
    inputs' dtypes."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, return_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return rwkv6_scan(r, k, v, w, u, s0=s0, return_state=return_state)

    @staticmethod
    def backward(ctx, dy, ds_out=None):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        need_ds0 = s0 is not None and ctx.needs_input_grad[5]
        dr, dk, dv, dw, du, ds0 = rwkv6_scan_bwd(
            r, k, v, w, u, dy.to(r.dtype), s0=s0, ds_out=ds_out,
            need_ds0=need_ds0)
        return (dr, dk, dv, dw, du.to(u.dtype),
                ds0.to(s0.dtype) if need_ds0 else None, None)
