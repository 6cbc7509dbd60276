"""The optimizer update as one kernel pair — wrapper of ``csrc/adamw.cu``.

No TPU kernel stands behind it: the JAX package leaves AdamW to XLA.  On
the card the eager update (``optim/adamw.py::adamw_update``, about twenty
fp32 operators a leaf over layer-stacked copies) moved some 150 bytes a
parameter where 24 do; this kernel pair moves the 24, in place on the
model's own parameters and on the optimizer's moments.  Its plain version
is ``optim/adamw.py::adamw_update_plain_``; its entry point,
``optim/adamw.py::adamw_update_``, and this wrapper take CUDA tensors
only and never fall back (the trainer chooses by its device).

Every step packs one table of records, one a parameter tensor: its
pointer, its gradient's (0 where it has none: a zero gradient), the
pointers of its slices of the leaf's stacked moments, its elements, dtype,
decay and alignment.  The gradients' pointers change every step (the
trainer drops them before each backward), so the table is packed anew on
the host and reaches the card through a pinned buffer by an asynchronous
copy; PyTorch's pinned-memory cache keeps the buffer from reuse until that
copy has run.  Nothing waits for the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.fabric.telemetry import process_hub
from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 16384          # elements a block takes at a time (``kChunk``)
MAX_BLOCKS = 2048      # the norm pass's partials: above any card's grid
DECAY, ALIGNED = 1, 2  # a record's flags
# one record, as ``struct Rec`` in the source lays it out (56 bytes)
RECORD = np.dtype([("p", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"),
                   ("n", "<i8"), ("chunk0", "<i8"), ("dtype", "<i4"),
                   ("flags", "<i4")])


def _records(params: dict, m: dict, v: dict, device, decays: bool):
    """(the packed table, its chunks, its elements); raises on a tensor the
    kernel cannot take."""
    rows = []
    for k, ps in params.items():
        mk, vk = m.get(k), v.get(k)
        for name, t in (("m", mk), ("v", vk)):
            if t is None or t.dtype != torch.float32 \
                    or t.device != device or not t.is_contiguous():
                raise ValueError(
                    f"adamw kernel: {name}[{k!r}] must be a contiguous fp32 "
                    f"tensor on {device}")
        if mk.numel() != sum(p.numel() for p in ps) or vk.shape != mk.shape:
            raise ValueError(
                f"adamw kernel: the moments of {k!r} ({tuple(mk.shape)}, "
                f"{tuple(vk.shape)}) do not hold its {len(ps)} tensors")
        # the decay rule reads the leaf's rank (the stacked moment's)
        flags = DECAY if decays and mk.dim() >= 2 else 0
        off = 0
        for p in ps:
            g = p.grad
            if p.device != device or (g is not None and g.device != device):
                raise ValueError(f"adamw kernel: {k!r} and its gradient must "
                                 f"lie on {device}")
            if p.dtype not in DTYPES or (g is not None and g.dtype != p.dtype):
                raise TypeError(f"adamw kernel: {k!r} is {p.dtype} with a "
                                f"{None if g is None else g.dtype} gradient; "
                                f"it takes {list(DTYPES)}, the gradient of "
                                "the same dtype")
            if not p.is_contiguous() or (g is not None and (
                    not g.is_contiguous() or g.shape != p.shape)):
                raise ValueError(f"adamw kernel: {k!r} and its gradient must "
                                 "be contiguous and of one shape")
            n = p.numel()
            ptrs = (p.data_ptr(), 0 if g is None else g.data_ptr(),
                    mk.data_ptr() + 4 * off, vk.data_ptr() + 4 * off)
            off += n
            if n:
                rows.append(ptrs + (n, DTYPES[p.dtype], flags | (
                    ALIGNED if not any(a % 16 for a in ptrs) else 0)))
    table = np.zeros(len(rows), RECORD)
    if not rows:
        return table, 0, 0
    cols = list(zip(*rows))
    for name, col in zip(("p", "g", "m", "v", "n", "dtype", "flags"), cols):
        table[name] = col
    chunks = -(-table["n"] // CHUNK)
    table["chunk0"] = np.cumsum(chunks) - chunks
    return table, int(chunks.sum()), int(table["n"].sum())


def fused_adamw(cfg, params: dict, m: dict, v: dict, lr: torch.Tensor,
                 bc1: torch.Tensor, bc2: torch.Tensor) -> torch.Tensor:
    """One AdamW step of every tensor in ``params`` ({leaf: [tensors]}, a
    layer-stacked leaf's layers in order) from its ``.grad``, in place on
    the tensors and on their slices of ``m[leaf]`` / ``v[leaf]`` (fp32,
    the leaf's shape); ``lr``, ``bc1``, ``bc2``: 0-d fp32 tensors on the
    card.  ``cfg``: the ``AdamWConfig``.  Returns the fp32 global norm of
    the gradients (0-d, on the card)."""
    device = lr.device
    if device.type != "cuda" or any(
            t.device != device or t.dtype != torch.float32 or t.dim()
            for t in (bc1, bc2)) or lr.dtype != torch.float32 or lr.dim():
        raise ValueError("adamw kernel: lr, bc1 and bc2 must be 0-d fp32 "
                         "tensors on one CUDA device")
    table, n_chunks, n_elems = _records(params, m, v, device,
                                        bool(cfg.weight_decay))
    if not n_chunks:
        return torch.zeros((), dtype=torch.float32, device=device)
    norm = torch.empty((), dtype=torch.float32, device=device)
    host = torch.from_numpy(table.view(np.uint8)).pin_memory()
    recs = host.to(device, non_blocking=True)
    partial = torch.empty(MAX_BLOCKS, dtype=torch.float64, device=device)
    blocks = (ctypes.c_int * 2)()
    c = ctypes.c_float
    err = _build.load("adamw")(
        recs.data_ptr(), len(table), n_chunks, partial.data_ptr(), MAX_BLOCKS,
        lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(), norm.data_ptr(),
        c(cfg.b1), c(1 - cfg.b1), c(cfg.b2), c(1 - cfg.b2), c(cfg.eps),
        c(cfg.weight_decay), c(cfg.clip_norm), blocks,
        _build.raw_stream(device))
    if err:
        raise RuntimeError(f"adamw kernel launch failed: CUDA error {err}")
    _build.count(fused_adamw, "fused")
    fused_adamw.last_blocks = tuple(blocks)
    process_hub().add("adamw.fused_elems", n_elems)
    return norm


fused_adamw.launches = 0
fused_adamw.routes = {}
fused_adamw.last_blocks = (0, 0)   # the two kernels' grids, last launch
