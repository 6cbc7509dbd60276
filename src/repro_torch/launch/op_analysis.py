"""Op-level roofline analysis of one rank's step: the counterpart of the
JAX package's ``launch/hlo_analysis.py``.

JAX reads its three roofline quantities from the compiled, partitioned
HLO.  The port has no HLO: it runs eagerly, one ATen op at a time, so
``OpAnalysis`` is a ``TorchDispatchMode`` that watches every op of one
rank's step, on meta tensors (the dry run) or on the card, and counts:

  * flops       — ``torch.utils.flop_counter``'s registered formulas for
                  the matmul-class ops (mm, addmm, bmm, baddbmm) and the
                  convolutions: 2 x |result| x K for each product, JAX's
                  rule for each ``dot``; plus the FLOPs each hand-written
                  kernel reports for its launch (``kernels/cost.py``: a
                  kernel is one launch that no dispatch mode sees into);
  * bytes       — operand plus result bytes of every ATen op except views,
                  aliases and allocations (an operand the op writes, in
                  place or as ``out=``, counts once, as its result), plus
                  the kernels' reported bytes.  This is the eager
                  program's traffic, with no fusion: every elementwise op
                  reads and writes memory.
                  It exceeds XLA's fusion-boundary count (hlo_analysis
                  counts a fusion only at its boundary), so no parity is
                  held between the two packages' bytes;
  * collectives — per kind (JAX's names: all-gather, reduce-scatter,
                  all-reduce, all-to-all): count, operand, result and link
                  bytes with ``COLLECTIVE_TRAFFIC``'s ring multipliers, as
                  ``parallel/spmd.py`` reports them on an abstract mesh;
  * peak live bytes — from the arguments (parameters, optimizer state,
                  batch: what the caller hands in) upward: each output
                  storage's bytes added when an op makes it and subtracted
                  when it is freed (a weakref finalizer on the storage, so
                  tensors autograd saves for the backward stay counted).
                  This takes the place of XLA's ``memory_analysis()``.

There are no trip counts: hlo_analysis multiplies ``while`` bodies by
their trips because JAX walks its layers with ``lax.scan``, which XLA's
own cost analysis counts once.  The port walks its layers in a Python
loop, so every layer's ops are dispatched, and counted, one by one.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost
from repro_torch.parallel import spmd

# link-traffic multiplier per collective kind (ring schedule, large groups):
#   all-reduce      ~ 2x buffer (reduce-scatter + all-gather phases)
#   all-gather      ~ 1x full result
#   reduce-scatter  ~ 1x full operand
#   all-to-all      ~ 1x buffer
#   collective-permute ~ 1x buffer (one hop)
#   broadcast       ~ 1x buffer (pipelined from one rank)
COLLECTIVE_TRAFFIC = {
    "all-reduce": ("res", 2.0),
    "all-gather": ("res", 1.0),
    "reduce-scatter": ("arg", 1.0),
    "all-to-all": ("res", 1.0),
    "collective-permute": ("res", 1.0),
    "broadcast": ("res", 1.0),
}

_aten = torch.ops.aten
# the products whose FLOPs count: JAX counts each ``dot``; the attention
# ops of the registry never run in the port (its attention is K2)
FLOP_OPS = {p: flop_registry[p] for p in (
    _aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution,
    _aten._convolution, _aten.convolution_backward)}
# ops that move no bytes of their own: allocations and metadata (views and
# aliases are found by their schemas)
_FREE_OPS = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.detach.default,
    _aten.alias.default, _aten.lift_fresh.default,
    _aten._unsafe_view.default,
    _aten._local_scalar_dense.default, _aten.is_same_size.default,
    _aten.set_.source_Storage_storage_offset,
}
HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64",
              torch.int64: "s64", torch.int32: "s32", torch.int8: "s8",
              torch.uint8: "u8", torch.bool: "pred"}


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements span (an expanded view's, at most its
    storage's)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def buffer_type(t: torch.Tensor) -> str:
    """HLO's array literal for a tensor: ``bf16[16,128]``."""
    return (f"{HLO_DTYPES.get(t.dtype, str(t.dtype))}"
            f"[{','.join(str(d) for d in t.shape)}]")


@dataclasses.dataclass
class Analysis:
    flops: int = 0
    bytes: int = 0
    collectives: dict = dataclasses.field(default_factory=dict)
    by_buffer: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    arg_bytes: int = 0
    peak_live_bytes: int = 0
    n_ops: int = 0

    @property
    def link_bytes(self) -> float:
        return sum(d["link_bytes"] for d in self.collectives.values())

    def top_buffers(self, n: int = 10) -> list[tuple[str, float, int]]:
        """Largest collective contributors: (kind+type, link_bytes, count)."""
        rows = [(k, v["link_bytes"], v["count"])
                for k, v in self.by_buffer.items()]
        return sorted(rows, key=lambda r: -r[1])[:n]


class OpAnalysis(TorchDispatchMode):
    """``with OpAnalysis(args) as a: step()``; then ``a.result`` (an
    ``Analysis``).  ``args`` is any tree of the tensors the step starts
    from; their storages count as live from the start, and drop out when
    they are freed (a donated argument the step replaces)."""

    def __init__(self, args=()) -> None:
        super().__init__()
        self.result = Analysis()
        self._args = args
        self._live: dict[int, int] = {}
        self._live_bytes = 0

    # -- live memory ----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        nb = st.nbytes()
        self._live[key] = nb
        self._live_bytes += nb
        self.result.peak_live_bytes = max(self.result.peak_live_bytes,
                                          self._live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    # -- reports from the kernels and the abstract collectives ----------------
    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        r = self.result
        r.flops += int(flops)
        r.bytes += int(nbytes)
        k = r.kernels.setdefault(name, {"count": 0, "flops": 0, "bytes": 0})
        k["count"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)

    def _collective(self, kind: str, x, out, group_size: int) -> None:
        r = self.result
        arg_b, res_b = tensor_bytes(x), tensor_bytes(out)
        d = r.collectives.setdefault(
            kind, {"count": 0, "result_bytes": 0, "operand_bytes": 0,
                   "link_bytes": 0.0})
        d["count"] += 1
        d["result_bytes"] += res_b
        d["operand_bytes"] += arg_b
        which, mult = COLLECTIVE_TRAFFIC[kind]
        link = mult * (res_b if which == "res" else arg_b)
        d["link_bytes"] += link
        bb = r.by_buffer.setdefault(f"{kind} {buffer_type(out)}",
                                    {"count": 0, "link_bytes": 0.0})
        bb["count"] += 1
        bb["link_bytes"] += link
        r.bytes += res_b + arg_b

    # -- the mode -------------------------------------------------------------
    def __enter__(self):
        for t in tree_flatten(self._args)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.result.arg_bytes = self._live_bytes
        self._args = None          # the step, not the analysis, owns them
        cost.add_sink(self._kernel)
        spmd.collective_sinks.append(self._collective)
        return super().__enter__()

    def __exit__(self, *exc):
        cost.remove_sink(self._kernel)
        spmd.collective_sinks.remove(self._collective)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        r = self.result
        r.n_ops += 1
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        packet = func._overloadpacket
        if packet in FLOP_OPS:
            r.flops += int(FLOP_OPS[packet](*args, **kwargs, out_val=out))
        if func not in _FREE_OPS and not func.is_view:
            r.bytes += sum(tensor_bytes(t) for t in _read(func, args, kwargs)
                           + outs)
        return out


def _read(func, args, kwargs) -> list[torch.Tensor]:
    """The tensors an op reads: its tensor operands but those it writes
    (in place, or ``out=``), which count as its results."""
    written = {a.name for a in func._schema.arguments
               if a.alias_info is not None and a.alias_info.is_write}
    names = [a.name for a in func._schema.arguments]
    vals = [(names[i] if i < len(names) else None, v)
            for i, v in enumerate(args)] + list(kwargs.items())
    return [t for name, v in vals if name not in written
            for t in tree_flatten(v)[0] if isinstance(t, torch.Tensor)]


def analysis_dict(a: Analysis) -> dict:
    return {"flops": a.flops, "bytes": a.bytes, "link_bytes": a.link_bytes,
            "collectives": a.collectives, "kernels": a.kernels,
            "arg_bytes": a.arg_bytes, "peak_live_bytes": a.peak_live_bytes,
            "n_ops": a.n_ops}
