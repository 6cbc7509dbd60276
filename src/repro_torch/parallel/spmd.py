"""The collectives of the GSPMD trainer's per-rank programs, with autograd.

JAX's GSPMD step is one program that XLA partitions; the port runs one
program a rank, each holding its part of every tensor as the specs of
``parallel/sharding.py`` lay it out, and moves data with explicit
``torch.distributed`` collectives on the mesh's process groups
(``launch/mesh.py``).  Each collective here is differentiable with its
exact adjoint, so autograd of the per-rank programs gives every rank the
gradient of the sum of the ranks' objectives:

  * ``all_gather``     (concatenate along a dim)  <->  ``reduce_scatter``
  * ``reduce_scatter`` (sum, split along a dim)   <->  ``all_gather``
  * ``all_reduce``     (sum)                      <->  ``all_reduce``
  * ``all_to_all``     (split one dim, concatenate another) <-> its inverse

``all_reduce_max`` (the element-wise maximum: serving's log-sum-exp
combine over the slices of a decode cache) and ``broadcast`` (one rank's
tensor to its line: serving's read of a state layer that one rank holds)
have no adjoint and raise under grad.

A collective over several axes (an entry of a spec such as
``("data", "model")``) runs on the group of those axes, the first axis the
major one, as JAX lays a dimension over several axes.  On a line of one
rank a collective is the identity and runs nothing.

``counts`` tallies the collectives run, by (op, tag), so a test can count
the ones a layer issues; the backward's adjoints count under their own op
and ``tag + "/bwd"``.

On an abstract mesh (``launch.mesh.make_production_mesh(abstract=True)``:
the dry run's) a collective moves nothing: it takes meta tensors only
(a real tensor raises), returns a meta tensor of the result's shape, and
reports its kind (JAX's HLO names: "all-gather", "reduce-scatter",
"all-reduce", "all-to-all"), operand, result and group size to every sink
in ``collective_sinks`` (``launch/op_analysis.py``'s).  ``shard`` / ``unshard`` cut a global tensor to
this rank's part of a spec and gather it back, and ``relayout`` takes a
part under one spec to the part under another; ``layer_in`` /
``layer_out`` read and write one layer of a stack held under a spec,
and ``RankStates`` a serving program's whole decode state so, a layer
at a time; ``gather_param`` is what a
model's parameter access (``models.common.Params``) runs for a leaf the
trainer holds sharded; ``tp_slice`` gives this rank's 1/|model| slice of a
weight along one dim for the tensor-parallel layers, from whatever layout
the specs gave it.

A CUDA tensor on a gloo group goes through the host (``_staged``): that
route exists only so that several gloo ranks can share one card, which
NCCL does not allow.
"""
from __future__ import annotations

import math
import warnings

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.launch.mesh import AbstractGroup
from repro_torch.parallel import sharding

counts: dict = {}
# sink(kind, operand, result, group_size) for each collective on an
# abstract mesh
collective_sinks: list = []


def reset_counts() -> None:
    counts.clear()


def axis_index(mesh, entry) -> tuple[int, int]:
    """(this rank's index, the number of parts) along a spec entry: the
    axes' coordinates read row-major, the first axis the major one."""
    idx, n = 0, 1
    for a in sharding.spec_axes(entry):
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
        n *= mesh.shape[a]
    return idx, n


def _count(op: str, tag: str) -> None:
    counts[op, tag] = counts.get((op, tag), 0) + 1


def _abstract(kind: str, x, shape, group) -> torch.Tensor:
    """A collective on an abstract mesh: the result's shape, reported."""
    if x.device.type != "meta":
        raise ValueError(f"{kind} on an abstract mesh takes meta tensors "
                         f"only, got one on {x.device}")
    out = torch.empty(shape, dtype=x.dtype, device="meta")
    for sink in list(collective_sinks):
        sink(kind, x, out, group.size)
    return out


def _host(x, group) -> bool:
    """Whether a collective on ``group`` takes ``x`` through the host: a
    CUDA tensor on a gloo group (ranks sharing one card, which NCCL does
    not allow: each stages its part in host memory)."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _staged(at: int):
    """``fn(x, *args)``, its group ``args[at]``, on the host where
    ``_host`` says so, its result moved back to x's device."""
    def wrap(fn):
        def run(x, *args):
            group = args[at]
            if isinstance(group, AbstractGroup) or not _host(x, group):
                return fn(x, *args)
            return fn(x.cpu(), *args).to(x.device)
        return run
    return wrap


@_staged(1)
def _gather(x, dim, group, n):
    if isinstance(group, AbstractGroup):
        shape = list(x.shape)
        shape[dim] *= n
        return _abstract("all-gather", x, shape, group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    with warnings.catch_warnings():   # deprecated for all_gather_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


@_staged(1)
def _scatter(x, dim, group, n):
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    if isinstance(group, AbstractGroup):
        shape = list(x.shape)
        shape[dim] //= n
        return _abstract("reduce-scatter", xt, shape, group)
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM,
                                   group=group)
    return out.movedim(0, dim)


@_staged(0)
def _reduce(x, group, op=dist.ReduceOp.SUM):
    if isinstance(group, AbstractGroup):
        return _abstract("all-reduce", x, x.shape, group)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


@_staged(2)
def _exchange(x, split_dim, concat_dim, group, n):
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    if isinstance(group, AbstractGroup):
        shape = list(x.shape)
        shape[split_dim] //= n
        shape[concat_dim] *= n
        return _abstract("all-to-all", x, shape, group)
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j]: rank j's chunk for this rank; concatenate them along
    # concat_dim (of the chunk, which lost no dim)
    out = recv.movedim(0, concat_dim)
    shape = list(send.shape[1:])
    shape[concat_dim] *= n
    return out.reshape(shape)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, tag):
        ctx.dim, ctx.group, ctx.n, ctx.tag = dim, group, n, tag
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        _count("reduce_scatter", ctx.tag + "/bwd")
        return _scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None, \
            None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, tag):
        ctx.dim, ctx.group, ctx.n, ctx.tag = dim, group, n, tag
        return _scatter(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        _count("all_gather", ctx.tag + "/bwd")
        return _gather(g, ctx.dim, ctx.group, ctx.n), None, None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        _count("all_reduce", ctx.tag + "/bwd")
        return _reduce(g, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, n, tag):
        ctx.args = (split_dim, concat_dim, group, n)
        ctx.tag = tag
        return _exchange(x, split_dim, concat_dim, group, n)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group, n = ctx.args
        _count("all_to_all", ctx.tag + "/bwd")
        return _exchange(g, concat_dim, split_dim, group, n), None, None, \
            None, None, None


def _group(mesh, entry):
    axes = sharding.spec_axes(entry)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return (mesh.group(axes) if n > 1 else None), n


def all_gather(x, dim: int, mesh, entry, tag: str = ""):
    """Concatenate the ranks' ``x`` along ``dim`` over the axes of
    ``entry``, in their row-major order."""
    group, n = _group(mesh, entry)
    if n == 1:
        return x
    _count("all_gather", tag)
    return _AllGather.apply(x, dim % x.dim(), group, n, tag)


def reduce_scatter(x, dim: int, mesh, entry, tag: str = ""):
    """Sum ``x`` over the axes of ``entry`` and keep this rank's part of
    ``dim``."""
    group, n = _group(mesh, entry)
    if n == 1:
        return x
    _count("reduce_scatter", tag)
    return _ReduceScatter.apply(x, dim % x.dim(), group, n, tag)


def all_reduce(x, mesh, entry, tag: str = ""):
    """Sum ``x`` over the axes of ``entry``."""
    group, n = _group(mesh, entry)
    if n == 1:
        return x
    _count("all_reduce", tag)
    return _AllReduce.apply(x, group, tag)


def all_reduce_max(x, mesh, entry, tag: str = ""):
    """The element-wise maximum of ``x`` over the axes of ``entry``,
    counted as ("all_reduce_max", tag).  It has no adjoint: serving takes
    no gradient, and a tensor that requires one under grad raises."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("all_reduce_max has no gradient: call it under "
                           "torch.no_grad()")
    group, n = _group(mesh, entry)
    if n == 1:
        return x
    _count("all_reduce_max", tag)
    return _reduce(x, group, dist.ReduceOp.MAX)


@_staged(0)
def _broadcast(x, group, src: int):
    if isinstance(group, AbstractGroup):
        return _abstract("broadcast", x, x.shape, group)
    out = x.contiguous().clone()
    dist.broadcast(out, src=src, group=group)
    return out


def broadcast(x, src: int, mesh, entry, tag: str = ""):
    """The ``x`` of the rank at position ``src`` of this rank's line
    along ``entry``, on every rank of the line (the others pass a tensor
    of its shape and dtype, whose values are not read); counted as
    ("broadcast", tag).  It has no adjoint: serving takes no gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("broadcast has no gradient: call it under "
                           "torch.no_grad()")
    group, n = _group(mesh, entry)
    if n == 1:
        return x
    _count("broadcast", tag)
    return _broadcast(x, group, mesh.line(sharding.spec_axes(entry))[src])


def all_to_all(x, split_dim: int, concat_dim: int, mesh, entry,
               tag: str = ""):
    """Split ``x`` along ``split_dim`` into one part a rank of ``entry``'s
    axes, send part j to rank j, and concatenate what arrives along
    ``concat_dim``."""
    group, n = _group(mesh, entry)
    if n == 1:
        return x
    _count("all_to_all", tag)
    return _AllToAll.apply(x, split_dim % x.dim(), concat_dim % x.dim(),
                           group, n, tag)


# ----------------------------------------------------------------------------
# tensors by spec
# ----------------------------------------------------------------------------

def _padded(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's part of the global tensor ``t`` under ``spec`` (a view)."""
    for dim, entry in enumerate(_padded(spec, t.dim())):
        idx, n = axis_index(mesh, entry)
        if n > 1:
            if t.shape[dim] % n:
                raise ValueError(f"shard: dim {dim} of {tuple(t.shape)} does "
                                 f"not split {n} ways ({entry})")
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


def unshard(t: torch.Tensor, spec, mesh, tag: str = "") -> torch.Tensor:
    """The global tensor from every rank's part under ``spec``
    (differentiable: the adjoint reduce-scatters)."""
    for dim, entry in enumerate(_padded(spec, t.dim())):
        if entry is not None:
            t = all_gather(t, dim, mesh, entry, tag)
    return t


def relayout(x: torch.Tensor, src, dst, mesh, tag: str = "") -> torch.Tensor:
    """This rank's part of a tensor under spec ``src`` -> its part under
    ``dst``: a dim whose entries differ is gathered over ``src``'s axes
    (differentiable) and cut to ``dst``'s."""
    src, dst = _padded(src, x.dim()), _padded(dst, x.dim())
    for dim, (a, b) in enumerate(zip(src, dst)):
        if sharding.spec_axes(a) == sharding.spec_axes(b):
            continue
        if a is not None:
            x = all_gather(x, dim, mesh, a, tag)
        if b is not None:
            x = shard(x, (None,) * dim + (b,), mesh)
    return x


def layer_in(stack: torch.Tensor, i: int, n_layers: int, spec, want, mesh,
             tag: str = "") -> torch.Tensor:
    """Layer ``i`` of a stacked tensor this rank holds under ``spec`` (its
    first entry the layers'), as this rank's part under ``want`` (the
    layer's own dims): one layer moved, never the stack.  Where the spec
    splits the layers, the rank that holds layer ``i`` broadcasts it over
    that entry's line first."""
    spec = _padded(spec, stack.dim())
    idx, n = axis_index(mesh, spec[0])
    if n > 1:
        owner = i // (n_layers // n)
        t = stack[i % (n_layers // n)] if owner == idx \
            else torch.empty_like(stack[0])
        t = broadcast(t, owner, mesh, spec[0], tag)
    else:
        t = stack[i]
    return relayout(t, spec[1:], want, mesh, tag)


def layer_out(t: torch.Tensor, i: int, n_layers: int, src, spec, mesh,
              tag: str = "") -> torch.Tensor | None:
    """Layer ``i`` of a stack to be held under ``spec`` (its first entry
    the layers'), from ``t``, this rank's part of the layer under ``src``:
    re-laid to ``spec``'s part (every rank of a line takes part in the
    collectives) and returned where this rank holds layer ``i``, else
    None."""
    spec = _padded(spec, t.dim() + 1)
    t = relayout(t, src, spec[1:], mesh, tag)
    idx, n = axis_index(mesh, spec[0])
    return t if i // (n_layers // n) == idx else None


class RankStates:
    """One rank's shard of a serving program's stacked decode state, read
    and written a layer at a time (``layer_in`` / ``layer_out``), never
    the stack.  Each leaf's layer is computed with its rows as the
    tokens' and, where ``split`` names one of the layer's dims (the
    layer dim dropped), that dim over "model".  ``init(batch)`` is the
    family's own whole state at a global batch on meta, from which
    ``sharding.state_layout`` looks the layout up; ``state`` (None in
    prefill) is this rank's shard, refused where a leaf has another
    shape.  ``names`` are the leaves read and written here, under
    ``prefix`` in the state ("mamba/": zamba2's backbone)."""

    def __init__(self, cfg, mesh, rows_here: int, state, init, names,
                 split: dict, *, prefix: str = "") -> None:
        rows = sharding.runtime_batch_spec()[0]
        batch = rows_here * math.prod(mesh.shape[a]
                                      for a in sharding.spec_axes(rows))
        # the whole state on meta for its shapes alone, made outside any
        # dispatch mode: it holds no memory (a dry run's tracker would
        # count it as held)
        with _disable_current_modes():
            whole = init(batch)
        self.layout = sharding.state_layout(cfg, mesh, batch, whole)
        if state is not None:
            sharding.check_state_shards(self.layout, state, mesh)
        self.mesh, self.state, self.prefix = mesh, state, prefix
        self.split = bool(split)
        self.at = {}
        for n in names:
            at = [rows] + [None] * (len(self.layout[prefix + n][1]) - 2)
            if n in split:
                at[split[n]] = "model"
            self.at[n] = tuple(at)
        self.kept = {n: [] for n in names}

    def read(self, i: int, name: str) -> torch.Tensor:
        """Layer ``i`` of leaf ``name``, in the layout it is computed in."""
        spec, whole = self.layout[self.prefix + name]
        return layer_in(sharding.state_leaf(self.state, self.prefix + name),
                        i, whole[0], spec, self.at[name], self.mesh,
                        tag="state")

    def write(self, i: int, name: str, t: torch.Tensor) -> None:
        """Layer ``i`` of leaf ``name`` from ``t`` (in the layout it was
        computed in), kept where this rank holds it."""
        spec, whole = self.layout[self.prefix + name]
        t = layer_out(t, i, whole[0], self.at[name], spec, self.mesh,
                      tag="state")
        if t is not None:
            self.kept[name].append(t)

    def stacks(self) -> dict:
        """This rank's shards of the written layers, by leaf."""
        return {n: torch.stack(ts) for n, ts in self.kept.items()}


def gather_param(p: torch.Tensor) -> torch.Tensor:
    """A parameter the trainer holds sharded (its per-layer spec in
    ``p.spec``), gathered over the registered mesh where a layer uses it."""
    mesh = sharding.runtime_mesh()
    if mesh is None:
        raise RuntimeError("a sharded parameter was read with no runtime "
                           "mesh registered (sharding.set_runtime_mesh)")
    return unshard(p, p.spec, mesh, tag="param")


def tp_slice(p: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's 1/|model| slice of weight ``p`` along ``dim``: its own
    shard when the spec shards ``dim`` over "model"; a slice of it when
    the weight is replicated; re-laid by one all-to-all when the spec
    shards another dim over "model" (``wo`` is sharded on its output dim
    when n_heads * head_dim == d_model, and the row-parallel product needs
    its input dim)."""
    spec = _padded(getattr(p, "spec", None) or (), p.dim())
    dim = dim % p.dim()
    where = [i for i, e in enumerate(spec) if e is not None]
    if any(spec[i] != "model" for i in where) or len(where) > 1:
        raise ValueError(f"tp_slice: spec {spec} is not a 'model' shard")
    if where == [dim]:
        return p
    tp, idx = mesh.shape["model"], mesh.axis_index("model")
    if not where:
        size = p.shape[dim] // tp
        return p.narrow(dim, idx * size, size)
    return all_to_all(p, dim, where[0], mesh, "model", tag="param")
