"""Sharding rules: partition specs for params, batches and decode state.

The counterpart of the JAX package's ``parallel/sharding.py``, with the
same rules; only the specs' type differs.  Axes: DP over ("pod", "data")
[batch], TP over "model" [heads / hidden / vocab / experts], ZeRO-1
optimizer-state sharding over "data".

A spec is a ``PartitionSpec``: a tuple with one entry per dimension, each
None (replicated), an axis name, or a tuple of axis names (the dimension
split over those axes together, the first the major one), as JAX's
``PartitionSpec``.  The spec functions read only a mesh's ``.shape`` (axis
name -> size) and ``.axis_names``, so they take the port's live
``launch.mesh.Mesh`` as well as an ``abstract_mesh`` of the 16x16 and
2x16x16 production meshes, which no process group backs.

Parameter rules are path+shape driven over the JAX pytree's keys, so one
rule set covers all ten arch families (stacked layer params carry a
leading L axis that is never sharded; a stacked leaf's spec minus its
first entry is the spec of each layer's tensor in the port's per-layer
modules):

  * MoE expert tensors (E, d, f): E -> "model"  (expert parallelism)
  * other >=2D weights: shard the last dim whose size divides |model| and
    that is not d_model; fall back to any divisible dim; else replicate
    (e.g. GQA kv projections with 2 kv heads < 16-way TP stay replicated)
  * 1D tensors: shard iff not d_model-sized and divisible
  * norms / scalars / tiny leaves: replicated

Batch rule: batch dim over DP axes when divisible; under dp_only an idle
"model" axis takes the sequence instead.

Trees are nested dicts keyed like the JAX pytree; a leaf is anything with
a ``.shape`` (``models.api.param_shapes`` gives meta tensors).  The
runtime-mesh registry (``set_runtime_mesh``) is how the GSPMD trainer
tells the models which mesh their per-rank programs run on, and which
part of the batch each rank holds
(``parallel/spmd.py`` holds those programs' collectives).
"""
from __future__ import annotations

import math

STACKED_KEYS = {"layers", "mamba", "enc_layers", "dec_layers"}
MOE_EXPERT_KEYS = {"w_gate", "w_up", "w_down"}


class PartitionSpec(tuple):
    """``P("data", None, ("pod", "data"))``: one entry per dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """A mesh of named axes and their sizes, with no ranks behind it."""

    def __init__(self, shape, axis_names) -> None:
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError("mesh shape/axis arity mismatch")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))


def abstract_mesh(shape, axes) -> AbstractMesh:
    """Device-less mesh for spec-level use on the production meshes."""
    return AbstractMesh(shape, axes)


# ----------------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------------

def tree_map_with_path(fn, tree, *rest, path=()):
    """fn(path, leaf, *rest_leaves) over a nested dict (path: the keys)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def flatten(tree, sep: str = "/") -> dict:
    """{path joined by ``sep``: leaf} of a nested dict, in sorted-key order
    (the port's trainer keys leaves so: ``"layers/attn/wq"``)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out[sep.join(path)] = t
    walk(tree, ())
    return out


# ----------------------------------------------------------------------------
# axes
# ----------------------------------------------------------------------------

def dp_axes(mesh, cfg=None) -> tuple[str, ...]:
    names = ["pod", "data"]
    if cfg is not None and cfg.parallelism == "dp_only":
        names.append("model")   # batch over every axis, params replicated
    return tuple(a for a in names if a in mesh.axis_names)


def dp_size(mesh, cfg=None) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh, cfg))


def tp_size(mesh, cfg=None) -> int:
    if cfg is not None and cfg.parallelism == "dp_only":
        return 1
    return mesh.shape.get("model", 1)


def _param_spec(path, shape, cfg, tp: int) -> P:
    keys = list(path)
    name = keys[-1]
    stacked = any(k in STACKED_KEYS for k in keys)
    dims = list(shape[1:]) if stacked else list(shape)
    offset = 1 if stacked else 0

    def lift(spec_dims):
        return P(*([None] * offset + spec_dims))

    if not dims:
        return P()
    if tp <= 1:  # no TP axis in this mesh: everything replicated
        return lift([None] * len(dims))
    # MoE expert tensors: expert-parallel on the leading E axis
    if "moe" in keys and name in MOE_EXPERT_KEYS and len(dims) == 3:
        if dims[0] % tp == 0:
            return lift(["model", None, None])
        return lift([None, None, None])
    if len(dims) == 1:
        n = dims[0]
        if n != cfg.d_model and n % tp == 0 and n >= tp:
            return lift(["model"])
        return lift([None])
    # >= 2D: prefer last non-d_model divisible dim, then any divisible dim
    spec = [None] * len(dims)
    candidates = [i for i in reversed(range(len(dims)))
                  if dims[i] % tp == 0 and dims[i] >= tp]
    preferred = [i for i in candidates if dims[i] != cfg.d_model]
    pick = (preferred or candidates)
    if pick:
        spec[pick[0]] = "model"
    return lift(spec)


def param_specs(cfg, shapes, mesh):
    """Spec tree matching the param-shape tree."""
    tp = tp_size(mesh, cfg)
    return tree_map_with_path(
        lambda path, leaf: _param_spec(path, tuple(leaf.shape), cfg, tp),
        shapes)


def zero1_specs(cfg, shapes, mesh):
    """Optimizer-moment specs: params' specs + the largest remaining dim
    sharded over "data" (ZeRO-1: moments never need to be re-gathered for
    the forward pass, so they can shard further than params)."""
    base = param_specs(cfg, shapes, mesh)
    nd = mesh.shape.get("data", 1)
    if nd <= 1:  # no data axis: ZeRO-1 degenerates to plain param specs
        return base

    # dp_only: params are replicated, so moments can shard over the whole
    # (data x model) device grid
    zaxes = ("data", "model") if cfg.parallelism == "dp_only" \
        and "model" in mesh.axis_names else ("data",)
    nz = math.prod(mesh.shape[a] for a in zaxes)

    def extend(path, leaf, spec):
        dims = list(leaf.shape)
        used = list(spec) + [None] * (len(dims) - len(spec))
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if used[i] is None and dims[i] % nz == 0 and dims[i] >= nz:
                used[i] = zaxes if len(zaxes) > 1 else "data"
                break
        else:
            for i in order:
                if used[i] is None and dims[i] % nd == 0 and dims[i] >= nd:
                    used[i] = "data"
                    break
        return P(*used)

    return tree_map_with_path(extend, shapes, base)


# ----------------------------------------------------------------------------
# batch / state specs
# ----------------------------------------------------------------------------

def _dp_prefix(mesh, cfg, n: int) -> tuple[tuple[str, ...], int]:
    """Longest prefix of the DP axes whose size product divides n."""
    out: list[str] = []
    prod = 1
    for a in dp_axes(mesh, cfg):
        if n > 0 and n % (prod * mesh.shape[a]) == 0:
            out.append(a)
            prod *= mesh.shape[a]
        else:
            break
    return tuple(out), prod


def batch_specs(cfg, batch_shapes, mesh):
    """Shard the leading (batch) dim of every input over the largest
    dividing DP-axis prefix; under dp_only an idle 'model' axis picks up
    the sequence dim instead (SP) — a global batch smaller than the
    device grid must never silently replicate the whole computation."""
    def one(path, leaf):
        dims = list(leaf.shape)
        if not dims:
            return P()
        axes_used, _ = _dp_prefix(mesh, cfg, dims[0])
        spec: list = [None] * len(dims)
        if axes_used:
            spec[0] = axes_used
        if cfg.parallelism == "dp_only" and "model" not in axes_used \
                and "model" in mesh.axis_names and len(dims) >= 2 \
                and dims[1] % mesh.shape["model"] == 0 and dims[1] > 1:
            spec[1] = "model"
        return P(*spec)

    return tree_map_with_path(one, batch_shapes)


def decode_state_specs(cfg, state_shapes, mesh, global_batch: int):
    """Decode caches: batch over the largest dividing DP-axis prefix;
    head-indexed dims shard over "model" under TP; a leftover axis
    ("model" under dp_only, "data" at batch 1) picks up the cache
    *sequence* dim (sequence-parallel decode)."""
    axes_used, nprod = _dp_prefix(mesh, cfg, global_batch)
    tp = tp_size(mesh, cfg)

    def _seq_shard(spec, dims, axis_name, min_dim=1024):
        m = mesh.shape[axis_name]
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if spec[i] is None and dims[i] % m == 0 and dims[i] > min_dim:
                spec[i] = axis_name
                return

    def one(path, leaf):
        dims = list(leaf.shape)
        spec = [None] * len(dims)
        # find the batch dim (== global_batch); caches carry leading L axis
        if axes_used:
            for i, d in enumerate(dims):
                if d == global_batch:
                    spec[i] = axes_used
                    break
        # shard one more dim over model: prefer head-count / feature dims
        if tp > 1:
            for i in reversed(range(len(dims))):
                if spec[i] is None and dims[i] % tp == 0 and dims[i] >= tp \
                        and i != len(dims) - 1:  # keep head_dim/lane dim whole
                    spec[i] = "model"
                    break
        elif cfg.parallelism == "dp_only" and "model" not in axes_used \
                and "model" in mesh.axis_names:
            _seq_shard(spec, dims, "model")      # SP decode over 'model'
        if not axes_used and "data" in mesh.axis_names:
            _seq_shard(spec, dims, "data")       # long_500k: seq over data
        return P(*spec)

    return tree_map_with_path(one, state_shapes)


class _Shape:
    def __init__(self, shape) -> None:
        self.shape = tuple(shape)


def cache_layout(cfg, mesh, global_batch: int, max_len: int):
    """How ``decode_state_specs`` lays a decoder's dense cache (L, B,
    max_len, Hkv, hd) out: (layout, spec), the layout "heads" (the KV
    heads over "model"), "seq" (the sequence over "model"), None (nothing
    but the batch split) or "other" (the spec falls on B or L, or puts
    another axis on the sequence)."""
    shape = (cfg.n_layers, global_batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    spec = P(*decode_state_specs(cfg, {"k": _Shape(shape)}, mesh,
                                 global_batch)["k"])
    rest = spec[:1] + spec[2:]
    if "model" not in spec_axes(spec[1]):
        for name, at in (("heads", 3), ("seq", 2)):
            if rest == tuple("model" if i == at else None
                             for i in (0, 2, 3, 4)):
                return name, spec
        if not any(rest):
            return None, spec
    return "other", spec


def encdec_layout(cfg, mesh, global_batch: int, max_len: int) -> dict:
    """How ``decode_state_specs`` lays the encoder-decoder's decode state
    out, in the port's layout: {leaf: (spec, whole shape)} for the self-
    attention caches "k"/"v" (L, B, max_len, Hkv, hd) and the cross K/V
    "cross_k"/"cross_v", kept as (L, B, Hkv, F, hd) where JAX keeps (L,
    B, F, Hkv, hd).  The specs are taken on JAX's shapes and the cross
    ones' entries 2 and 3 swapped onto the port's: the rule walks the
    dims from the last, so on the port's own shape it would pick the
    frames where JAX picks the KV heads."""
    L, hd, Hkv = cfg.n_layers, cfg.resolved_head_dim, cfg.n_kv_heads
    B = global_batch
    shapes = {"k": (L, B, max_len, Hkv, hd), "v": (L, B, max_len, Hkv, hd),
              "cross_k": (L, B, cfg.n_frames, Hkv, hd),
              "cross_v": (L, B, cfg.n_frames, Hkv, hd)}
    specs = decode_state_specs(cfg, {k: _Shape(s) for k, s in shapes.items()},
                               mesh, B)
    out = {}
    for name, shape in shapes.items():
        spec = tuple(specs[name])
        if name.startswith("cross_"):
            spec = spec[:2] + (spec[3], spec[2]) + spec[4:]
            shape = shape[:2] + (shape[3], shape[2]) + shape[4:]
        out[name] = (P(*spec), shape)
    return out


def state_layout(cfg, mesh, global_batch: int, whole: dict) -> dict:
    """How ``decode_state_specs`` lays a decode state out: {"/"-joined
    leaf path: (spec, whole shape)}, ``whole`` the family's own state at
    the global batch (its ``init_state`` on meta).  Looked up from the
    global batch and the whole state's shapes, never from a shard's shape
    (a shard of a deep cache has the shape of a shallow whole one)."""
    leaves = state_paths(whole)
    specs = decode_state_specs(cfg, leaves, mesh, global_batch)
    return {k: (P(*specs[k]), tuple(v.shape)) for k, v in leaves.items()}


def state_paths(state: dict, prefix: str = "") -> dict:
    """{"/"-joined path: leaf} of nested dicts, entries that are no
    tensor (zamba2's "max_len") left out."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(state_paths(v, f"{prefix}{k}/"))
        elif hasattr(v, "shape"):
            out[prefix + k] = v
    return out


def state_leaf(state: dict, path: str):
    """The leaf of nested dicts at a "/"-joined ``path``."""
    for k in path.split("/"):
        state = state[k]
    return state


def check_state_shards(layout: dict, state: dict, mesh) -> None:
    """Raise unless every leaf of ``state`` has the shape of its shard
    under ``layout`` (``state_layout``'s)."""
    for path, (spec, whole) in layout.items():
        got, want = tuple(state_leaf(state, path).shape), \
            local_shape(spec, whole, mesh)
        if got != want:
            raise ValueError(f"decode_step: a {path} shard of shape {got}, "
                             f"where decode_state_specs gives {want}")


def local_shape(spec, shape, mesh) -> tuple:
    """The shape of this rank's part of a tensor of ``shape`` under
    ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(mesh.shape[a] for a in spec_axes(e))
                 for d, e in zip(shape, spec))


def serving_mesh(cfg):
    """The registered mesh where serving runs a rank program on it (a
    "model" axis of more than one rank that splits the layers' work, not
    the batch rows), else None: then the plain path runs on this rank's
    rows."""
    mesh = _RUNTIME_MESH
    if mesh is None or tp_size(mesh, cfg) <= 1 \
            or "model" in spec_axes(runtime_batch_spec()[0]):
        return None
    return mesh


# ----------------------------------------------------------------------------
# runtime mesh registry: models are functions of (cfg, params, batch), but
# the GSPMD trainer's per-rank programs need the ambient mesh — the dense
# stack's tensor and sequence parallelism, and the gathers of sharded
# leaves.  The trainer registers its mesh here; with no mesh registered the
# models run their plain single-rank path.
# ----------------------------------------------------------------------------

_RUNTIME_MESH = None
_RUNTIME_BATCH = P()


def set_runtime_mesh(mesh, batch_spec=None) -> None:
    """Register the mesh the per-rank programs run on (None: none), and
    ``batch_spec``, the spec of the (B, S) token rows each rank holds
    (None: every rank holds the whole batch)."""
    global _RUNTIME_MESH, _RUNTIME_BATCH
    _RUNTIME_MESH = mesh
    _RUNTIME_BATCH = P(*(batch_spec or ()))


def runtime_mesh():
    return _RUNTIME_MESH


def runtime_batch_spec() -> tuple:
    """(batch entry, sequence entry) of the registered rows' spec."""
    return (tuple(_RUNTIME_BATCH) + (None, None))[:2]


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def constrain_activations(x, *, seq_axis: str | None = None):
    """Pin a (B, S, d) activation replicated over "model" to the layout
    of the tensor-parallel residual stream.

    JAX constrains the layout and lets the partitioner move the data; a
    rank of the port holds its part explicitly.  Megatron-style TP keeps
    the residual replicated over "model" (``seq_axis=None``): x as it is.
    Sequence parallelism shards S over "model" (``seq_axis="model"``):
    this rank's contiguous slice of S, when S divides (else x, as JAX
    leaves an indivisible S unsharded).  No-op without a registered mesh,
    or on a mesh that has no such axis."""
    mesh = _RUNTIME_MESH
    if mesh is None or not seq_axis or seq_axis not in mesh.axis_names \
            or x.dim() < 2 or not dp_axes(mesh):
        return x
    n = mesh.shape[seq_axis]
    if n <= 1 or x.shape[1] % n:
        return x
    i = mesh.axis_index(seq_axis)
    return x.narrow(1, i * (x.shape[1] // n), x.shape[1] // n)
