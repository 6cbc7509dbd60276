"""Mixture-of-Experts FFN with sort-based dispatch.

The counterpart of the JAX package's ``models/moe.py``.  ``apply_moe``:
expand each token k times, stable-sort by expert id, place into an (E, C,
d) capacity buffer, run the batched expert FFN, combine back with the
router probabilities.  Where JAX drops overflowed tokens through the
scatter's out-of-bounds ``mode="drop"``, this version gathers instead of
scattering: each buffer slot reads the row routed to it, an empty slot
is masked to zero, and a dropped row's output is masked to zero (PyTorch
indexing raises on an out-of-bounds index instead of dropping the
write).  Every shape is static, so the dispatch never reads a count back
to the host and runs on meta tensors (the dry run) as JAX's lowered step
does; a masked read takes an index of its own, so no row is read more
than a few times, however skewed the routing (the backward's
accumulating writes stay short).

Every index write and gather here touches each row once, and the combine
sums each token's k rows in a fixed order (rows back in (token, k) order,
then a sum over k), where JAX scatter-adds them: on the card an
``index_add_`` is an atomic add whose order, and so whose fp32 sum, varies
between runs; this way reruns are bitwise, the backward too.

``apply_moe_ep`` is JAX's expert-parallel dispatch (its ``shard_map`` with
two explicit all-to-alls) as one program a rank: under a runtime mesh
(``parallel.sharding.set_runtime_mesh``) each rank routes its block of the
tokens, (batch over the data axes) x (sequence over "model"), sends each
expert's capacity buffer to the "model" rank that holds the expert (the
expert weights stay in their "model" shards), runs its own experts and
sends the outputs back (``parallel.spmd.all_to_all``, differentiable).
``apply_moe_global`` is the global dispatch under such a mesh: the rows
gathered, dispatched together, this rank's rows kept.  ``apply_moe_tp``
is serving's (the decode step's capacity dispatch, and the dropless one):
each rank runs the slots of its own experts for every token, and their
contributions are summed over "model".

Each dispatch counts, on the process's telemetry hub, the rows it routed
(``moe.rows``: T*K) against the expert slots it computes (``moe.slots``:
E*C), from shapes on the host: the dropless dispatch computes E*T slots
for T*K rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.fabric.telemetry import process_hub
from repro_torch.models.common import ArchCfg, Params, dense_init
from repro_torch.parallel import sharding, spmd


def init_moe(cfg: ArchCfg, gen, device) -> Params:
    m = cfg.moe
    d, f, e, dt = cfg.d_model, m.d_expert, m.n_experts, cfg.dtype
    return Params(
        router=dense_init(gen, (d, e), torch.float32, device, scale=0.02),
        w_gate=dense_init(gen, (e, d, f), dt, device),
        w_up=dense_init(gen, (e, d, f), dt, device),
        w_down=dense_init(gen, (e, f, d), dt, device),
    )


def capacity(cfg: ArchCfg, n_tokens: int) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(c, m.top_k)


def _expert_counts(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """(E,) int64: how many of the routed rows each expert got."""
    return torch.zeros(E, dtype=torch.int64, device=flat_e.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))


def _local_dispatch(cfg: ArchCfg, xt, router, K: int, E: int, C: int,
                    experts: tuple[int, int] | None = None):
    """Route a token block xt (T, d): returns (buf (E*C, d), combine,
    probs (T, E), flat_e (T*K,)); ``combine(outbuf)`` gives the (T, d)
    fp32 sum of each token's kept expert rows, weighted.  ``experts``
    (lo, hi) fills the slots of those experts alone (buf ((hi-lo)*C, d)),
    and ``combine`` sums their rows alone."""
    T, d = xt.shape
    n = T * K
    dev = xt.device
    # --- routing (fp32 for a stable softmax) -------------------------------
    logits = xt.float() @ router                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)              # (T, K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # --- sort-based dispatch -----------------------------------------------
    flat_e = top_e.reshape(-1)                               # (T*K,)
    flat_p = top_p.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _expert_counts(flat_e, E)                       # (E,)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n, device=dev) - starts[sorted_e]
    keep = pos_in_e < C                                      # capacity mask
    lo, hi = experts or (0, E)
    if experts is not None:                  # the rows of those experts
        keep = keep & (sorted_e >= lo) & (sorted_e < hi)
    # each sorted row's buffer slot; a dropped row reads slot i mod E*C,
    # masked below
    slot = torch.where(keep, (sorted_e - lo) * C + pos_in_e,
                       torch.arange(n, device=dev) % ((hi - lo) * C))
    # buffer slot (e, c) holds the c-th row routed to e, if there is one
    c = torch.arange(C, device=dev)
    filled = (c[None, :] < counts[lo:hi, None]).reshape(-1, 1)
    src = ((starts[lo:hi, None] + c[None, :]) % max(n, 1)).reshape(-1)
    xk = xt[:, None].expand(T, K, d).reshape(n, d)           # token k times
    buf = torch.where(filled, xk[order[src]], 0)

    def combine(outbuf):
        # every (token, k) row once, a dropped one zero
        rows = torch.where(keep[:, None], outbuf[slot].float()
                           * flat_p[order][:, None], 0.0)
        wk = torch.zeros((n, d), dtype=torch.float32, device=dev)
        wk[order] = rows
        return wk.reshape(T, K, d).sum(1)

    return buf, combine, probs, flat_e


def _count(rows: int, slots: int) -> None:
    """One dispatch's routed rows and computed slots, on the process hub."""
    hub = process_hub()
    hub.add("moe.rows", rows)
    hub.add("moe.slots", slots)


def _expert_ffn(buf, wg, wu, wd, dtype):
    """(E, C, d) tokens through each expert's SwiGLU FFN -> (E, C, d)."""
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, wg).float())
    u = torch.einsum("ecd,edf->ecf", buf, wu).float()
    return torch.einsum("ecf,efd->ecd", (g * u).to(dtype), wd)


def apply_moe(cfg: ArchCfg, p: Params, x: torch.Tensor, *,
              dropless: bool = False):
    """x: (B, S, d) -> (y: (B, S, d), aux_loss: scalar fp32).

    ``dropless=True`` sizes every expert's buffer to the full token count,
    so no token is ever capacity-dropped — what serving requires, since
    with drops a token's output depends on what else shares the forward."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = T if dropless else capacity(cfg, T)
    _count(T * K, E * C)
    buf, combine, probs, flat_e = _local_dispatch(
        cfg, x.reshape(T, d), p["router"], K, E, C)
    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(0)                                       # (E,)
    ce = _expert_counts(flat_e, E).float() / (T * K)
    aux = m.router_aux_weight * E * torch.sum(me * ce)
    out = _expert_ffn(buf.reshape(E, C, d), p["w_gate"], p["w_up"],
                      p["w_down"], x.dtype).reshape(E * C, d)
    return combine(out).reshape(B, S, d).to(x.dtype), aux


def apply_moe_global(cfg: ArchCfg, p: Params, x: torch.Tensor):
    """``apply_moe`` over the global batch: under a runtime mesh whose
    batch rows are split over ranks, the rows are gathered, dispatched
    together (capacity and the aux loss from every token, as JAX's global
    dispatch) and this rank's rows kept."""
    mesh, (axes, _) = sharding.runtime_mesh(), sharding.runtime_batch_spec()
    if mesh is None or axes is None:
        return apply_moe(cfg, p, x)
    y, aux = apply_moe(cfg, p, spmd.all_gather(x, 0, mesh, axes, tag="moe"))
    return spmd.shard(y, (axes,), mesh), aux


def apply_moe_tp(cfg: ArchCfg, p: Params, x: torch.Tensor, *,
                 dropless: bool = False):
    """``apply_moe`` (JAX's capacity dispatch of the decode step, or
    serving's dropless one) as a rank program under the runtime mesh:
    the capacity dispatch sees the global batch (the rows gathered over
    the batch axes, this rank's kept after); every rank routes every
    token with the router, fills and runs the capacity slots of its
    E/|model| experts alone, from its "model" shard of each expert
    tensor, and the experts' fp32 contributions are summed over "model"
    (one all-reduce).  Where "model" does not split the experts, the
    global dispatch (``apply_moe_global``; dropless: ``apply_moe``) with
    the experts gathered where read."""
    mesh = sharding.runtime_mesh()
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    tp = 1 if mesh is None else sharding.tp_size(mesh, cfg)
    if tp <= 1 or E % tp:
        if dropless or mesh is None:
            return apply_moe(cfg, p, x, dropless=dropless)
        return apply_moe_global(cfg, p, x)
    rows = sharding.runtime_batch_spec()[0]
    xg = x if dropless else spmd.all_gather(x, 0, mesh, rows, tag="moe")
    B, S, d = xg.shape
    T = B * S
    C = T if dropless else capacity(cfg, T)
    E_loc = E // tp
    _count(T * K, E * C)       # the whole dispatch; this rank's E_loc * C
    lo = mesh.axis_index("model") * E_loc
    buf, combine, probs, flat_e = _local_dispatch(
        cfg, xg.reshape(T, d), p["router"], K, E, C,
        experts=(lo, lo + E_loc))
    me = probs.mean(0)
    ce = _expert_counts(flat_e, E).float() / (T * K)
    aux = m.router_aux_weight * E * torch.sum(me * ce)
    w = {k: spmd.tp_slice(p.local(k), 0, mesh)
         for k in ("w_gate", "w_up", "w_down")}
    out = _expert_ffn(buf.reshape(E_loc, C, d), w["w_gate"], w["w_up"],
                      w["w_down"], x.dtype).reshape(E_loc * C, d)
    y = spmd.all_reduce(combine(out), mesh, "model", tag="expert")
    y = y.reshape(B, S, d).to(x.dtype)
    return (y if dropless else spmd.shard(y, (rows,), mesh)), aux


def _parts(mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in sharding.spec_axes(entry))


def apply_moe_ep(cfg: ArchCfg, p: Params, x: torch.Tensor):
    """Expert-parallel MoE: x (this rank's rows, as the runtime batch spec
    lays them) -> (y likewise, aux).  Tokens are split over (data axes x
    "model") for routing; capacity buffers cross "model" by two explicit
    all-to-alls; experts stay in their "model" shards.  Without a mesh, a
    "model" axis of 1, or experts, sequence or batch that do not divide,
    the global dispatch runs (JAX's fallback)."""
    mesh = sharding.runtime_mesh()
    m = cfg.moe
    tp = 1 if mesh is None else sharding.tp_size(mesh)
    Bl, Sl, d = x.shape
    src = sharding.runtime_batch_spec()
    if mesh is not None:   # the global batch's shape
        B, S = Bl * _parts(mesh, src[0]), Sl * _parts(mesh, src[1])
    if mesh is None or tp <= 1 or m.n_experts % tp or S % tp \
            or B % max(sharding.dp_size(mesh), 1):
        return apply_moe_global(cfg, p, x)
    dpx = sharding.dp_axes(mesh)
    E, K = m.n_experts, m.top_k
    E_loc = E // tp
    T_loc = (B // max(sharding.dp_size(mesh), 1)) * (S // tp)
    C = max(int(T_loc * K / E * m.capacity_factor), K)
    all_axes = tuple(dpx) + ("model",)
    n_all = _parts(mesh, all_axes)
    blk = (tuple(dpx) or None, "model")
    xs = spmd.relayout(x, src, blk, mesh, "moe")     # this rank's block
    xt = xs.reshape(-1, d)
    _count(xt.shape[0] * K, E * C)
    buf, combine, probs, flat_e = _local_dispatch(cfg, xt, p["router"], K,
                                                  E, C)
    # Switch-style aux loss from globally-averaged router stats
    me = spmd.all_reduce(probs.mean(0), mesh, all_axes, tag="moe") / n_all
    with torch.no_grad():
        ce = spmd.all_reduce(_expert_counts(flat_e, E).float()
                             / flat_e.numel(), mesh, all_axes,
                             tag="moe") / n_all
    aux = m.router_aux_weight * E * torch.sum(me * ce)
    # dispatch all-to-all: (tp, E_loc*C, d) -> dim 0 becomes the sender
    recv = spmd.all_to_all(buf.reshape(tp, E_loc * C, d), 0, 0, mesh,
                           "model", tag="moe")
    toks = recv.reshape(tp, E_loc, C, d).transpose(0, 1) \
        .reshape(E_loc, tp * C, d)
    # this rank's experts: its "model" shard of each expert tensor
    w = {k: spmd.tp_slice(p.local(k), 0, mesh)
         for k in ("w_gate", "w_up", "w_down")}
    out = _expert_ffn(toks, w["w_gate"], w["w_up"], w["w_down"], xs.dtype)
    # return all-to-all: each expert output back to its token's rank
    back = out.reshape(E_loc, tp, C, d).transpose(0, 1) \
        .reshape(tp, E_loc * C, d)
    ret = spmd.all_to_all(back, 0, 0, mesh, "model", tag="moe")
    y = combine(ret.reshape(E * C, d)).reshape(xs.shape).to(x.dtype)
    return spmd.relayout(y, blk, src, mesh, "moe"), aux
