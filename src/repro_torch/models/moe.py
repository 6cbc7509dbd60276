"""Mixture-of-Experts FFN with sort-based dispatch.

The counterpart of the JAX package's ``models/moe.py::apply_moe``: expand
each token k times, stable-sort by expert id, place into an (E, C, d)
capacity buffer, run the batched expert FFN, combine back with the router
probabilities.  Where JAX drops overflowed tokens through the scatter's
out-of-bounds ``mode="drop"``, this version writes only the rows an
explicit ``keep`` mask selects (PyTorch indexing raises on an
out-of-bounds index instead of dropping the write).

The expert-parallel dispatch (``apply_moe_ep``, shard_map with explicit
all-to-alls) waits for the collectives slice of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchCfg, Params, dense_init


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
    dev = x.device
    xt = x.reshape(T, d)

    # --- routing (fp32 for a stable softmax) ---------------------------------
    logits = xt.float() @ p["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)              # (T, K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(0)                                       # (E,)
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, top_e.reshape(-1),
        torch.full((T * K,), 1.0 / (T * K), dtype=torch.float32, device=dev))
    aux = m.router_aux_weight * E * torch.sum(me * ce)

    # --- sort-based dispatch ---------------------------------------------------
    flat_e = top_e.reshape(-1)                               # (T*K,)
    flat_p = top_p.reshape(-1)
    tok_id = torch.arange(T * K, device=dev) // K
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)             # (E,)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * K, device=dev) - starts[sorted_e]
    keep = pos_in_e < C                                      # capacity mask
    dest = sorted_e * C + pos_in_e
    src_tok = tok_id[order]

    buf = torch.zeros((E * C, d), dtype=x.dtype, device=dev)
    buf[dest[keep]] = xt[src_tok[keep]]
    buf = buf.reshape(E, C, d)

    # --- expert FFN (batched over E) --------------------------------------------
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"]).float())
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"]).float()
    h = (g * u).to(x.dtype)
    out = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(E * C, d)

    # --- combine -------------------------------------------------------------------
    gathered = torch.zeros((T * K, d), dtype=x.dtype, device=dev)
    gathered[keep] = out[dest[keep]]
    weighted = gathered.float() * flat_p[order][:, None]
    y = torch.zeros((T, d), dtype=torch.float32, device=dev).index_add_(
        0, src_tok, weighted)
    return y.reshape(B, S, d).to(x.dtype), aux
