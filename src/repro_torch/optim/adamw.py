"""AdamW with global-norm clipping, cosine schedule, fp32 moments.

The counterpart of the JAX package's ``optim/adamw.py``.  Parameters,
gradients and moments are dicts keyed by leaf (the trainer keys them by
the JAX pytree's leaf paths, ``repro_torch.weights.jax_leaves``, so rules
that read a leaf's shape see JAX's shapes); every function is functional,
as JAX's are: it returns new tensors and leaves its arguments as they were,
except ``adamw_update_``, the single-card step's update in place (CUDA
only: one kernel pair, ``kernels/adamw.py``), and ``adamw_update_plain_``,
its plain version on any device.  Moments are fp32 whatever the
parameters' dtype; the update runs in fp32 and casts the new parameter
back to its dtype.  The
process hub counts the elements each path updated: ``adamw.eager_elems``
(``adamw_update``) and ``adamw.fused_elems`` (the kernel pair).

Also the *explicit* APEX update of the paper-faithful DP trainer:
gradients reduce-scattered with the torus ring collectives, the
shard-local moment update, and the parameter all-gather — per rank, over
the DP axis of a ``repro_torch.launch.mesh.Mesh`` (JAX: inside
``shard_map``; ``axis_index`` is this rank's position in its DP group).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import weights
from repro_torch.core.fabric.telemetry import process_hub
from repro_torch.kernels.adamw import fused_adamw
from repro_torch.models.common import ArchCfg


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (a number or a tensor), fp32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def adamw_init(params: dict) -> dict:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)
    return {"m": zeros, "v": {k: z.clone() for k, z in zeros.items()},
            "step": step}


def _bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    sf = step.float()
    return 1 - cfg.b1 ** sf, 1 - cfg.b2 ** sf


def adamw_update(cfg: AdamWConfig, grads: dict, state: dict, params: dict,
                 *, grad_norm: torch.Tensor | None = None):
    """Returns (new_params, new_state, metrics).  ``grad_norm`` replaces
    the global norm of ``grads`` for the clipping (the GSPMD trainer
    updates slices of the leaves, whose norm is the mesh's sum)."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cosine_schedule(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        m = b1 * state["m"][k] + (1 - b1) * g
        v = b2 * state["v"][k] + (1 - b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:   # no decay on norms/biases
            delta = delta + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    process_hub().add("adamw.eager_elems",
                      sum(p.numel() for p in params.values()))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics


def adamw_update_(cfg: AdamWConfig, params: dict, state: dict) -> dict:
    """``adamw_update`` in place, on a card: one kernel pair updates every
    tensor, with no stacked copy.  ``params`` maps each leaf to its
    tensors (a layer-stacked leaf's layers in order, as
    ``weights.jax_leaves`` gives them); each tensor's ``.grad`` is its
    gradient (None: zeros).  The tensors, their slices of the leaves'
    stacked moments ``state["m"]`` / ``state["v"]`` and ``state["step"]``
    are updated in place; a leaf decays where its moment's rank is 2 or
    more, as the stacked leaf's rank is.  Returns the metrics.  CUDA
    tensors only; the plain version is ``adamw_update_plain_``."""
    step = state["step"]
    if step.device.type != "cuda":
        raise ValueError(f"adamw_update_: the state is on {step.device}; "
                         "the kernel pair takes CUDA tensors only")
    step.add_(1)
    lr = cosine_schedule(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    gnorm = fused_adamw(cfg, params, state["m"], state["v"], lr, bc1, bc2)
    return {"grad_norm": gnorm, "lr": lr}


def adamw_update_plain_(cfg: AdamWConfig, params: dict, state: dict, *,
                        arch: ArchCfg) -> dict:
    """The plain version of ``adamw_update_``, on any device: every
    ``arch`` leaf's tensors and gradients as ``weights.leaf_tensor`` stacks
    them, ``adamw_update``, the results copied back by
    ``weights.assign_leaf``."""
    with torch.no_grad():
        grads = {k: weights.leaf_tensor(arch, k, [
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in ps]) for k, ps in params.items()}
        values = {k: weights.leaf_tensor(arch, k, [p.detach() for p in ps])
                  for k, ps in params.items()}
        new_p, new, metrics = adamw_update(cfg, grads, state, values)
        for k, ps in params.items():
            weights.assign_leaf(arch, k, ps, new_p[k])
            state["m"][k].copy_(new["m"][k])
            state["v"][k].copy_(new["v"][k])
        state["step"].copy_(new["step"])
    return metrics


# ----------------------------------------------------------------------------
# APEX explicit ZeRO-1 update (per rank, over the DP axis):
#   RS(grads) -> shard-local AdamW on the 1/N state slice -> AG(params)
# All traffic is first-neighbour torus puts (core/collectives).
# ----------------------------------------------------------------------------

def apex_zero1_init(params: dict, dp: int) -> dict:
    """Shard-local fp32 moment slices: each DP rank owns 1/dp of every
    (flattened, padded) parameter; the global representation is the
    concatenation of the ranks' slices."""
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros((-(-p.numel() // dp),), dtype=torch.float32,
                            device=device) for k, p in params.items()}
    return {"m": zeros, "v": {k: z.clone() for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def apex_zero1_update(cfg: AdamWConfig, grads: dict, state: dict,
                      params: dict, *, mesh, axis_name: str,
                      rs_schedule=None, ag_schedule=None,
                      pre_reduced: bool = False):
    """Per-rank code.  grads/params are the full (replicated w.r.t. the DP
    axis) values; moments are 1/N slices.  Returns (new_params, new_state).

    ``rs_schedule``/``ag_schedule`` are optional pre-lowered (possibly
    fault-rewritten) ``fabric.CollectiveSchedule`` objects for the gradient
    reduce-scatter and parameter all-gather.

    ``pre_reduced=True`` is the overlap-engine contract: gradients were
    already reduce-scattered inside the backward pass by the fabric's
    bucket grad hook (``fabric.make_bucket_grad_hook``) — each leaf holds
    this rank's reduced chunk at its ring slot (zeros elsewhere), so the
    update only slices its shard out instead of running the collective
    again."""
    from repro_torch.core import collectives as C

    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    n = mesh.shape[axis_name]
    r = mesh.axis_index(axis_name)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g, m, v = grads[k], state["m"][k], state["v"][k]
        chunk = m.shape[0]
        if pre_reduced:
            # the bucket hook already ran the ring RS inside backward:
            # slice this rank's chunk (the rest of the buffer is zeros)
            gflat = g.reshape(-1).float()
            gshard = F.pad(gflat, (0, chunk * n - gflat.numel()))[
                r * chunk:(r + 1) * chunk]
        else:
            # mean gradient shard for this rank (ring reduce-scatter)
            gshard = C.ring_reduce_scatter(g.float(), axis_name, mesh,
                                           mean=True, schedule=rs_schedule)
        if gshard.shape != m.shape:
            # JAX fails here too (a broadcast of mismatched shapes): moments
            # restored in another DP size's padded layout (ROADMAP §3)
            raise ValueError(
                f"{k}: moment shard of {chunk} elements against a gradient "
                f"shard of {gshard.shape[0]} at dp={n}: the moments are in "
                "another DP size's padded layout")
        m = b1 * m + (1 - b1) * gshard
        v = b2 * v + (1 - b2) * gshard * gshard
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        # matching param shard
        pflat = p.reshape(-1)
        pshard = F.pad(pflat, (0, chunk * n - pflat.numel()))[
            r * chunk:(r + 1) * chunk].float()
        if cfg.weight_decay and p.dim() >= 2:
            delta = delta + cfg.weight_decay * pshard
        new_shard = pshard - lr * delta
        # all-gather the updated parameter (the param dtype on the wire)
        full = C.ring_all_gather(new_shard.to(p.dtype), axis_name, mesh,
                                 schedule=ag_schedule)
        new_p[k] = full.reshape(-1)[:p.numel()].reshape(p.shape)
        new_m[k], new_v[k] = m, v
    return new_p, {"m": new_m, "v": new_v, "step": step}
