"""Uniform model API: family dispatch and meta-tensor input specs.

``get_model(cfg)`` returns a ``Model`` facade with the JAX package's five
entry points (``models/api.py``) for every family: the decoder-only
transformers (dense, moe, vlm), the recurrent ``mamba2`` and ``rwkv6``,
the ``zamba2`` hybrid and the ``encdec`` encoder-decoder (whisper), whose
decode state comes from ``prefill(..., max_len=)`` alone, as in JAX.
``input_specs(cfg, shape)`` builds each input-shape family's arguments as
meta tensors (shape and dtype, no memory) where JAX has
ShapeDtypeStructs: what the dry run (``launch/dryrun.py``) traces.

``init`` takes a ``torch.Generator`` and builds the weights on its device;
``train_loss(p, b, remat=True)`` takes JAX's ``remat`` knob, which every
family reads (per-layer ``torch.utils.checkpoint``; zamba2 recomputes its
mamba layers and not its shared block, as JAX does);
``init_decode_state(batch, max_len, device="cuda")`` builds zero state on
the card unless the caller asks for the CPU (encdec raises ``TypeError``).
``param_shapes(cfg)`` gives the JAX pytree's keys and leaf shapes (layer-
stacked where JAX stacks) as meta tensors, which hold no memory: the
sharding rules (``parallel/sharding.py``) read them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models import (attention, encdec, hybrid, rwkv, ssm,
                                transformer)
from repro_torch.models.common import ArchCfg
from repro_torch.parallel import sharding


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# the assigned LM shape set (applies to every arch; long_500k is gated on
# cfg.full_attention)
SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
    # reduced variants for smoke tests
    "smoke_train": ShapeCfg("smoke_train", 16, 2, "train"),
    "smoke_prefill": ShapeCfg("smoke_prefill", 16, 2, "prefill"),
    "smoke_decode": ShapeCfg("smoke_decode", 16, 2, "decode"),
}

# the index dtype the port's entry points take token ids in
TOKEN_DTYPE = torch.int64


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchCfg
    init: Callable[..., Any]          # (torch.Generator) -> nn.Module
    train_loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]   # (params, token, state, pos)
    init_decode_state: Callable[..., Any]


def _state_from_prefill(*args, **kwargs):
    """encdec has no zero decode state: its cross-attention K/V are the
    encoder's output, which only ``prefill`` computes."""
    raise TypeError("encdec: the decode state comes from "
                    "prefill(params, batch, max_len=...), which encodes the "
                    "frames; there is no init_decode_state")


def get_model(cfg: ArchCfg) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return Model(
            cfg=cfg,
            init=lambda gen: transformer.init_lm(cfg, gen),
            train_loss=lambda p, b, **kw: transformer.train_loss(cfg, p, b,
                                                                 **kw),
            prefill=lambda p, b, **kw: transformer.prefill(cfg, p, b, **kw),
            decode_step=lambda p, t, s, pos: transformer.decode_step(
                cfg, p, t, s, pos),
            init_decode_state=lambda batch, max_len, device="cuda":
                attention.init_kv_cache(cfg, batch, max_len,
                                        layers=cfg.n_layers, device=device),
        )
    if fam == "mamba2":
        return Model(
            cfg=cfg,
            init=lambda gen: ssm.init_lm(cfg, gen),
            train_loss=lambda p, b, remat=True: ssm.train_loss(
                cfg, p, b, remat=remat),
            prefill=lambda p, b: ssm.prefill(cfg, p, b),
            decode_step=lambda p, t, s, pos: ssm.decode_step(cfg, p, t, s,
                                                             pos),
            init_decode_state=lambda batch, max_len, device="cuda":
                ssm.init_mamba_state(cfg, batch, layers=cfg.n_layers,
                                     device=device),
        )
    if fam == "rwkv6":
        return Model(
            cfg=cfg,
            init=lambda gen: rwkv.init_lm(cfg, gen),
            train_loss=lambda p, b, remat=True: rwkv.train_loss(
                cfg, p, b, remat=remat),
            prefill=lambda p, b: rwkv.prefill(cfg, p, b),
            decode_step=lambda p, t, s, pos: rwkv.decode_step(cfg, p, t, s,
                                                              pos),
            init_decode_state=lambda batch, max_len, device="cuda":
                rwkv.init_state(cfg, batch, layers=cfg.n_layers,
                                device=device),
        )
    if fam == "zamba2":
        return Model(
            cfg=cfg,
            init=lambda gen: hybrid.init_lm(cfg, gen),
            train_loss=lambda p, b, remat=True: hybrid.train_loss(
                cfg, p, b, remat=remat),
            prefill=lambda p, b, **kw: hybrid.prefill(cfg, p, b, **kw),
            decode_step=lambda p, t, s, pos: hybrid.decode_step(cfg, p, t, s,
                                                                pos),
            init_decode_state=lambda batch, max_len, device="cuda":
                hybrid.init_state(cfg, batch, max_len, device=device),
        )
    if fam == "encdec":
        return Model(
            cfg=cfg,
            init=lambda gen: encdec.init_lm(cfg, gen),
            train_loss=lambda p, b, **kw: encdec.train_loss(cfg, p, b, **kw),
            prefill=lambda p, b, **kw: encdec.prefill(cfg, p, b, **kw),
            decode_step=lambda p, t, s, pos: encdec.decode_step(cfg, p, t, s,
                                                                pos),
            init_decode_state=_state_from_prefill,
        )
    raise ValueError(f"unknown family {fam}")


def param_shapes(cfg: ArchCfg) -> dict:
    """The JAX ``init`` pytree's nested keys with one meta tensor (shape and
    dtype, no memory) per leaf, stacked along the layer axis where JAX
    stacks: the model is built on the ``meta`` device."""
    from repro_torch import weights
    model = weights.model_class(cfg)(cfg, device="meta")
    return weights.nest({path: weights.leaf_tensor(cfg, path, ps).detach()
                         for path, ps in weights.jax_leaves(cfg,
                                                            model).items()})


# ----------------------------------------------------------------------------
# input specs (meta tensors: shape and dtype, no memory)
# ----------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchCfg, shape: ShapeCfg) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), TOKEN_DTYPE),
             "labels": _meta((B, S), TOKEN_DTYPE)}
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, cfg.n_frames, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = _meta((B, cfg.n_patches, cfg.d_model),
                                       cfg.dtype)
    return batch


def prefill_input_specs(cfg: ArchCfg, shape: ShapeCfg) -> dict:
    batch = train_input_specs(cfg, shape)
    del batch["labels"]
    return batch


def decode_input_specs(cfg: ArchCfg, shape: ShapeCfg) -> dict:
    """Specs for decode: one new token against a seq_len-deep state, from
    the family's own ``init_decode_state`` on meta, or for encdec (whose
    state holds the cross-attention K/V) from ``prefill`` on meta — JAX
    derives both with ``eval_shape``."""
    B, S = shape.global_batch, shape.seq_len
    model = get_model(cfg)
    if cfg.family == "encdec":
        from repro_torch import weights
        params = weights.model_class(cfg)(cfg, device="meta")
        with torch.no_grad():
            state = model.prefill(params, prefill_input_specs(cfg, shape),
                                  max_len=S, remat=False)[1]
    else:
        state = model.init_decode_state(B, S, device="meta")
    return {"token": _meta((B, 1), TOKEN_DTYPE), "state": state,
            "pos": _meta((), TOKEN_DTYPE)}


def input_specs(cfg: ArchCfg, shape_name: str) -> tuple[ShapeCfg, dict]:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return shape, train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return shape, prefill_input_specs(cfg, shape)
    return shape, decode_input_specs(cfg, shape)


def applicable_shapes(cfg: ArchCfg) -> list[str]:
    """The assigned shape cells for this arch (long_500k gated)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if not cfg.full_attention:
        out.append("long_500k")
    return out


def param_count(cfg: ArchCfg) -> int:
    return sum(math.prod(x.shape)
               for x in sharding.flatten(param_shapes(cfg)).values())


def active_param_count(cfg: ArchCfg) -> int:
    """MoE: params touched per token (top_k of n_experts); else = total."""
    leaves = sharding.flatten(param_shapes(cfg))
    total = sum(math.prod(x.shape) for x in leaves.values())
    if cfg.moe is None:
        return total
    m = cfg.moe
    expert = sum(math.prod(x.shape) for path, x in leaves.items()
                 if "moe" in path.split("/")
                 and path.split("/")[-1] in ("w_gate", "w_up", "w_down"))
    # expert tensors carry the E axis; active fraction = top_k / n_experts
    return total - expert + int(expert * m.top_k / m.n_experts)
