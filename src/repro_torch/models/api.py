"""Uniform model API: family dispatch.

``get_model(cfg)`` returns a ``Model`` facade with the JAX package's five
entry points (``models/api.py``) for every family: the decoder-only
transformers (dense, moe, vlm), the recurrent ``mamba2`` and ``rwkv6``,
the ``zamba2`` hybrid and the ``encdec`` encoder-decoder (whisper), whose
decode state comes from ``prefill(..., max_len=)`` alone, as in JAX.  The
JAX module's ShapeDtypeStruct input specs serve its dry-run, which the
port replaces last (ROADMAP queue item 10).

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
from typing import Any, Callable

from repro_torch.models import (attention, encdec, hybrid, rwkv, ssm,
                                transformer)
from repro_torch.models.common import ArchCfg


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
