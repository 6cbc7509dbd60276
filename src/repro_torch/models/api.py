"""Uniform model API: family dispatch.

``get_model(cfg)`` returns a ``Model`` facade with the JAX package's five
entry points (``models/api.py``) for the families the port carries: the
decoder-only transformers (dense, moe, vlm), the recurrent ``mamba2`` and
``rwkv6``, and the ``zamba2`` hybrid.  The encoder-decoder family raises
until its slice lands.  The JAX module's ShapeDtypeStruct input specs serve
its dry-run, which the port replaces last (ROADMAP queue item 10).

``init`` takes a ``torch.Generator`` and builds the weights on its device;
``train_loss(p, b, remat=True)`` takes JAX's ``remat`` knob, which the
transformer families read (per-layer ``torch.utils.checkpoint``) and the
recurrent ones accept and leave (their scans have no backward kernel on
the card yet, ROADMAP item 12);
``init_decode_state(batch, max_len, device="cuda")`` builds zero state on
the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import attention, hybrid, rwkv, ssm, transformer
from repro_torch.models.common import ArchCfg

# where each family not ported yet stands in ROADMAP.md
_NOT_PORTED = {
    "encdec": "queue item 9 (encoder-decoder family)",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchCfg
    init: Callable[..., Any]          # (torch.Generator) -> nn.Module
    train_loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]   # (params, token, state, pos)
    init_decode_state: Callable[..., Any]


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
            train_loss=lambda p, b, remat=True: ssm.train_loss(cfg, p, b),
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
            train_loss=lambda p, b, remat=True: rwkv.train_loss(cfg, p, b),
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
            train_loss=lambda p, b, remat=True: hybrid.train_loss(cfg, p, b),
            prefill=lambda p, b, **kw: hybrid.prefill(cfg, p, b, **kw),
            decode_step=lambda p, t, s, pos: hybrid.decode_step(cfg, p, t, s,
                                                                pos),
            init_decode_state=lambda batch, max_len, device="cuda":
                hybrid.init_state(cfg, batch, max_len, device=device),
        )
    if fam in _NOT_PORTED:
        raise NotImplementedError(
            f"family {fam!r} is not ported to PyTorch yet: ROADMAP "
            f"{_NOT_PORTED[fam]}")
    raise ValueError(f"unknown family {fam}")
