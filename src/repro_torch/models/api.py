"""Uniform model API: family dispatch.

``get_model(cfg)`` returns a ``Model`` facade, as the JAX package's
``models/api.py`` does, for the families this slice of the port carries:
the decoder-only transformers (dense, moe, vlm).  The recurrent and
encoder-decoder families raise until their slice lands.  The JAX module's
ShapeDtypeStruct input specs serve its dry-run, which the port replaces
last (ROADMAP queue item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import transformer
from repro_torch.models.common import ArchCfg

# where each family not ported yet stands in ROADMAP.md
_NOT_PORTED = {
    "mamba2": "queue item 9 (recurrent families) and kernel K3",
    "zamba2": "queue item 9 (recurrent families) and kernel K3",
    "rwkv6": "queue item 9 (recurrent families) and kernel K4",
    "encdec": "queue item 9 (encoder-decoder family)",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchCfg
    init: Callable[..., Any]          # (torch.Generator) -> TransformerLM
    train_loss: Callable[..., Any]
    prefill: Callable[..., Any]


def get_model(cfg: ArchCfg) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return Model(
            cfg=cfg,
            init=lambda gen: transformer.init_lm(cfg, gen),
            train_loss=lambda p, b: transformer.train_loss(cfg, p, b),
            prefill=lambda p, b, **kw: transformer.prefill(cfg, p, b, **kw),
        )
    if fam in _NOT_PORTED:
        raise NotImplementedError(
            f"family {fam!r} is not ported to PyTorch yet: ROADMAP "
            f"{_NOT_PORTED[fam]}")
    raise ValueError(f"unknown family {fam}")
