"""Weights bridge: a JAX parameter pytree (as numpy arrays) -> TransformerLM.

The JAX package stacks every layer's parameters along a leading L axis
(for ``lax.scan``); the port keeps one module per layer.  ``from_jax_params``
unstacks that axis and loads the result by name, so both packages compute
the same function from the same weights.  It takes numpy arrays, so this
module needs no JAX: ``jax.tree.map(np.asarray, params)`` on the JAX side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ArchCfg
from repro_torch.models.transformer import TransformerLM


def to_torch(a) -> torch.Tensor:
    """One numpy array -> a torch tensor of the same dtype, bf16 included.

    ``np.asarray`` of a JAX bf16 array has dtype ``ml_dtypes.bfloat16``,
    which ``torch.from_numpy`` refuses; its bits go across as uint16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a.view(np.uint16))  # copy: the source is read-only
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def from_jax_params(cfg: ArchCfg, params, *,
                    device="cpu") -> TransformerLM:
    """``params``: the JAX ``init_lm`` pytree with numpy leaves."""
    state = {}
    for name, a in _flatten(params):
        t = to_torch(a)
        if name.startswith("layers."):
            if t.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: leading axis {t.shape[0]} != "
                                 f"n_layers {cfg.n_layers}")
            rest = name[len("layers."):]
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{rest}"] = t[i]
        else:
            state[name] = t
    model = TransformerLM(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model
