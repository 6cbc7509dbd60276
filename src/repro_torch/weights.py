"""Weights bridge: a JAX parameter pytree (as numpy arrays) -> the port's
model module (``TransformerLM``, ``RwkvLM``, ``MambaLM`` or ``HybridLM``).

The JAX package stacks every layer's parameters along a leading L axis
(for ``lax.scan``): ``layers`` for the transformers, rwkv6 and mamba2,
``mamba`` for the zamba2 backbone (its ``shared`` block is not stacked).
The port keeps one module per layer.  ``from_jax_params`` unstacks that
axis and loads the result by name (``strict=True``), so both packages
compute the same function from the same weights.  It takes numpy arrays,
so this module needs no JAX: ``jax.tree.map(np.asarray, params)`` on the
JAX side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import hybrid, rwkv, ssm
from repro_torch.models.common import ArchCfg
from repro_torch.models.transformer import TransformerLM

# family -> (module class, name of the stacked layer axis)
_LM = {"dense": (TransformerLM, "layers"), "moe": (TransformerLM, "layers"),
       "vlm": (TransformerLM, "layers"), "rwkv6": (rwkv.RwkvLM, "layers"),
       "mamba2": (ssm.MambaLM, "layers"),
       "zamba2": (hybrid.HybridLM, "mamba")}


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


def from_jax_params(cfg: ArchCfg, params, *, device="cuda"):
    """``params``: the JAX ``init_lm`` pytree with numpy leaves.  The model
    lands on the card unless the caller asks for the CPU (``device="cpu"``);
    without a card the default raises, as ``PagedLM`` does."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_jax_params: no CUDA device is available; "
                           "pass device='cpu' to load the model on the CPU")
    if cfg.family not in _LM:
        raise NotImplementedError(f"family {cfg.family!r}: no model module "
                                  "in the port yet")
    cls, stacked = _LM[cfg.family]
    state = {}
    for name, a in _flatten(params):
        t = to_torch(a)
        if name.startswith(stacked + "."):
            if t.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: leading axis {t.shape[0]} != "
                                 f"n_layers {cfg.n_layers}")
            rest = name[len(stacked) + 1:]
            for i in range(cfg.n_layers):
                state[f"{stacked}.{i}.{rest}"] = t[i]
        else:
            state[name] = t
    model = cls(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model
