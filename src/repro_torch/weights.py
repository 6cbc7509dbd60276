"""Weights bridge: a JAX parameter pytree (as numpy arrays) -> the port's
model module (``TransformerLM``, ``RwkvLM``, ``MambaLM``, ``HybridLM`` or
``EncDecLM``), and the optimizer state and checkpoint layout back and
forth.

The JAX package stacks every layer's parameters along a leading L axis
(for ``lax.scan``): ``layers`` for the transformers, rwkv6 and mamba2,
``mamba`` for the zamba2 backbone (its ``shared`` block is not stacked),
``enc_layers`` (``n_enc_layers`` deep) and ``dec_layers`` (``n_layers``
deep) for encdec.  The port keeps one module per layer.
``from_jax_params`` unstacks those axes and loads the result by name
(``strict=True``), so both packages compute the same function from the
same weights.  It takes numpy arrays,
so this module needs no JAX: ``jax.tree.map(np.asarray, params)`` on the
JAX side.

The trainer keeps its optimizer state in the JAX pytree's layout, one
tensor per JAX leaf, keyed by the leaf's path (``"layers/attn/wq"``):
``jax_leaves`` names, in ``jax.tree`` order, the port's parameters behind
each leaf (stacked along the layer axis where JAX stacks), so AdamW's
rules that read a leaf's shape (no weight decay below two dimensions, the
ZeRO-1 chunk of a flattened leaf) see JAX's shapes.
``from_jax_opt_state`` turns JAX's ``{"m", "v", "step"}`` (single layout:
the leaves' shapes; apex layout: flat ``(dp * chunk,)`` buffers, of which
a rank keeps its chunk) into that state; ``to_jax_opt_state`` and
``to_jax_params`` go back to JAX's nested trees of numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import encdec, hybrid, rwkv, ssm
from repro_torch.models.common import ArchCfg
from repro_torch.models.transformer import TransformerLM

# family -> (module class, {stacked key: name of the config's depth field})
_DECODER = {"layers": "n_layers"}
_LM = {"dense": (TransformerLM, _DECODER), "moe": (TransformerLM, _DECODER),
       "vlm": (TransformerLM, _DECODER), "rwkv6": (rwkv.RwkvLM, _DECODER),
       "mamba2": (ssm.MambaLM, _DECODER),
       "zamba2": (hybrid.HybridLM, {"mamba": "n_layers"}),
       "encdec": (encdec.EncDecLM, {"enc_layers": "n_enc_layers",
                                    "dec_layers": "n_layers"})}


def to_torch(a) -> torch.Tensor:
    """One numpy array -> a torch tensor of the same dtype, bf16 included.

    ``np.asarray`` of a JAX bf16 array has dtype ``ml_dtypes.bfloat16``,
    which ``torch.from_numpy`` refuses; its bits go across as uint16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a.view(np.uint16))  # copy: the source is read-only
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix: str = "", sep: str = "."):
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + sep, sep)
        else:
            yield name, v


def nest(flat: dict) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out



def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 as ``ml_dtypes``'
    bfloat16, the dtype JAX's arrays convert to."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_jax_params(cfg: ArchCfg, params, *, device="cuda"):
    """``params``: the JAX ``init_lm`` pytree with numpy leaves.  The model
    lands on the card unless the caller asks for the CPU (``device="cpu"``);
    without a card the default raises, as ``PagedLM`` does."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_jax_params: no CUDA device is available; "
                           "pass device='cpu' to load the model on the CPU")
    cls = model_class(cfg)
    depths = stacked_axes(cfg)
    state = {}
    for name, a in _flatten(params):
        t = to_torch(a)
        key, _, rest = name.partition(".")
        if key in depths:
            if t.shape[0] != depths[key]:
                raise ValueError(f"{name}: leading axis {t.shape[0]} != "
                                 f"the {depths[key]} layers of {key}")
            for i in range(depths[key]):
                state[f"{key}.{i}.{rest}"] = t[i]
        else:
            state[name] = t
    model = cls(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model


def model_class(cfg: ArchCfg):
    """The port's model module class of ``cfg``'s family."""
    if cfg.family not in _LM:
        raise NotImplementedError(f"family {cfg.family!r}: no model module "
                                  "in the port yet")
    return _LM[cfg.family][0]


# ----------------------------------------------------------------------------
# the JAX pytree's leaves over the port's parameters
# ----------------------------------------------------------------------------

def stacked_axes(cfg: ArchCfg) -> dict[str, int]:
    """The pytree keys whose leaves JAX stacks along a layer axis, each with
    its depth (JAX's ``sharding.STACKED_KEYS`` for the family)."""
    return {k: getattr(cfg, depth)
            for k, depth in _LM[cfg.family][1].items()}


def is_stacked(cfg: ArchCfg, path: str) -> bool:
    """Whether the JAX leaf at ``path`` is stacked along a layer axis."""
    return path.split("/", 1)[0] in _LM[cfg.family][1]


def jax_leaves(cfg: ArchCfg, model) -> dict[str, list[torch.nn.Parameter]]:
    """The JAX pytree's leaves in ``jax.tree`` order (sorted keys at every
    level): leaf path -> the port's parameters that make it, in layer order
    for a leaf JAX stacks along a layer axis, else the one parameter."""
    groups: dict[str, list] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if is_stacked(cfg, parts[0]):
            key, order = "/".join([parts[0]] + parts[2:]), int(parts[1])
        else:
            key, order = "/".join(parts), 0
        groups.setdefault(key, []).append((order, p))
    return {k: [p for _, p in sorted(groups[k], key=lambda t: t[0])]
            for k in sorted(groups, key=lambda k: tuple(k.split("/")))}


def leaf_tensor(cfg: ArchCfg, path: str, params: list) -> torch.Tensor:
    """One JAX leaf's value from its parameters (a stacked copy for a
    layer-stacked leaf); ``params`` may be the parameters' gradients."""
    if is_stacked(cfg, path):
        return torch.stack(list(params))
    (p,) = params
    return p


def assign_leaf(cfg: ArchCfg, path: str, params: list,
                value: torch.Tensor) -> None:
    """Copy one JAX leaf's value back into its parameters, in place."""
    with torch.no_grad():
        if is_stacked(cfg, path):
            for p, v in zip(params, value.reshape(
                    (len(params),) + params[0].shape)):
                p.copy_(v)
        else:
            params[0].copy_(value.reshape(params[0].shape))


def to_jax_params(cfg: ArchCfg, model) -> dict:
    """The inverse of ``from_jax_params``: JAX's nested parameter tree of
    numpy arrays (layer-stacked leaves stacked)."""
    return nest({path: to_numpy(leaf_tensor(cfg, path, ps))
                  for path, ps in jax_leaves(cfg, model).items()})


def from_jax_opt_state(state, *, dp: int = 1, rank: int = 0,
                       device="cuda") -> dict:
    """JAX's optimizer state ``{"m", "v", "step"}`` (nested trees of numpy
    arrays, or flat dicts keyed by leaf path) -> the port's: ``m`` and
    ``v`` as {leaf path: fp32 tensor}, ``step`` a 0-d int32 tensor.

    ``dp > 1`` reads the apex (ZeRO-1) layout, where every leaf is a flat
    ``(dp * chunk,)`` buffer of which DP rank ``rank`` keeps the chunk
    ``[rank * chunk, (rank + 1) * chunk)`` — the slice ``shard_map`` hands
    that rank.  The default lands on the card, as ``from_jax_params``."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_jax_opt_state: no CUDA device is available; "
                           "pass device='cpu'")

    def leaves(tree):
        tree = dict(_flatten(tree, sep="/"))
        out = {}
        for path, a in tree.items():
            t = to_torch(a).to(device=device, dtype=torch.float32)
            if dp > 1:
                if t.dim() != 1 or t.numel() % dp:
                    raise ValueError(f"{path}: apex moments are flat "
                                     f"(dp * chunk,) buffers, got "
                                     f"{tuple(t.shape)} for dp={dp}")
                chunk = t.numel() // dp
                t = t[rank * chunk:(rank + 1) * chunk].clone()
            out[path] = t
        return out

    return {"m": leaves(state["m"]), "v": leaves(state["v"]),
            "step": torch.as_tensor(np.asarray(state["step"]),
                                    dtype=torch.int32).to(device)}


def to_jax_opt_state(state) -> dict:
    """The port's optimizer state -> JAX's nested ``{"m", "v", "step"}`` of
    numpy arrays.  Apex moments must be gathered to the global
    ``(dp * chunk,)`` layout first (``Trainer`` does so for checkpoints)."""
    return {"m": nest({k: to_numpy(v) for k, v in state["m"].items()}),
            "v": nest({k: to_numpy(v) for k, v in state["v"].items()}),
            "step": np.asarray(to_numpy(state["step"]), np.int32)}
