"""The weights of a cell, drawn on the device from the run's seed.

Each part of the model (a layer, or the embedding with the head and the
final norm) has a generator of its own, seeded from the run's seed and the
part's index, so any one part can be drawn again alone: the program gets
every part once at set-up, and the reference draws each layer again when
it reaches it, after the program has been freed.  Matrices are drawn in
one call a part, in the type they are served in, and scaled in place:
N(0, 1/fan_in) for the layer's matrices and the head, N(0, 0.02^2) for
the token embedding and the fp32 router; norm gains are 1.

Names follow the usual decoder layout (``attn.wq``, ``mlp.w_gate``,
``moe.router``, ``ln1.scale``; ``embed.tok``, ``embed.head``,
``final_norm.scale``); a matrix is stored (in, out), so ``x @ w``.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
_MASK = (1 << 63) - 1


def part_seed(seed: int, part: int) -> int:
    """A 63-bit generator seed for one part of the model."""
    return (int(seed) * 0x9E3779B97F4A7C15 + (part + 1) * 0xBF58476D1CE4E5B9
            ) & _MASK


def _gen(seed: int, part: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(part_seed(seed, part))


def layer_matrices(m: dict) -> dict[str, tuple[tuple[int, ...], int]]:
    """{name: (shape, fan_in)} of one layer's matrices in the served type."""
    d, H, Hkv = m["hidden_size"], m["num_attention_heads"], \
        m["num_key_value_heads"]
    hd = m.get("head_dim") or d // H
    f = m["intermediate_size"]
    out = {"attn.wq": ((d, H * hd), d), "attn.wk": ((d, Hkv * hd), d),
           "attn.wv": ((d, Hkv * hd), d), "attn.wo": ((H * hd, d), H * hd)}
    if m.get("num_experts"):
        E = m["num_experts"]
        out.update({"moe.w_gate": ((E, d, f), d), "moe.w_up": ((E, d, f), d),
                    "moe.w_down": ((E, f, d), f)})
    else:
        out.update({"mlp.w_gate": ((d, f), d), "mlp.w_up": ((d, f), d),
                    "mlp.w_down": ((f, d), f)})
    return out


def _draw(specs: dict, gen, device, dtype) -> dict[str, torch.Tensor]:
    """One draw for all of ``specs`` ({name: (shape, std)}), cut and
    scaled in place."""
    n = sum(math.prod(s) for s, _ in specs.values())
    flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, (shape, std) in specs.items():
        k = math.prod(shape)
        out[name] = flat[at:at + k].view(shape).mul_(std)
        at += k
    return out


def layer(m: dict, seed: int, i: int, device, dtype) -> dict[str, torch.Tensor]:
    """Layer ``i``'s weights: its matrices in ``dtype``, an MoE layer's
    router in fp32, its two norm gains."""
    gen = _gen(seed, i, device)
    mats = {k: (s, fan ** -0.5) for k, (s, fan) in layer_matrices(m).items()}
    out = _draw(mats, gen, device, dtype)
    if m.get("num_experts"):
        out.update(_draw({"moe.router": ((m["hidden_size"],
                                          m["num_experts"]), 0.02)},
                         gen, device, torch.float32))
    d = m["hidden_size"]
    out["ln1.scale"] = torch.ones(d, dtype=dtype, device=device)
    out["ln2.scale"] = torch.ones(d, dtype=dtype, device=device)
    return out


def outer(m: dict, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    """The token embedding, the untied head and the final norm's gain."""
    d, V = m["hidden_size"], m["vocab_size"]
    gen = _gen(seed, m["num_hidden_layers"], device)
    out = _draw({"embed.tok": ((V, d), 0.02), "embed.head": ((d, V),
                                                             d ** -0.5)},
                gen, device, dtype)
    out["final_norm.scale"] = torch.ones(d, dtype=dtype, device=device)
    return out


def leaf_of(name: str) -> str:
    """The optimizer's leaf a weight belongs to: a layer's weights are
    stacked over the layers (``layers.3.attn.wq`` -> ``layers/attn/wq``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = ["layers"] + parts[2:]
    return "/".join(parts)
