"""How a cell's weights are drawn on the device from the run's seed.

Each part of the model (a layer, or the embedding with the head and the
final norm) has a generator of its own, seeded from the run's seed and the
part's index, so any one part can be drawn again alone: the program gets
every part once at set-up, and the reference draws each layer again when
it reaches it, after the program has been freed.  Matrices are drawn in
one call a part, in the type they are served in, and scaled in place.

Which parts a model has, their names, shapes and scales, are its layout's
(``layouts/<layout>.py``: ``layer_weights``, ``outer_weights``); this
module is the one seeding rule they all draw by.  A layer's weights are
named ``layers.<i>.<name>`` in the program and in the reference, the
outer weights by their names alone.
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


def generator(seed: int, part: int, device) -> torch.Generator:
    """The generator of part ``part`` of the model, on ``device``."""
    return torch.Generator(device=device).manual_seed(part_seed(seed, part))


def draw(specs: dict, gen, device, dtype) -> dict[str, torch.Tensor]:
    """One draw for all of ``specs`` ({name: (shape, std)}), N(0, std^2),
    cut and scaled in place."""
    n = sum(math.prod(s) for s, _ in specs.values())
    flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, (shape, std) in specs.items():
        k = math.prod(shape)
        out[name] = flat[at:at + k].view(shape).mul_(std)
        at += k
    return out


def split(name: str) -> tuple[int | None, str]:
    """(layer index, name within the layer) of a weight's name; an outer
    weight's index is ``None`` (``layers.3.attn.wq`` -> (3, ``attn.wq``))."""
    if name.startswith("layers."):
        _, i, rest = name.split(".", 2)
        return int(i), rest
    return None, name
