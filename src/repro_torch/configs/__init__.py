"""Assigned architecture configs (exact public-literature settings).

``get_config(name)`` returns the full ArchCfg; ``get_reduced(name)`` the
same-family tiny variant used by CPU smoke tests.  ``ALL_ARCHS`` is the
assignment's 10-arch pool.  The config modules are the JAX package's,
copied as data; only the ``ArchCfg`` they build differs (torch dtypes).
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ArchCfg

ALL_ARCHS = [
    "olmoe-1b-7b",
    "moonshot-v1-16b-a3b",
    "starcoder2-3b",
    "qwen2-0_5b",
    "deepseek-7b",
    "smollm-135m",
    "zamba2-1_2b",
    "rwkv6-1_6b",
    "whisper-large-v3",
    "internvl2-76b",
]

# accept both the assignment spelling (dots) and module-safe underscores
_ALIASES = {
    "qwen2-0.5b": "qwen2-0_5b",
    "zamba2-1.2b": "zamba2-1_2b",
    "rwkv6-1.6b": "rwkv6-1_6b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get_config(name: str) -> ArchCfg:
    mod = importlib.import_module(
        f"repro_torch.configs.{canonical(name).replace('-', '_')}")
    return mod.CONFIG


def get_reduced(name: str) -> ArchCfg:
    return get_config(name).reduced()
