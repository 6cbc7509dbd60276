"""Shared set-up of the benchmark's tests: the harness and the program on
``sys.path``, the ``gpu`` fixture, and small copies of the cells.

Run from the root of the checkout: ``python -m pytest bench_h100/tests``
(the card's tests, marked ``gpu``, skip without one)."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchkit import manifest  # noqa: E402

SEED = 2**31 + 11         # larger than 32 signed bits, as the driver's are


@pytest.fixture
def gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small(name: str, root=ROOT, dtype="float32", traffic=None,
          **sizes) -> manifest.Cell:
    """Cell ``name`` at a size a CPU test holds: every width cut (or as
    ``sizes`` say), two layers, few and short requests or rows (or as
    ``traffic`` says); its limits as the cell states them."""
    c = copy.deepcopy(manifest.cell(name, root))
    m = c.config["model"]
    m.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, head_dim=16, intermediate_size=32,
             vocab_size=256)
    m.update(sizes)
    if "num_experts" in m:
        m.update(num_experts=4, num_experts_per_tok=2)
    c.config["dtype"] = dtype
    t = c.traffic
    if t["mode"] == "serve":
        for k in ("prompt_lognormal", "output_lognormal", "pool_pages"):
            t.pop(k, None)             # uniform lengths, a pool per slot
        t.update(clients=4, max_batch=4, prompt_tokens=[16, 48],
                 output_tokens=[4, 12], warm_steps=4, check_requests=3)
    else:
        t.update(seq_len=64)
    t.update(traffic or {})
    return c


@pytest.fixture
def small_cell():
    return small
