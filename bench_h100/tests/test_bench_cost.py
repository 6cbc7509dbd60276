"""The frozen kernel counts equal the program's at the cells' shapes, and
the model-FLOP count a hand count of one layer."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import ROOT
from benchkit import cost, flops, manifest

# (B, H, Hkv, D) of the served models and (page, pages per slot)
SERVED = {"deepseek7b-decode-chat": (40, 32, 32, 128, 16, 256),
          "olmoe-prefill-code": (16, 16, 16, 128, 16, 256)}


@pytest.mark.parametrize("cell", sorted(SERVED))
def test_k1_and_k2_serving_counts_equal_the_programs(cell):
    from repro_torch.kernels import cost as prog
    B, H, Hkv, D, page, pages = SERVED[cell]
    t = manifest.cell(cell, ROOT).traffic
    lens = np.random.default_rng(0).integers(
        t["prompt_tokens"][0], sum(x[1] for x in (t["prompt_tokens"],
                                                  t["output_tokens"])), B)
    assert cost.paged_attention(B, H, Hkv, D, page, pages, lens, 2) == \
        prog.paged_attention(B, H, Hkv, D, page, pages, lens, 2)
    for S in (t["prompt_tokens"][0], t["prompt_tokens"][1], 1040):
        assert cost.flash_attention(1, H, Hkv, S, S, D, True, 2) == \
            prog.flash_attention(1, H, Hkv, S, S, D, True, 2)


@pytest.mark.parametrize("H", [16, 32])
def test_k2_and_k2bwd_training_counts_equal_the_programs(H):
    from repro_torch.kernels import cost as prog
    args = (1, H, H, 4096, 4096, 128, True, 2)
    assert cost.flash_attention(*args) == prog.flash_attention(*args)
    assert cost.flash_attention_bwd(*args) == prog.flash_attention_bwd(*args)
    assert cost.attn_pairs(4096, 4096, True) == 4096 * 4097 // 2


def test_bound_names_the_peak_that_sets_it():
    assert cost.bound_s(989e12, 0) == (1.0, "operations")
    assert cost.bound_s(0, 3.35e12) == (1.0, "bytes")


def _cell(name):
    c = manifest.cell(name, ROOT)
    return c.layout, c.config["model"]


def test_olmoe_layer_by_hand():
    """One OLMoE layer, one token: q, k, v, o (2048 x 2048 each), the
    router (2048 x 64) and 8 experts of three 2048 x 1024 matrices."""
    layout, m = _cell("olmoe-prefill-code")
    per_token = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024
    assert all(layout.layer_matmul_params(m, i) == per_token
               for i in range(16))
    # a 100-token prompt: 16 layers, the head once, 5050 causal pairs
    want = (2 * 100 * 16 * per_token + 2 * 2048 * 50304
            + 4 * 16 * 128 * 5050 * 16)
    assert flops.prefill(layout, m, 100) == want


def test_deepseek_layer_by_hand():
    """One DeepSeek-7B layer, one token: four 4096 x 4096 matrices and
    three 4096 x 11008."""
    layout, m = _cell("deepseek7b-decode-chat")
    per_token = 4 * 4096 * 4096 + 3 * 4096 * 11008
    assert layout.layer_matmul_params(m, 0) == per_token
    # one decode step of two tokens attending 10 and 20 keys
    want = 2 * 2 * (30 * per_token + 4096 * 102400) \
        + 4 * 32 * 128 * 30 * 30
    assert flops.decode(layout, m, [10, 20]) == want
    # training: three times the forward of 4096 tokens
    layout, mt = _cell("deepseek7b-train-4k")
    fwd = 2 * 4096 * (6 * per_token + 4096 * 102400) \
        + 4 * 32 * 128 * (4096 * 4097 // 2) * 6
    assert flops.train_step(layout, mt, 1, 4096) == 3 * fwd
    # the serving cache: K and V of 32 heads of 128 in 30 layers, bf16
    assert layout.cache_bytes_per_token(m, 2) == 2 * 30 * 32 * 128 * 2
