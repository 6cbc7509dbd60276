"""The check fails what it must: the control (the reference in float8 in
the program's place) and every fault a cell can have, planted under the
harness in the timed path, each come out not correct against the cell's
own limits, while a sound run comes out correct.

The control's readings at the cells' own sizes come from
``bench_h100/control.py`` on the card (``PERF.md`` gives them); here it
runs at a size a test holds."""
from __future__ import annotations

import math

import pytest

from conftest import SEED, small
from benchkit import faults
from benchkit.cell import run_cell

SERVE = ["deepseek7b-decode-chat", "olmoe-prefill-code"]
TRAIN = ["olmoe-train-4k", "deepseek7b-train-4k"]


def fails(readings: dict, limits: dict) -> bool:
    return any(not (math.isfinite(readings[k]) and readings[k] <= v)
               for k, v in limits.items())


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_sound_run_is_correct(cell):
    out = run_cell(cell, SEED, 0.5, False, device="cpu", cell=small(cell))
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in SERVE
                                        for f in faults.SERVE]
                         + [(c, f) for c in TRAIN for f in faults.TRAIN])
def test_planted_fault_is_not_correct(cell, fault):
    kind = "lm" if cell in SERVE else "trainer"
    table = faults.SERVE if cell in SERVE else faults.TRAIN
    # answers of 16 tokens or more: every sampled request lives through
    # a step that the token fault alters
    c = small(cell, traffic=LONGER if cell in SERVE else None)
    out = run_cell(cell, SEED, 0.5, False, device="cpu", cell=c,
                   hooks={kind: [table[fault]]})
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell", TRAIN)
def test_unchanged_state_fails_the_change_gap(cell):
    """A step that drops its update fails the change's gap by itself (the
    reference's leaves move; the program's read no change: a gap of 1)."""
    c = small(cell)
    out = run_cell(cell, SEED, 0.5, False, device="cpu", cell=c,
                   hooks={"trainer": [faults.state_unchanged_train]})
    gap = out["compared"]["change_norm_gap"]
    assert gap["value"] > gap["limit"] and gap["value"] == pytest.approx(1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TRAIN)
def test_unchanged_state_fails_the_change_gap_on_the_card(gpu, cell):
    """As above on the card, where the step's update is the fused AdamW
    kernel pair, in place: the fault drops that update too."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()["fused_adamw"]
    c = small(cell, dtype="bfloat16")
    out = run_cell(cell, SEED, 0.5, False, device=gpu, cell=c,
                   hooks={"trainer": [faults.state_unchanged_train]})
    assert ops.launch_counts()["fused_adamw"] > before
    gap = out["compared"]["change_norm_gap"]
    assert gap["value"] > gap["limit"] and gap["value"] == pytest.approx(1.0)


def _control(cell, device, dtype, rows=None):
    import control
    c = small(cell, dtype=dtype, traffic=rows if cell in TRAIN else LONGER,
              **WIDER)
    return c, control.readings(c, SEED, 3.0, device=device, fault=False)


# the control at a size a test holds: wide enough that float8's rounding
# shows against the cells' limits, small enough for the CPU
WIDER = dict(num_hidden_layers=4, hidden_size=256, head_dim=64,
             intermediate_size=256, vocab_size=2048)
LONGER = dict(output_tokens=[16, 48], check_requests=6)


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_control_is_not_correct(cell):
    c, r = _control(cell, "cpu", "float32")
    limits = c.limits["limits"]
    assert not fails(r["program"], limits), r["program"]
    assert fails(r["control"], limits), r["control"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_control_is_not_correct_on_the_card(gpu, cell):
    """As above, the program in the configuration's bf16 on the card; a
    training row as long as the cell's, since bf16's loss gap over 64
    tokens is wider than the cell's limit, set over 4096."""
    c, r = _control(cell, gpu, "bfloat16", rows={"seq_len": 4096})
    limits = c.limits["limits"]
    assert not fails(r["program"], limits), r["program"]
    assert fails(r["control"], limits), r["control"]
