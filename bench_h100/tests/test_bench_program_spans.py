"""The readers of the program's own spans: window and slice filtering on
hubs made by hand, the drop rule, and traced runs of small cells."""
from __future__ import annotations

import types

import pytest
import torch

from conftest import ROOT, SEED, small
from benchkit import cell as C, manifest, program_spans
from repro_torch.core.fabric import Telemetry

SERVE = ("deepseek7b-decode-chat", "olmoe-prefill-code")
HOST = ("queue_wait_p90_ms.serve", "decode_launch_ms.serve")


def _read(name, rec):
    return manifest.reader(name, ROOT)(rec)


def _record(kind="serve", trace=None):
    c = manifest.cell(SERVE[1] if kind == "serve" else "olmoe-train-4k",
                      ROOT)
    rec = C.Record(cell=c.name, kind=kind, model=c.config["model"],
                   traffic=c.traffic, trace=trace)
    rec.window = (10.0, 20.0)
    return rec


@pytest.fixture
def hub(monkeypatch):
    h = Telemetry(ring=64)
    monkeypatch.setattr(program_spans, "hub", lambda: h)
    return h


def test_window_and_slice_filtering(hub):
    for t0 in (9.0, 11.0, 12.0, 14.5, 19.0, 21.0):   # 14.5: in the slice
        hub.record_span(("engine",), "decode.layers", t0, t0 + 0.5)
    hub.record_span(("engine",), "decode", 11.0, 11.6)   # another name
    rec = _record(trace=types.SimpleNamespace(t0=14.0, t1=15.0))
    got = program_spans.quiet(rec, "decode.layers")
    assert [s[0] for s in got] == [11.0, 12.0, 19.0]
    assert all(s[1] - s[0] == 0.5 and "id" in s[2] for s in got)
    assert _read("decode_launch_ms.serve", rec) == pytest.approx(500.0)
    # a wait that ends in the window counts by its end
    hub.record_span(("engine", "queue"), "engine.queued", 9.5, 10.5)
    assert [s[0] for s in program_spans.quiet(rec, "engine.queued",
                                              at="end")] == [9.5]
    assert program_spans.quiet(rec, "engine.queued") == []


def test_queue_wait_p90(hub):
    waits = [0.01 * (i + 1) for i in range(10)]        # 10 .. 100 ms
    for i, w in enumerate(waits):
        end = 11.0 + 0.5 * i
        hub.record_span(("engine", "queue"), "engine.queued", end - w, end,
                        rid=i)
    hub.record_span(("engine", "queue"), "engine.queued", 5.0, 9.0, rid=99)
    v = _read("queue_wait_p90_ms.serve", _record())
    assert v == pytest.approx(91.0)        # numpy's linear 90th: 91 ms


def test_moe_slot_use_and_update_ms(hub):
    hub.record_span(("engine",), "engine.prefill", 11.0, 11.1,
                    moe_rows=16, moe_slots=128)
    hub.record_span(("engine",), "decode.layers", 12.0, 12.1,
                    moe_rows=8, moe_slots=64)
    hub.record_span(("engine",), "decode.layers", 30.0, 30.1,
                    moe_rows=8, moe_slots=8)           # after the window
    assert _read("moe_slot_use.serve", _record()) == pytest.approx(12.5)
    hub.record_span(("train",), "train.update", 11.0, 11.2)
    assert _read("update_ms.train", _record("train")) is None   # no dev_s
    hub.record_span(("train",), "train.update", 12.0, 12.2, dev_s=0.1)
    hub.record_span(("train",), "train.update", 13.0, 13.2, dev_s=0.2)
    assert _read("update_ms.train", _record("train")) == \
        pytest.approx(150.0)


def test_nothing_to_read_after_a_drop_in_the_window(hub):
    for i in range(64):                      # fills the ring before 10 s
        hub.record_span(("engine",), "decode.layers", i * 0.1, i * 0.1 + .05)
    rec = _record()
    assert program_spans.quiet(rec, "decode.layers") == []   # not dropped
    hub.record_span(("engine",), "decode.layers", 11.0, 11.05)
    assert hub.dropped == 1                  # the drop ended before 10 s
    assert len(program_spans.quiet(rec, "decode.layers")) == 1
    for i in range(64):                      # now drops reach the window
        hub.record_span(("engine",), "decode.layers", 12.0 + i * 0.1,
                        12.05 + i * 0.1)
    assert program_spans.quiet(rec, "decode.layers") is None
    assert _read("decode_launch_ms.serve", rec) is None


def test_a_program_without_the_hub_gives_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "hub", lambda: None)
    for name in HOST + ("moe_slot_use.serve", "update_ms.train"):
        assert _read(name, _record()) is None


@pytest.mark.parametrize("name", SERVE + ("olmoe-train-4k",))
def test_traced_cpu_run_reports_the_host_metrics(name, monkeypatch):
    """A traced run on the CPU (the slice's synchronisation a no-op):
    the serving cells read the spans, training's device time is
    absent."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    out = C.run_cell(name, SEED, 2.0, True, device="cpu",
                     cell=small(name, traffic={"profile_steps": 2}))
    m = out["metrics"]
    assert out["correct"]
    if name in SERVE:
        assert set(HOST) <= set(m)
        assert m["decode_launch_ms.serve"]["value"] \
            <= m["decode_step_ms.serve"]["value"]
        assert m["queue_wait_p90_ms.serve"]["value"] > 0
        # the small olmoe: 4 experts, top-2, every expert over every token
        assert ("moe_slot_use.serve" in m) == (name == SERVE[1])
        if name == SERVE[1]:
            assert m["moe_slot_use.serve"]["value"] == pytest.approx(50.0)
    else:
        assert "update_ms.train" not in m
        assert not set(HOST) & set(m)
