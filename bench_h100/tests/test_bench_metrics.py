"""The readers and the profile reduction on records made by hand."""
from __future__ import annotations

import types

import pytest
import torch

from conftest import ROOT
from benchkit import cell as C, manifest, profile

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, t0, t1, dev=CUDA, annotation=False):
    return types.SimpleNamespace(name=name, device_type=dev,
                                 time_range=types.SimpleNamespace(
                                     start=t0, end=t1),
                                 is_user_annotation=annotation)


def test_reduce_busy_gaps_and_names():
    events = [
        _ev("void (anonymous namespace)::paged_partial_kernel<bf16, 128>(x)",
            0, 10),
        _ev("void at::native::vectorized_elementwise_kernel<4>(y)", 5, 20),
        _ev("bench.decode", 0, 40, dev=CUDA, annotation=True),  # mirrored
        _ev("bench.decode", 0, 40, dev=CPU),
        _ev("bench.step", 0, 100, dev=CPU),
        _ev("Memcpy DtoD (Device -> Device)", 50, 60),
    ]
    tr = profile.reduce(events, 1.0, 1.0001, [])
    assert tr.kernel_s == pytest.approx({"paged_partial_kernel": 10e-6,
                                         "vectorized_elementwise_kernel":
                                         15e-6, "Memcpy DtoD": 10e-6})
    assert tr.busy_s == pytest.approx(30e-6)          # [0, 20] and [50, 60]
    # the gap [20, 50]: its middle lies in both host spans, decode innermost
    assert tr.gaps == pytest.approx({"bench.decode": 30e-6})
    assert tr.launches(("paged_",)) == 1
    assert tr.window_s == pytest.approx(1e-4)


def _record(kind, steps, spans=(), requests=(), trace=None, **kw):
    c = manifest.cell("deepseek7b-decode-chat" if kind == "serve"
                      else "deepseek7b-train-4k", ROOT)
    rec = C.Record(cell=c.name, kind=kind, model=c.config["model"],
                   traffic=c.traffic, layout=c.layout, steps=list(steps),
                   spans=list(spans), requests=list(requests), trace=trace,
                   **kw)
    rec.window = (0.0, 10.0)
    return rec


def test_serving_tails_count_what_falls_in_the_window():
    from benchkit.drive_serve import Req
    reqs = [Req(10, 3, sent=-1.0, times=[0.5, 0.6, 0.9]),     # in
            Req(10, 2, sent=-3.0, times=[-2.0, 0.2]),         # ttft out
            Req(10, 2, sent=9.0, times=[10.5, 10.6])]         # after
    rec = _record("serve", [(0, 10, 7, 0.0, False)], requests=reqs)
    ttft = manifest.reader("ttft_p90_ms", ROOT)(rec)
    assert ttft == pytest.approx(1500.0)
    itl = [0.1, 0.3, 2.2]           # gaps ending in (0, 10]
    import numpy as np
    assert manifest.reader("itl_p95_ms", ROOT)(rec) == pytest.approx(
        float(np.percentile(itl, 95)) * 1e3)
    assert manifest.reader("gen_tokens_per_s", ROOT)(rec) == \
        pytest.approx(0.7)
    assert manifest.reader("train_tokens_per_s", ROOT)(rec) is None


def test_readers_without_a_trace_return_nothing():
    rec = _record("train", [(0, 1, 4096, 0.0, False)])
    for m in ("k2_roofline.train", "k2bwd_roofline.train",
              "elementwise_share.train", "idle_share.train"):
        assert manifest.reader(m, ROOT)(rec) is None
    assert manifest.reader("mfu.train", ROOT)(rec) > 0


def test_profiled_steps_and_stopping_stay_out_of_the_quiet_wall():
    rec = _record("train", [(0, 1, 4096, 0.0, False),
                            (1, 3, 4096, 0.0, True)], excluded_s=2.0)
    assert rec.window_s == pytest.approx(8.0)
    assert rec.quiet_wall == pytest.approx(6.0)
    assert len(rec.quiet_steps()) == 1
