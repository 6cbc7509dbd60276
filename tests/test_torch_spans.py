"""Wall-clock spans and counters of the port's hot path, on the process
telemetry hub: the engine's admission, queue and prefills, the decode
step's four parts, the MoE dispatch's rows and slots, the trainer's
phases, and their ranges on the profiler's timeline."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core.fabric import (Telemetry, process_hub,  # noqa: E402
                                     validate_perfetto)
from repro_torch.core.fabric import telemetry as telemetry_mod  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.serving.engine import Engine, PagedLM, Request  # noqa: E402

torch.set_num_threads(1)

PAGE = 8


def _new_events(hub, n0):
    """The events recorded since the hub had counted ``n0``."""
    n = hub.n_events - n0
    assert n <= len(hub.events)            # nothing of them dropped
    return [(ts, track, name, dur, dict(args))
            for ts, track, name, dur, args in list(hub.events)[-n:]] \
        if n else []


def _by_name(events, name):
    return [e for e in events if e[2] == name]


def _within(child, parent):
    return (parent[0] <= child[0]
            and child[0] + child[3] <= parent[0] + parent[3])


def _serve(arch="qwen2-0.5b", n_requests=5, max_batch=2):
    cfg = configs.get_config(arch).reduced()
    params = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    lm = PagedLM(cfg, params, max_batch=max_batch, max_seq=48,
                 page_tokens=PAGE, device="cpu")
    eng = Engine(lm)
    rng = np.random.default_rng(0)
    for rid in range(n_requests):
        n = int(rng.integers(3, 20))
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, size=(n,)).astype(np.int32), max_new_tokens=4))
    hub = process_hub()
    n0 = hub.n_events
    eng.run_to_completion()
    return cfg, eng, _new_events(hub, n0)


def test_span_ids_parents_and_record_span():
    hub = Telemetry()
    with hub.span(("t",), "outer", a=1) as outer:
        with hub.span(("t",), "inner") as inner:
            inner.set(n=3)
        sid = hub.record_span(("q",), "wait", 1.0, 2.5, rid=7)
    ev = {name: (ts, dur, dict(args)) for ts, _, name, dur, args
          in hub.events}
    assert ev["inner"][2] == {"id": inner.id, "parent": outer.id, "n": 3}
    assert ev["outer"][2] == {"id": outer.id, "a": 1}       # no parent
    assert ev["wait"] == (1.0, 1.5, {"id": sid, "rid": 7})
    assert len({outer.id, inner.id, sid}) == 3
    assert _within((*ev["inner"][:1], None, None, ev["inner"][1]),
                   (*ev["outer"][:1], None, None, ev["outer"][1]))
    # another hub's open span is not this one's parent
    other = Telemetry()
    with hub.span(("t",), "a") as a, other.span(("t",), "b"):
        with hub.span(("t",), "c") as c:
            pass
    assert c.parent == a.id


def test_annotate_and_span_summary_self_time():
    hub = Telemetry()
    hub.record_span(("t",), "step", 0.0, 1.0)
    sid = hub.record_span(("t",), "child", 0.1, 0.4, parent=1)
    hub.record_span(("t",), "child", 0.5, 0.6, parent=1)
    span = type("S", (), {"id": sid})()
    assert hub.annotate(span, dev_s=0.25)
    assert dict(hub.events[1][4])["dev_s"] == 0.25
    assert not hub.annotate(type("S", (), {"id": 99})(), dev_s=1.0)
    lines = hub.span_summary().splitlines()
    step = next(x for x in lines if x.split()[0] == "step").split()
    child = next(x for x in lines if x.split()[0] == "child").split()
    assert step[1:] == ["1", "1000.000", "600.000"]   # 1 s less 0.3 + 0.1
    assert child[1:] == ["2", "400.000", "400.000"]


def test_process_hub_exports_on_the_host_clock():
    _, _, evs = _serve(n_requests=2)
    hub = process_hub()
    obj = json.loads(hub.to_perfetto())
    assert validate_perfetto(obj) == []
    names = {e["name"] for e in obj["traceEvents"] if e["ph"] == "X"}
    assert {"engine.step", "decode.layers", "engine.queued"} <= names
    assert process_hub() is hub


def test_engine_queued_and_prefill_pairs_share_each_rid():
    _, eng, evs = _serve()
    queued = {e[4]["rid"]: e for e in _by_name(evs, "engine.queued")}
    prefill = {e[4]["rid"]: e for e in _by_name(evs, "engine.prefill")}
    assert set(queued) == set(prefill) == set(range(5))
    for rid, q in queued.items():
        p = prefill[rid]
        assert q[0] + q[3] <= p[0]             # the wait ends, then prefill
        assert "parent" not in q[4]            # a wait spans engine steps
        n = len(next(r for r in eng.finished if r.rid == rid).prompt)
        assert p[4]["prompt"] == n and p[4]["padded"] == -(-n // PAGE) * PAGE
    # each prefill is a child of an admission, itself a child of a step
    ids = {e[4]["id"]: e for e in evs}
    for p in prefill.values():
        admit = ids[p[4]["parent"]]
        assert admit[2] == "engine.admit" and _within(p, admit)
        assert ids[admit[4]["parent"]][2] == "engine.step"
    steps = _by_name(evs, "engine.step")
    assert len(steps) == eng.steps
    assert sum(e[4]["admitted"] for e in steps) == 5


def test_decode_children_nest_inside_decode():
    _, eng, evs = _serve()
    decodes = _by_name(evs, "decode")
    assert len(decodes) == eng.steps
    ids = {e[4]["id"]: e for e in evs}
    kids = {}
    for e in evs:
        if e[2].startswith("decode."):
            parent = ids[e[4]["parent"]]
            assert parent[2] == "decode" and _within(e, parent)
            kids.setdefault(parent[4]["id"], []).append(e[2])
    assert all(v == ["decode.inputs", "decode.layers", "decode.head",
                     "decode.wait"] for v in kids.values())
    assert len(kids) == len(decodes)
    for d in decodes:
        assert ids[d[4]["parent"]][2] == "engine.step"
        assert 1 <= d[4]["batch"] <= 2


def test_moe_counts_of_a_dropless_forward():
    cfg = configs.get_config("olmoe-1b-7b").reduced()
    m = cfg.moe
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    hub = process_hub()
    B, S = 2, 5
    T = B * S
    x = torch.randn(B, S, cfg.d_model, dtype=cfg.dtype)
    for dropless, slots in ((True, m.n_experts * T),
                            (False, m.n_experts * moe.capacity(cfg, T))):
        rows0, slots0 = hub.value("moe.rows"), hub.value("moe.slots")
        moe.apply_moe(cfg, p, x, dropless=dropless)
        assert hub.value("moe.rows") - rows0 == T * m.top_k
        assert hub.value("moe.slots") - slots0 == slots


def test_model_step_spans_carry_their_moe_deltas():
    cfg, eng, evs = _serve("olmoe-1b-7b", n_requests=3)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    for p in _by_name(evs, "engine.prefill"):
        T = p[4]["padded"]                     # one padded prompt
        assert (p[4]["moe_rows"], p[4]["moe_slots"]) == \
            (T * K * cfg.n_layers, E * T * cfg.n_layers)
    for d in _by_name(evs, "decode.layers"):
        T = eng.lm.max_batch                   # every slot, one token
        assert (d[4]["moe_rows"], d[4]["moe_slots"]) == \
            (T * K * cfg.n_layers, E * T * cfg.n_layers)


def _trainer(tmp_path, **kw):
    cfg = configs.get_config("smollm-135m").reduced()
    return Trainer(cfg, TrainerConfig(
        ckpt_dir=str(tmp_path / "ck"), ckpt_every=0, batch=2, seq_len=16,
        comm="single", opt=AdamWConfig(lr=1e-3, warmup_steps=0,
                                       total_steps=10), **kw), device="cpu")


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_trainer_tree_per_step(tmp_path, grad_accum):
    tr = _trainer(tmp_path, grad_accum=grad_accum)
    hub = process_hub()
    n0 = hub.n_events
    tr.train(3)
    evs = _new_events(hub, n0)
    steps = _by_name(evs, "train.step")
    assert len(steps) == 3
    for s in steps:
        kids = [e for e in evs if e[4].get("parent") == s[4]["id"]]
        assert [e[2] for e in kids] == ["train.data", "train.fwd_bwd",
                                        "train.update", "train.wait"]
        assert all(_within(e, s) for e in kids)
        assert all("dev_s" not in e[4] for e in kids)    # no card here
    assert len(tr._step_times) == 3 and tr._step_times.maxlen == 20


def test_spans_are_profiler_ranges_with_their_nesting():
    from torch.profiler import ProfilerActivity, profile
    cfg = configs.get_config("qwen2-0.5b").reduced()
    params = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    lm = PagedLM(cfg, params, max_batch=2, max_seq=48, page_tokens=PAGE,
                 device="cpu")
    eng = Engine(lm)
    eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                       max_new_tokens=3))
    hub = process_hub()
    n0 = hub.n_events
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_to_completion()
    evs = _new_events(hub, n0)
    ranges = [e for e in prof.events()
              if e.name.startswith(("engine.", "decode"))]
    names = sorted(e.name for e in ranges)
    assert names == sorted(e[2] for e in evs if e[2] != "engine.queued")

    def inside(a, b):
        return (b.time_range.start <= a.time_range.start
                and a.time_range.end <= b.time_range.end)
    ids = {e[4]["id"]: e for e in evs}
    for name, parent in (("decode.layers", "decode"),
                         ("decode.wait", "decode"),
                         ("decode", "engine.step"),
                         ("engine.prefill", "engine.admit"),
                         ("engine.admit", "engine.step")):
        kids = [r for r in ranges if r.name == name]
        outer = [r for r in ranges if r.name == parent]
        assert kids and all(any(inside(k, o) for o in outer) for k in kids)
        assert all(ids[e[4]["parent"]][2] == parent
                   for e in evs if e[2] == name)


def test_no_record_function_while_the_profiler_is_off(monkeypatch):
    opened = []
    prof = telemetry_mod.sys.modules["torch.autograd.profiler"]
    real = prof.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(prof, "record_function", counting)
    _serve(n_requests=2)
    assert opened == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with process_hub().span(("t",), "probe"):
            pass
    assert opened == ["probe"]


def test_trainer_spans_are_profiler_ranges(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tr = _trainer(tmp_path)
    hub = process_hub()
    n0 = hub.n_events
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train(1)
    evs = _new_events(hub, n0)
    ranges = {e.name: e for e in prof.events() if e.name.startswith("train.")}
    assert sorted(ranges) == sorted(e[2] for e in evs)
    step = ranges["train.step"].time_range
    for name in ("train.data", "train.fwd_bwd", "train.update", "train.wait"):
        r = ranges[name].time_range
        assert step.start <= r.start and r.end <= step.end
