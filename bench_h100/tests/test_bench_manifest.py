"""``BENCHMARK.json`` against the benchmark's contract, and each file it
names."""
from __future__ import annotations

import json
import re

import pytest

from conftest import HERE, ROOT
from benchkit import manifest

BENCH = manifest.load(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden_size|intermediate_size|_dim$|_rank$|latent|"
                   r"state_size|proj|expan|experts_per_tok)")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert BENCH["command"][1] == "bench_h100/run.py"
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_a_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    every = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for x in every:
        assert NAME.match(x["name"]), x["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[kind]]
        assert len(names) == len(set(names))
    for text in [w["why"] for w in BENCH["workloads"] + BENCH["configs"]] \
            + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = manifest.cell(cell, ROOT)
    assert c.traffic["mode"] in ("serve", "train")
    assert (HERE / "benchkit" / f"drive_{c.traffic['mode']}.py").is_file()
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"], ROOT))
    assert c.limits["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_its_layers_move(cell):
    c = manifest.cell(cell, ROOT)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_every_config_is_used_and_every_pair_once():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cuts(conf):
    d = json.loads((ROOT / conf["file"]).read_text())
    assert d["name"] == conf["name"] and d["source"] == conf["source"]
    assert sorted(d["reduced"]) == sorted(conf["reduced"])
    assert set(d["published"]) == set(conf["reduced"])
    for k in conf["reduced"]:
        assert not WIDTH.search(k), k
        assert d["model"][k] != d["published"][k]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_what_the_program_runs(conf):
    """The file's sizes become the program's config whole; at full depth
    they are the program's own registry entry, but for what the file
    states it changed."""
    from repro_torch.configs import get_config
    d = json.loads((ROOT / conf["file"]).read_text())
    cfg = manifest.layout(d["layout"], ROOT).arch(d)
    reg = get_config(d["port_config"])
    m = d["model"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab) == (
        m["num_hidden_layers"], m["hidden_size"], m["num_attention_heads"],
        m["num_key_value_heads"], m["head_dim"], m["intermediate_size"],
        m["vocab_size"])
    assert (reg.d_model, reg.n_heads, reg.n_kv_heads, reg.resolved_head_dim,
            reg.vocab) == (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim, cfg.vocab)
    if reg.moe is not None:
        assert (reg.moe.n_experts, reg.moe.top_k, reg.moe.d_expert) == (
            cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert)
    else:
        assert reg.d_ff == cfg.d_ff
    depth = d.get("published", {}).get("num_hidden_layers",
                                       m["num_hidden_layers"])
    assert depth == reg.n_layers
