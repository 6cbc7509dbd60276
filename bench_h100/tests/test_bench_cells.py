"""A new cell is files and entries: a configuration, a traffic mix and a
limits file dropped into a copy of the benchmark run with no code
edited."""
from __future__ import annotations

import json
import shutil

from conftest import HERE, ROOT, SEED
from benchkit import manifest
from benchkit.cell import run_cell


def test_added_cell_runs_from_files_alone(tmp_path):
    shutil.copytree(HERE, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((HERE / "configs" / "deepseek-7b.json").read_text())
    conf.update(name="toy-dense", dtype="float32", reduced=[], published={})
    conf["model"].update(num_hidden_layers=2, hidden_size=64,
                         num_attention_heads=4, num_key_value_heads=2,
                         head_dim=16, intermediate_size=96, vocab_size=128)
    here = tmp_path / "bench_h100"
    (here / "configs" / "toy-dense.json").write_text(json.dumps(conf))
    (here / "traffic" / "toy-chat.json").write_text(json.dumps({
        "mode": "serve", "why": "a toy", "clients": 3, "max_batch": 3,
        "page_tokens": 16, "prompt_tokens": [8, 40],
        "output_tokens": [2, 9], "warm_steps": 2,
        "profile_steps": 2, "check_requests": 2}))
    (here / "cells" / "toy.json").write_text(json.dumps(
        {"limits": {"max_logit_gap": 1e-3}}))
    bench["configs"].append({"name": "toy-dense", "source": conf["source"],
                             "file": "bench_h100/configs/toy-dense.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy", "config": "toy-dense",
                               "traffic": "toy-chat", "chips": 1,
                               "why": "a toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "deepseek7b-decode-chat" in m["workloads"]:
            m["workloads"].append("toy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.cell("toy", tmp_path)
    assert cell.config["name"] == "toy-dense"
    out = run_cell("toy", SEED, 0.5, False, device="cpu", root=tmp_path)
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"gen_tokens_per_s", "ttft_p90_ms",
                                   "itl_p95_ms", "setup_s"}
    assert list(out)[-1] == "compared"
