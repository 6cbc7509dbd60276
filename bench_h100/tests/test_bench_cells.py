"""A new cell is files and entries: a configuration, a traffic mix and a
limits file dropped into a copy of the benchmark run with no code
edited; a new layer layout is one more file."""
from __future__ import annotations

import hashlib
import json
import shutil

import torch

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


# A second layout, written as a later change would add one: the port's
# LayerNorm, GeLU and biased-QKV layer (its "ln", "gelu" and qkv_bias
# mechanisms, as starcoder2's registry entry selects them), with its own
# weights (every bias drawn, so that each counts), reference layer and
# counts; what it shares with the decoder it takes from that layout.
TOY_LAYOUT = '''"""A toy layout: LayerNorm, GeLU and biased QKV."""
from pathlib import Path

import torch
import torch.nn.functional as F

from benchkit import manifest, weights
from reference import ops

_dec = manifest.layout("decoder", Path(__file__).resolve().parents[2])
arch, engine, trainer = _dec.arch, _dec.engine, _dec.trainer
first_gradient, named_weights = _dec.first_gradient, _dec.named_weights
recorded_routes, Spec, ref_embed = _dec.recorded_routes, _dec.Spec, _dec.ref_embed
leaf_of, stack_leaves, TOKEN_LEAF = _dec.leaf_of, _dec.stack_leaves, _dec.TOKEN_LEAF
attention_pair_flops, head_params = _dec.attention_pair_flops, _dec.head_params
cache_bytes_per_token = _dec.cache_bytes_per_token
attention_shapes = _dec.attention_shapes


def _sizes(m):
    d, H = m["hidden_size"], m["num_attention_heads"]
    return d, H, m["num_key_value_heads"], m["head_dim"], m["intermediate_size"]


def lm_module(cfg, cfgd, seed, device):
    from repro_torch.models.transformer import TransformerLM
    module = TransformerLM(cfg, device=device, generator=None)
    m, dtype = cfgd["model"], weights.DTYPES[cfgd["dtype"]]
    named = dict(module.named_parameters())
    drawn = dict(outer_weights(m, seed, device, dtype))
    for i in range(m["num_hidden_layers"]):
        drawn.update({f"layers.{i}.{k}": t for k, t in
                      layer_weights(m, seed, i, device, dtype).items()})
    assert set(drawn) == set(named)
    with torch.no_grad():
        for k, t in drawn.items():
            named[k].copy_(t)
    return module


def layer_matrices(m, i):
    d, H, Hkv, hd, f = _sizes(m)
    return {"attn.wq": ((d, H * hd), d), "attn.wk": ((d, Hkv * hd), d),
            "attn.wv": ((d, Hkv * hd), d), "attn.wo": ((H * hd, d), H * hd),
            "mlp.w_up": ((d, f), d), "mlp.w_down": ((f, d), f)}


def layer_weights(m, seed, i, device, dtype):
    d, H, Hkv, hd, f = _sizes(m)
    gen = weights.generator(seed, i, device)
    out = weights.draw({k: (s, fan ** -0.5) for k, (s, fan)
                        in layer_matrices(m, i).items()}, gen, device, dtype)
    out.update(weights.draw({
        "attn.bq": ((H * hd,), 0.02), "attn.bk": ((Hkv * hd,), 0.02),
        "attn.bv": ((Hkv * hd,), 0.02), "mlp.b_up": ((f,), 0.02),
        "mlp.b_down": ((d,), 0.02), "ln1.bias": ((d,), 0.02),
        "ln2.bias": ((d,), 0.02)}, gen, device, dtype))
    out["ln1.scale"] = torch.ones(d, dtype=dtype, device=device)
    out["ln2.scale"] = torch.ones(d, dtype=dtype, device=device)
    return out


def outer_weights(m, seed, device, dtype):
    d, V = m["hidden_size"], m["vocab_size"]
    gen = weights.generator(seed, m["num_hidden_layers"], device)
    out = weights.draw({"embed.tok": ((V, d), 0.02),
                        "embed.head": ((d, V), d ** -0.5),
                        "final_norm.bias": ((d,), 0.02)}, gen, device, dtype)
    out["final_norm.scale"] = torch.ones(d, dtype=dtype, device=device)
    return out


def _ln(x, gain, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gain + bias


def ref_layer(s, i, w, h, pos, prec, capacity=False):
    B, S, d = h.shape
    hd, mm = s.head_dim, ops.mm
    a = []
    for b in range(B):
        x = _ln(h[b], w["ln1.scale"], w["ln1.bias"], s.eps)
        q = (mm(x, w["attn.wq"], prec) + w["attn.bq"]).view(S, s.heads, hd)
        k = (mm(x, w["attn.wk"], prec) + w["attn.bk"]).view(S, s.kv_heads, hd)
        v = (mm(x, w["attn.wv"], prec) + w["attn.bv"]).view(S, s.kv_heads, hd)
        o = ops.causal_attention(ops.rope(q, pos, s.theta),
                                 ops.rope(k, pos, s.theta), v, prec)
        a.append(mm(o, w["attn.wo"], prec))
    h = h + torch.stack(a)
    x = _ln(h, w["ln2.scale"], w["ln2.bias"], s.eps)
    u = F.gelu(mm(x, w["mlp.w_up"], prec) + w["mlp.b_up"], approximate="tanh")
    return h + mm(u, w["mlp.w_down"], prec) + w["mlp.b_down"], h.new_zeros(())


def ref_head(s, w, h, prec):
    x = _ln(h, w["final_norm.scale"], w["final_norm.bias"], s.eps)
    return ops.mm(x, w["embed.head"], prec)


def layer_matmul_params(m, i):
    d, H, Hkv, hd, f = _sizes(m)
    return d * (H + 2 * Hkv) * hd + H * hd * d + 2 * d * f
'''


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_added_layout_runs_a_cell_from_files_alone(tmp_path, monkeypatch):
    shutil.copytree(HERE, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    here = tmp_path / "bench_h100"
    (here / "layouts" / "toy_gelu.py").write_text(TOY_LAYOUT)
    conf = json.loads((HERE / "configs" / "deepseek-7b.json").read_text())
    conf.update(name="toy-gelu", port_config="starcoder2-3b",
                layout="toy_gelu", dtype="float32", reduced=[], published={})
    conf["model"].update(num_hidden_layers=2, hidden_size=64,
                         num_attention_heads=4, num_key_value_heads=2,
                         head_dim=16, intermediate_size=96, vocab_size=128)
    (here / "configs" / "toy-gelu.json").write_text(json.dumps(conf))
    (here / "traffic" / "toy-code.json").write_text(json.dumps({
        "mode": "serve", "why": "a toy", "clients": 3, "max_batch": 3,
        "page_tokens": 16, "prompt_tokens": [8, 40],
        "output_tokens": [2, 9], "warm_steps": 2,
        "profile_steps": 2, "check_requests": 2}))
    (here / "cells" / "toy-gelu-code.json").write_text(json.dumps(
        {"limits": {"max_logit_gap": 1e-3}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-gelu", "source": conf["source"],
                             "file": "bench_h100/configs/toy-gelu.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy-gelu-code", "config": "toy-gelu",
                               "traffic": "toy-code", "chips": 1,
                               "why": "a toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "deepseek7b-decode-chat" in m["workloads"]:
            m["workloads"].append("toy-gelu-code")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.cell("toy-gelu-code", tmp_path)
    assert cell.layout.__name__ == "bench_layout_toy_gelu"
    out = run_cell("toy-gelu-code", SEED, 0.5, False, device="cpu",
                   root=tmp_path)
    assert out["correct"] and out["attempted"] > 0, out["compared"]
    assert set(out["metrics"]) == {"gen_tokens_per_s", "ttft_p90_ms",
                                   "itl_p95_ms", "setup_s"}
    # a traced run reads the layout's counts (its utilisation)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    out = run_cell("toy-gelu-code", SEED, 1.0, True, device="cpu",
                   root=tmp_path)
    assert out["correct"] and out["metrics"]["mfu.serve"]["value"] > 0

    after = _digests(tmp_path)
    added = {"bench_h100/layouts/toy_gelu.py", "bench_h100/configs/toy-gelu.json",
             "bench_h100/traffic/toy-code.json",
             "bench_h100/cells/toy-gelu-code.json"}
    assert set(after) == set(before) | added
    assert {k for k in before if before[k] != after[k]} == {"BENCHMARK.json"}
