"""The ``decoder`` layout computes what the harness computed before layouts
existed: for each configuration file, the weights it draws (a copy of the
file at small widths, its own depth, on the CPU), the reference's logits
and training readings on them, the useful-FLOP counts and the roofline
readers' bounds at the file's own sizes.  The frozen values were read from
the harness as it stood before its layer code moved into the layout."""
from __future__ import annotations

import types

import numpy as np
import pytest

from conftest import ROOT, SEED, small
from benchkit import cell as C, flops, manifest, profile, weights
from benchkit.traffic import Rows
from reference import serve, train

CELL = {"olmoe-1b-7b-l4": "olmoe-train-4k",
        "deepseek-7b": "deepseek7b-decode-chat",
        "olmoe-1b-7b": "olmoe-prefill-code",
        "deepseek-7b-l6": "deepseek7b-train-4k"}

# per file: the weights' checksums (float32 and bfloat16 draws: the sum
# over layers of (i + 1) x layer i's sum, and the outer weights' sum), the
# reference's logits (sum, sum of magnitudes, five of one row; the fp8
# control's sum), the first three training losses, and the FLOP counts
FROZEN = {
    "olmoe-1b-7b-l4": {
        "weights": [1400.5516785529055, 69.50828124171716,
                    1400.5636735997832, 69.55251633003354],
        "logits": [-604.2017418691903, 6128.367728454141, 0.1042470932006836,
                   0.562549352645874, -0.9059531092643738,
                   0.26834672689437866, -0.7980886101722717,
                   -592.8489484235324],
        "losses": [6.114849090576172, 5.9605865478515625, 5.9056525230407715],
        "flops": {"layer": 67239936, "head": 103022592,
                  "prefill100": 54163472384.0,
                  "prefill3000": 1761469661184.0, "decode": 2331181056.0,
                  "train1": 9966672936960.0, "train4": 39866691747840.0}},
    "deepseek-7b": {
        "weights": [59243.79036522101, 63.033332551015064, 59244.52495097369,
                    63.03061777353287],
        "logits": [-530.4396979045487, 6106.929945832082,
                   -1.2604860067367554, -0.690500020980835,
                   0.4677860736846924, -1.9262462854385376,
                   0.06318184733390808, -447.7501394039573],
        "losses": None,
        "flops": {"layer": 202375168, "head": 419430400,
                  "prefill100": 1217572044800.0,
                  "prefill3000": 38640946380800.0, "decode": 40433418240.0,
                  "train1": 171887611084800.0, "train4": 687550444339200.0}},
    "olmoe-1b-7b": {
        "weights": [17622.376997231942, 46.098299651732304,
                    17623.93185443479, 46.10569139942527],
        "logits": [-82.01809625392104, 6452.551696991775,
                   0.08672637492418289, 0.43260300159454346,
                   1.2593231201171875, -0.9011678695678711,
                   -0.0006706652347929776, -224.53415732078793],
        "losses": None,
        "flops": {"layer": 67239936, "head": 103022592,
                  "prefill100": 216035753984.0,
                  "prefill3000": 7045260509184.0, "decode": 7470317568.0,
                  "train1": 32271042084864.0, "train4": 129084168339456.0}},
    "deepseek-7b-l6": {
        "weights": [2942.863830775665, 28.627007973131185, 2942.600486513227,
                    28.644341617822647],
        "logits": [-108.85367504246824, 6279.282826488998,
                   -0.7126876711845398, 0.8110076189041138,
                   -1.3007794618606567, 0.6665210127830505,
                   -0.20829923450946808, -54.716867113951594],
        "losses": [5.8620829582214355, 6.247337818145752, 6.009705543518066],
        "flops": {"layer": 202375168, "head": 419430400,
                  "prefill100": 244185497600.0,
                  "prefill3000": 7728860364800.0, "decode": 10099949568.0,
                  "train1": 42623859425280.0, "train4": 170495437701120.0}},
}

# the roofline and utilisation readers on a hand-made slice (training at
# 4 rows of 4096)
ROOFLINE = {
    "deepseek7b-decode-chat": {"k1_roofline.serve": 3.1428437014925374,
                               "k2_roofline.serve": 12.724621200054328,
                               "mfu.serve": 0.1256759420246714},
    "olmoe-prefill-code": {"k1_roofline.serve": 0.8381050268656716,
                           "k2_roofline.serve": 3.393232320014487,
                           "mfu.serve": 0.022495846275753285},
    "olmoe-train-4k": {"k2_roofline.train": 16.680182961051568,
                       "k2bwd_roofline.train": 10.425114350657228,
                       "mfu.train": 0.4031010287951466},
    "deepseek7b-train-4k": {"k2_roofline.train": 33.360365922103135,
                            "k2bwd_roofline.train": 20.850228701314457,
                            "mfu.train": 1.723917469172093},
}


def _small(conf: str):
    """The file's cell at small widths and the file's own depth."""
    depth = manifest.cell(CELL[conf], ROOT).config["model"][
        "num_hidden_layers"]
    return small(CELL[conf], num_hidden_layers=depth)


def readings(conf: str) -> dict:
    c = _small(conf)
    layout, m = c.layout, c.config["model"]
    out = {"weights": []}
    for dt in ("float32", "bfloat16"):
        dtype = weights.DTYPES[dt]
        check = sum((i + 1) * sum(float(t.double().sum()) for t in
                                  layout.layer_weights(m, SEED, i, "cpu",
                                                       dtype).values())
                    for i in range(m["num_hidden_layers"]))
        outer = sum(float(t.double().sum()) for t in
                    layout.outer_weights(m, SEED, "cpu", dtype).values())
        out["weights"] += [check, outer]
    tok = np.random.default_rng(0).integers(0, m["vocab_size"], 40)
    req = [(tok[:10], tok[10:])]
    rows = serve.logit_rows(layout, c.config, SEED, req, "cpu")[0].double()
    low = serve.logit_rows(layout, c.config, SEED, req, "cpu",
                           prec="fp8")[0].double()
    out["logits"] = [float(rows.sum()), float(rows.abs().sum()),
                     *[float(x) for x in rows[3, :5]], float(low.sum())]
    out["losses"] = None
    if c.traffic["mode"] == "train":            # one row, as frozen
        data = Rows(dict(c.traffic, batch=1), SEED, m["vocab_size"])
        got = train.train(layout, c.config, SEED,
                          [data.rows(i) for i in range(3)],
                          c.traffic["optimizer"], "cpu")
        out["losses"] = got["losses"]
    full = manifest.cell(CELL[conf], ROOT).config["model"]
    out["flops"] = {"layer": layout.layer_matmul_params(full, 0),
                    "head": layout.head_params(full),
                    "prefill100": flops.prefill(layout, full, 100),
                    "prefill3000": flops.prefill(layout, full, 3000),
                    "decode": flops.decode(layout, full, [10, 20, 3000]),
                    "train1": flops.train_step(layout, full, 1, 4096),
                    "train4": flops.train_step(layout, full, 4, 4096)}
    return out


@pytest.mark.parametrize("conf", sorted(FROZEN))
def test_decoder_layout_computes_what_the_harness_did(conf):
    got, want = readings(conf), FROZEN[conf]
    assert manifest.cell(CELL[conf], ROOT).config["layout"] == "decoder"
    assert got["flops"] == want["flops"]           # whole numbers: exact
    # sums of the same values in another order may differ in the last bit
    assert got["weights"] == pytest.approx(want["weights"], rel=1e-12)
    assert got["logits"] == pytest.approx(want["logits"], rel=1e-6,
                                          abs=1e-6)
    if want["losses"] is None:
        assert got["losses"] is None
    else:
        assert got["losses"] == pytest.approx(want["losses"], rel=1e-6)


def _slice() -> profile.Trace:
    spans = [("decode", 0, 1, {"lens": [100, 2000, 37, 1],
                               "context": [100, 2000, 37]}),
             ("prefill", 0, 1, {"prompt": 1000, "padded": 1008}),
             ("prefill", 0, 1, {"prompt": 3000, "padded": 3008})]
    kernels = {"paged_partial_kernel": (0.01, 30),
               "flash_attention_mma_kernel": (0.02, 12),
               "attn_bwd_dq_kernel": (0.03, 6), "attn_bwd_dkdv": (0.01, 6)}
    return profile.Trace(t0=5.0, t1=6.0, window_s=1.0, busy_s=0.5,
                         kernel_s={k: v[0] for k, v in kernels.items()},
                         kernel_n={k: v[1] for k, v in kernels.items()},
                         gaps={}, spans=spans)


@pytest.mark.parametrize("cell", sorted(ROOFLINE))
def test_roofline_and_mfu_readers_count_what_they_did(cell):
    c = manifest.cell(cell, ROOT)
    kind = c.traffic["mode"]
    rec = C.Record(cell=cell, kind=kind, model=c.config["model"],
                   traffic=dict(c.traffic, batch=4), layout=c.layout,
                   trace=_slice())
    rec.window = (0.0, 10.0)
    if kind == "serve":
        rec.steps = [(0, 1, 4, 0.0, False)]
        rec.spans = [("prefill", 7, 7.5, {"prompt": 1000, "padded": 1008}),
                     ("decode", 8, 8.1, {"lens": [101, 2001, 38, 1],
                                         "context": [101, 2001, 38]})]
    else:
        rec.steps = [(0, 1, 4 * 4096, 0.0, False)]
    got = {name: manifest.reader(name, ROOT)(rec) for name in ROOFLINE[cell]}
    assert got == pytest.approx(ROOFLINE[cell], rel=1e-12)


def test_a_configuration_without_a_layout_fails_naming_the_key(tmp_path):
    import json
    import shutil
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    conf = tmp_path / "bench_h100" / "configs" / "deepseek-7b.json"
    d = json.loads(conf.read_text())
    del d["layout"]
    conf.write_text(json.dumps(d))
    with pytest.raises(ValueError, match='"layout"'):
        manifest.cell("deepseek7b-decode-chat", tmp_path)
    # a name with no file is no layout either
    d["layout"] = "no-such-layout"
    conf.write_text(json.dumps(d))
    with pytest.raises(FileNotFoundError):
        manifest.cell("deepseek7b-decode-chat", tmp_path)


def test_a_layout_names_what_the_harness_calls():
    """Every name the harness calls on a layout is the decoder's."""
    names = {"arch", "lm_module", "engine", "trainer", "first_gradient",
             "named_weights", "recorded_routes", "layer_matrices",
             "layer_weights", "outer_weights", "leaf_of", "stack_leaves",
             "TOKEN_LEAF", "Spec", "ref_embed", "ref_layer", "ref_head",
             "layer_matmul_params", "attention_pair_flops", "head_params",
             "cache_bytes_per_token", "attention_shapes"}
    layout = manifest.layout("decoder", ROOT)
    assert not names - set(vars(layout))
    assert isinstance(layout, types.ModuleType)
