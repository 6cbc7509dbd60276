"""Tensor-parallel serving of the decoder, recurrent and encoder-decoder
families (``prefill`` and ``decode_step`` under a runtime mesh) against the
JAX package's, on the CPU.

One module fixture runs ``tests/torch_dist_checks.py``'s "serve_tp" mode
once: JAX's ``prefill`` and ``decode_step`` jitted with its dry run's
``in_shardings`` (``param_specs``, ``batch_specs``, ``decode_state_specs``)
on 8 forced host devices, and unsharded, in two subprocesses; beside them
the port's 8 gloo ranks, each config starting from JAX's initial weights
(``serve_cfgs``: TINY, manual_sp_check.py's deepseek, the reduced qwen2
(dp_only, batch 4), olmoe (global dispatch and ``ep_a2a``) and internvl2
(vlm) on (8, 1), (4, 2) and (2, 4); TINY on (2, 4) with caches 24 and
48 deep, whose "seq" slices of 6 and 12 have the depth of a whole cache
that nothing splits; ODD on (4, 2) at batch 2 and 4, whose cache specs
put the batch and the layers over "model"; the reduced internvl2 with
its bf16 attention on (2, 4); the reduced rwkv6, mamba2 and zamba2 on the
three meshes, rwkv6 at batch 2 on (4, 2), zamba2 with a 2-token prompt
on (2, 4), and rwkv6 and zamba2 in bf16 on (2, 4); the reduced whisper
with its 8 frames on the three meshes and (1, 8), with 6 frames and 4
layers on (2, 4) and (1, 8), at batch 2 on (4, 2) and in bf16 on (2, 4)).
Each case prefills
an 8-token prompt (the short one aside) into a 32-deep cache (24 and 48
for those TINY cases, 17 for ODD; the recurrent states are O(1),
zamba2's shared block's caches 32 deep) and takes 8 greedy decode
steps.

Bars: fp32 logits (prefill's last and 8 decode steps') rtol 1e-4 / atol
1e-5 against JAX's partitioned run; greedy tokens identical; each rank's
cache shard equal to the ``decode_state_specs`` slice of JAX's cache at
rtol 1e-5 (atol 1e-5 of its largest value).  The "seq" layout combines its slices'
softmaxes by their log-sum-exp, so under bf16 attention it rounds each
slice's probabilities where JAX rounds the whole row's: that case is fed
JAX's tokens and held to 2^-6 of the largest logit.  The bf16 rwkv6,
zamba2 and whisper are fed JAX's tokens too and held within 3x the
spread of the bf16 runs (JAX's unsharded run, fed the same tokens,
against the port's plain path and against JAX's partitioned run): the
frameworks round bf16 apart even unpartitioned.  The combine itself is held here in one
process against whole-sequence attention.

Whisper's cross K/V lie on the heads, the frames (each rank's slice's
output and log-sum-exp, K2's LSE route, combined over "model"), the
layers (the layer's owner computes its cross-attention and broadcasts the
output) or not over "model"; the port keeps them (L, B, Hkv, F, hd), so
its specs are JAX's with entries 2 and 3 swapped and its arrays are
compared permuted to JAX's (L, B, F, Hkv, hd).  The frames combine is held
here in one process too, with the ranks as threads.

The recurrent families' rank programs split each state on its readout's
contracted dim (rwkv6's wkv keys, the SSD state's ds): each rank's part of
the readout is summed over "model".  Held here in one process, with the
ranks as threads meeting at in-process collectives (``_lockstep``): the
split-key step of K4's plain version against the full-state step, and the
ds-split mamba step and rwkv6's key-split time-mix against their plain
layers.
"""
import threading
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs, weights  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import api, attention, transformer  # noqa: E402
from repro_torch.models.common import ArchCfg  # noqa: E402
from repro_torch.parallel import sharding, spmd  # noqa: E402
from repro_torch.runtime.trainer import shard_params  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as tdc  # noqa: E402

CFGS = tdc.serve_cfgs(configs, ArchCfg, torch.float32, torch.bfloat16)
CASES = [tdc._tag(t, s) for t, (_, _, meshes, _) in CFGS.items()
         for s in meshes]
EXACT = [c for c in CASES if c.split("_")[0] not in tdc.SERVE_FORCED]
RECURRENT = [c for c in CASES if c.split("_")[0] in tdc.SERVE_RECURRENT]
ENCDEC = [c for c in CASES if c.split("_")[0] in tdc.SERVE_ENCDEC]
DECODER = [c for c in CASES if c not in RECURRENT and c not in ENCDEC]
FORCED = [c for c in DECODER if c.split("_")[0] in tdc.SERVE_FORCED]
REC_BF16 = [c for c in RECURRENT if c.split("_")[0] in tdc.SERVE_FORCED]
# the bf16 cases held within the spread of the bf16 runs (_bf16_bar)
SPREAD_BF16 = [c for c in CASES if c.split("_")[0] in tdc.SERVE_PLAIN]
RTOL, ATOL = 1e-4, 1e-5
BF16_BAR = 2.0 ** -6
# a bf16 recurrent case's bar over the frameworks' plain spread: the
# factor chip_smoke.py holds the card's bf16 recurrent logits to
REC_SPREAD = 3.0


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serve_tp"))
    tdc.launch("serve_tp", out, timeout=600)
    ranks, arrays = [], []
    for r in range(8):
        with open(os.path.join(out, f"rank{r}_serve_tp.json")) as f:
            ranks.append(json.load(f))
        with np.load(os.path.join(out, f"rank{r}_serve_tp.npz")) as z:
            arrays.append({k: z[k] for k in z.files})

    def jax(case, mesh=None):
        tag, m = case.split("_")
        with np.load(os.path.join(
                out, f"jax_serve_{tag}_{mesh or m}.npz")) as z:
            return {k: z[k] for k in z.files}

    return {"ranks": ranks, "arrays": arrays, "jax": jax}


def _case(case):
    tag, m = case.split("_")
    cfg, batch, _, max_len = CFGS[tag]
    return cfg, batch, tuple(int(x) for x in m.split("x")), max_len


def _whole_state(cfg, batch, max_len):
    """The family's whole decode state at ``batch`` on meta."""
    return api.get_model(cfg).init_decode_state(batch, max_len,
                                                device="meta")


def _layout(cfg, mesh, batch, max_len):
    """``sharding.state_layout`` of the family's whole state."""
    return sharding.state_layout(cfg, mesh, batch,
                                 _whole_state(cfg, batch, max_len))


def _coords(rank, mesh_shape):
    return {"data": rank // mesh_shape[1], "model": rank % mesh_shape[1]}


def _shard_np(a, spec, mesh_shape, rank):
    """Rank ``rank``'s part of a global numpy array under ``spec``."""
    sizes = dict(zip(("data", "model"), mesh_shape))
    at = _coords(rank, mesh_shape)
    for dim, e in enumerate(tuple(spec) + (None,) * (a.ndim - len(spec))):
        idx, n = 0, 1
        for ax in sharding.spec_axes(e):
            idx, n = idx * sizes[ax] + at[ax], n * sizes[ax]
        if n > 1:
            size = a.shape[dim] // n
            a = np.take(a, range(idx * size, (idx + 1) * size), axis=dim)
    return a


@pytest.mark.parametrize("case", EXACT)
def test_logits_and_greedy_tokens_match_jax_on_8_ranks(run, case):
    """Prefill's last logits and the 8 decode steps', and the greedy
    tokens, on every rank's rows, against JAX's partitioned run."""
    want = run["jax"](case)
    for r, (res, arr) in enumerate(zip(run["ranks"], run["arrays"])):
        rows = res[case]["rows"]
        np.testing.assert_allclose(arr[f"{case}/logits"],
                                   want["logits"][:, rows], rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(arr[f"{case}/tokens"],
                                      want["tokens"][:, rows])
        assert res[case]["finite"]


@pytest.mark.parametrize("case", FORCED)
def test_bf16_seq_layout_within_its_bar(run, case):
    """The reduced internvl2 with bf16 attention in the "seq" layout, fed
    JAX's tokens: every logit within 2^-6 of the largest (the slices'
    probabilities rounded to bf16 apiece), the greedy token equal wherever
    JAX's top-2 gap exceeds twice that bar, the prefill's logits and cache
    (no split softmax there) at the fp32 bars."""
    want = run["jax"](case)
    bar = BF16_BAR * float(np.abs(want["logits"]).max())
    top2 = np.sort(want["logits"], -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * bar
    assert clear.mean() > 0.5     # the reduced model's logits lie close
    for res, arr in zip(run["ranks"], run["arrays"]):
        rows = res[case]["rows"]
        got = arr[f"{case}/logits"]
        assert res[case]["layout"] == "seq"
        assert np.abs(got - want["logits"][:, rows]).max() <= bar
        np.testing.assert_allclose(got[0], want["logits"][0, rows],
                                   rtol=RTOL, atol=ATOL)
        hit = got.argmax(-1) == want["logits"][:, rows].argmax(-1)
        assert hit[clear[:, rows]].all()
        assert res[case]["finite"]


def _bf16_bar(run, case, name):
    """The bar of a bf16 recurrent case's array ``name`` (its logits, a
    state leaf): REC_SPREAD times the larger spread of JAX's unsharded
    run from the port's plain path (the frameworks' own bf16 rounding)
    and from JAX's partitioned run (its partitioner's), all fed the
    partitioned run's tokens; never below 2^-6 of its largest value."""
    tag = case.split("_")[0]
    whole, part = run["jax"](case, "whole")[name], run["jax"](case)[name]
    plain = run["arrays"][0][f"{tag}_whole/{name}"]
    spread = max(np.abs(plain - whole).max(), np.abs(part - whole).max())
    return max(REC_SPREAD * float(spread),
               BF16_BAR * float(np.abs(part).max()))


@pytest.mark.parametrize("case", REC_BF16)
def test_recurrent_bf16_rank_programs_within_their_bar(run, case):
    """The reduced rwkv6 and zamba2 in bf16 on (2, 4), fed the tokens of
    JAX's partitioned bf16 run, against it: every logit of the prefill
    and the 8 decode steps within ``_bf16_bar`` (the two frameworks round
    bf16 apart even unpartitioned, and each partitioned run sums bf16
    partials over "model" in its own order), the greedy token equal
    wherever JAX's top-2 gap exceeds twice that bar."""
    _hold_bf16_logits(run, case)


@pytest.mark.parametrize("case", [c for c in SPREAD_BF16 if c in ENCDEC])
def test_encdec_bf16_rank_program_within_its_bar(run, case):
    """The reduced whisper in bf16 on (2, 4) (self K/V on the sequence,
    cross K/V on the frames: both softmaxes split over "model"), fed the
    tokens of JAX's partitioned bf16 run, against it as the recurrent
    bf16 cases are: every logit within ``_bf16_bar``, the greedy token
    equal wherever JAX's top-2 gap exceeds twice that bar."""
    _hold_bf16_logits(run, case)


def _hold_bf16_logits(run, case):
    want = run["jax"](case)
    bar = _bf16_bar(run, case, "logits")
    top2 = np.sort(want["logits"], -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * bar
    assert clear.any()
    for res, arr in zip(run["ranks"], run["arrays"]):
        rows = res[case]["rows"]
        got = arr[f"{case}/logits"]
        assert np.abs(got - want["logits"][:, rows]).max() <= bar
        hit = got.argmax(-1) == want["logits"][:, rows].argmax(-1)
        assert hit[clear[:, rows]].all()
        assert res[case]["finite"]


def test_jax_partitioned_ep_prefill_parts_from_its_unsharded_run(run):
    """On a "model" axis JAX's ``ep_a2a`` prefill dispatches expert-
    parallel, each (rows x sequence) block with its own capacity, where
    its unsharded run falls back to the global dispatch: the logits part
    (the reduced olmoe drops tokens at capacity factor 1.25).  The port's
    rank program is the partitioned one (``apply_moe_ep``), so it is held
    to JAX's partitioned run; on (8, 1) the two agree."""
    whole = run["jax"]("olmoe-ep_whole", "whole")["logits"]
    for case in ("olmoe-ep_4x2", "olmoe-ep_2x4"):
        part = run["jax"](case)["logits"]
        assert np.abs(part[0] - whole[0]).max() > 1e-2
    np.testing.assert_allclose(run["jax"]("olmoe-ep_8x1")["logits"], whole,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_cache_shards_are_the_decode_state_specs_slices(run, case):
    """Each rank's cache (a recurrent family's state, the encoder-
    decoder's self and cross K/V: every leaf), after prefill and after the
    8 decode steps, is its ``decode_state_specs`` slice (the serving
    config's: TP specs even under dp_only) of JAX's, and holds nothing
    else; the port's cross K/V (L, B, Hkv, F, hd) are compared permuted
    to JAX's (L, B, F, Hkv, hd)."""
    cfg, batch, mesh_shape, _ = _case(case)
    mesh = sharding.abstract_mesh(mesh_shape, ("data", "model"))
    want = run["jax"](case)
    leaves = [k for k in want if f"prefill_{k}" in want]
    assert sorted(leaves) == sorted(
        ["k", "v"] if case in DECODER else
        ["cross_k", "cross_v", "k", "v"] if case in ENCDEC else
        sharding.state_paths(_whole_state(cfg, batch, _case(case)[3])))
    forced = case.split("_")[0] in tdc.SERVE_FORCED
    for r, arr in enumerate(run["arrays"]):
        for name in [p + n for n in leaves for p in ("prefill_", "")]:
            leaf = name.removeprefix("prefill_")
            spec = sharding.decode_state_specs(
                transformer.serving_cfg(cfg), {leaf: want[leaf]}, mesh,
                batch)[leaf]
            w = _shard_np(want[name], spec, mesh_shape, r)
            got = arr[f"{case}/{name}"]
            assert got.shape == w.shape, (r, name)
            if case in SPREAD_BF16:
                assert np.abs(got - w).max() <= _bf16_bar(run, case, name)
            elif forced and not name.startswith("prefill"):
                scale = float(np.abs(want[name]).max())
                assert np.abs(got - w).max() <= BF16_BAR * scale
            else:    # values of order 1: atol 1e-5 of the largest
                np.testing.assert_allclose(
                    got, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()),
                    err_msg=f"rank {r} {name}")


def _expected_params(cfg, mesh_shape, rank):
    """{parameter name: shape} of a rank's shards under ``param_specs``."""
    model = weights.model_class(cfg)(cfg, device="meta")
    shard_params(cfg, model, Mesh(mesh_shape, ("data", "model"), range(8),
                                  abstract_rank=rank))
    return {k: list(v.shape) for k, v in model.named_parameters()}


@pytest.mark.parametrize("case", DECODER)
def test_each_rank_holds_only_its_spec_shards(run, case):
    """Every rank's parameters (prefill's, and the decode step's under the
    serving config) are its ``param_specs`` shards; on a "model" axis of
    more than one rank its cache is a part of the whole; a decode step
    gathers only the embedding, the LM head and the routers (and, in the
    "other" layout, whose attention runs every head, the attention
    weights), never an expert tensor."""
    cfg, batch, mesh_shape, max_len = _case(case)
    dcfg = transformer.serving_cfg(cfg)
    whole = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    for r, (res, arr) in enumerate(zip(run["ranks"], run["arrays"])):
        held = res[case]
        assert held["params"] == _expected_params(cfg, mesh_shape, r)
        dec = _expected_params(dcfg, mesh_shape, r)
        assert held["decode_params"] == dec
        if mesh_shape[1] > 1:    # 1/|model| of its rows' cache
            rows = len(held["rows"])
            assert np.prod(arr[f"{case}/k"].shape) * mesh_shape[1] \
                == np.prod(whole) // batch * rows
        attn = held["layout"] == "other"
        readable = {tuple(v) for k, v in dec.items()
                    if k.startswith("embed.") or k.endswith("moe.router")
                    or attn and ".attn." in k}
        for shape in held["decode_gathered"]:
            assert len(shape) == 2 and tuple(shape) in readable, shape


@pytest.mark.parametrize("case", [c for c in DECODER if c.endswith("x2")
                                  or c.endswith("x4")])
def test_the_collectives_a_decode_layer_issues(run, case):
    """One decode step's collectives, by layout: "heads" two all-reduces
    of activations a dense layer (attention's wo, the MLP's w_down), an
    MoE layer one and its experts' sum; "seq" one all-gather of the q/k/v
    column slices, the combine's max and sum all-reduces and the same
    all-reduces as "heads"; "other" each layer's K and V gathered where
    read (a cache split by layers: the whole stack, once a step)."""
    cfg, batch, mesh_shape, max_len = _case(case)
    L, moe = cfg.n_layers, cfg.moe is not None
    for res in run["ranks"]:
        held = res[case]
        n = held["counts"]["decode"]
        # "other": attention whole on every rank, the MLP on a d_ff slice
        assert n["all_reduce/act"] == (
            L if moe or held["layout"] == "other" else 2 * L)
        assert n.get("all_reduce/expert", 0) == (L if moe else 0)
        if held["layout"] == "heads":
            assert "all_reduce_max/combine" not in n
            assert "all_gather/cache" not in n
        elif held["layout"] == "seq":
            assert n["all_gather/qkv"] == L
            assert n["all_reduce_max/combine"] == L
            assert n["all_reduce/combine"] == L
        else:   # each layer's K and V where read; split by layers, once
            assert held["layout"] == "other"
            _, spec = sharding.cache_layout(
                transformer.serving_cfg(cfg), sharding.abstract_mesh(
                    mesh_shape, ("data", "model")), batch, max_len)
            assert n["all_gather/cache"] == (2 if spec[0] else 2 * L)
            assert "all_reduce_max/combine" not in n


def test_layouts_follow_the_kv_heads(run):
    """(4, 2): the reduced configs' 2 KV heads divide "model" ("heads");
    (2, 4): they do not, and the sequence (32, 24 or 48 deep) does
    ("seq"); (8, 1):
    nothing over "model"; ODD on (4, 2): the batch or the layers
    ("other")."""
    port = run["ranks"][0]
    for case, held in port.items():
        if case in RECURRENT:
            continue
        cfg, _, mesh_shape, _ = _case(case)
        if case.startswith("odd"):
            assert held["layout"] == "other"
        elif mesh_shape[1] == 1:
            assert held["layout"] is None
        else:
            assert held["layout"] == (
                "heads" if cfg.n_kv_heads % mesh_shape[1] == 0 else "seq")


def test_dp_only_prefill_takes_the_sequence_over_model(run):
    """The reduced qwen2 (dp_only, batch 4) on (4, 2) and (2, 4): the
    batch spec puts the sequence over "model"; prefill runs the plain
    layers on the rank's slice, K/V gathered a layer, no tensor-parallel
    all-reduce, and the cache is gathered once to the decode layout
    (the serving config's TP specs)."""
    L = CFGS["qwen"][0].n_layers
    for case in ("qwen_4x2", "qwen_2x4"):
        for res in run["ranks"]:
            n = res[case]["counts"]["prefill"]
            assert n["all_gather/kv"] == L
            assert "all_reduce/act" not in n


def test_all_masked_slices_give_no_nan(run):
    """On (2, 4) the 32-deep cache is 4 slices of 8; the first decode
    step writes position 8 (12 with the VLM prefix): slices 2 and 3 hold
    no visible key, their partials m = -inf and l = 0, and every logit
    stays finite (and within the bars above); TINY's 48-deep cache leaves
    slices 2 and 3 empty through all 8 steps."""
    for case in [c for c in DECODER if c.endswith("_2x4")]:
        for res in run["ranks"]:
            if res[case]["layout"] == "seq":
                assert res[case]["finite"], case


# ----------------------------------------------------------------------------
# the recurrent families on 8 ranks
# ----------------------------------------------------------------------------

def _split_dim(spec):
    return [i for i, e in enumerate(spec) if "model" in sharding.spec_axes(e)]


@pytest.mark.parametrize("case", RECURRENT)
def test_recurrent_ranks_hold_their_shards_and_move_a_layer_at_a_time(
        run, case):
    """Every rank's parameters (prefill's and the decode step's) are its
    ``param_specs`` shards; a decode step gathers no weight but the
    embedding (the LM head) and rwkv6's token-shift lerps (mu, (5, d) and
    (2, d)), save where "model" does not divide the shared block's heads
    (it runs whole: its weights gathered); every collective of a state or
    cache layer moves one layer (its result has no layer dim): no state
    leaf and no shared-block cache is gathered whole, and a cache split
    by its KV heads moves not at all."""
    cfg, batch, mesh_shape, max_len = _case(case)
    mesh = sharding.abstract_mesh(mesh_shape, ("data", "model"))
    layout = _layout(cfg, mesh, batch, max_len)
    ndim = {len(shape) for _, shape in layout.values()}
    whole_block = cfg.family == "zamba2" and cfg.n_heads % mesh_shape[1]
    by_heads = cfg.family != "zamba2" or _split_dim(layout["kv/k"][0]) == [3]
    for r, res in enumerate(run["ranks"]):
        held = res[case]
        assert held["params"] == _expected_params(cfg, mesh_shape, r)
        dec = _expected_params(transformer.serving_cfg(cfg), mesh_shape, r)
        assert held["decode_params"] == dec
        readable = {tuple(v) for k, v in dec.items()
                    if k.startswith("embed.") or k.endswith(".mu")
                    or whole_block and k.startswith("shared.")}
        for shape in held["decode_gathered"]:
            assert tuple(shape) in readable, shape
        for op, tag, shape in held["decode_moved"]:
            assert len(shape) + 1 in ndim, (op, tag, shape)
            assert tag != "cache" or not by_heads, (op, shape)


@pytest.mark.parametrize("case", [c for c in RECURRENT if c.endswith("x2")
                                  or c.endswith("x4")])
def test_the_collectives_a_recurrent_decode_layer_issues(run, case):
    """One decode step's collectives a layer.  rwkv6: the r|k|v|g column
    slices gathered, the decay LoRA's partial reduce-scattered onto the
    rank's keys, the readout's partials summed, w_o's slices gathered; the
    channel-mix one reduce-scatter and one all-gather.  A mamba layer: the
    projection's slices gathered, the readout's partials summed, w_out's
    partial summed; the shared block two all-reduces.  A state leaf split
    by the layers is broadcast a layer by the rank that holds it; one
    split by its batch rows gathered a layer."""
    cfg, batch, mesh_shape, max_len = _case(case)
    mesh = sharding.abstract_mesh(mesh_shape, ("data", "model"))
    layout = _layout(cfg, mesh, batch, max_len)
    L = cfg.n_layers
    on_l = sum(_split_dim(spec) == [0] for spec, _ in layout.values())
    on_rows = sum(_split_dim(spec) == [1] for spec, _ in layout.values())
    apps = L // cfg.attn_every if cfg.family == "zamba2" else 0
    for res in run["ranks"]:
        n = res[case]["counts"]["decode"]
        if cfg.family == "rwkv6":
            want = {"all_gather/rkvg": L, "reduce_scatter/lora": L,
                    "all_reduce/readout": L, "all_gather/act": 2 * L,
                    "reduce_scatter/act": L}
        else:
            want = {"all_gather/proj": L, "all_reduce/readout": L,
                    "all_reduce/act": L + 2 * apps}
        for k, v in want.items():
            assert n[k] == v, (k, n)
        assert n.get("broadcast/state", 0) == on_l * L
        assert n.get("all_gather/state", 0) == on_rows * L
        assert "all_reduce_max/combine" not in n


def test_recurrent_layouts_on_the_test_meshes():
    """``decode_state_specs`` on the test meshes: the wkv and SSD states'
    dim 3 (the readout's contracted dim) over "model" wherever it splits;
    rwkv6's token shifts on the layers on (4, 2) (2 layers), whole on
    (2, 4); the conv states on the layers on both; at batch 2 on (4, 2)
    the shifts' and conv's batch rows over "model" (no "data" split)."""
    def split(tag, shape, batch=8):
        cfg = CFGS[tag][0]
        mesh = sharding.abstract_mesh(shape, ("data", "model"))
        return {k: _split_dim(v[0]) for k, v in _layout(
            cfg, mesh, batch, 32).items()}

    assert split("rwkv", (4, 2)) == {"tm_shift": [0], "cm_shift": [0],
                                     "wkv": [3]}
    assert split("rwkv", (2, 4)) == {"tm_shift": [], "cm_shift": [],
                                     "wkv": [3]}
    assert split("rwkv", (4, 2), 2) == {"tm_shift": [1], "cm_shift": [1],
                                        "wkv": [3]}
    for shape in ((4, 2), (2, 4)):
        assert split("mamba", shape) == {"conv": [0], "ssd": [3]}
        assert split("zamba", shape) == {"mamba/conv": [0], "mamba/ssd": [3],
                                         "kv/k": [3], "kv/v": [3]}
    assert set(map(tuple, split("zamba", (8, 1)).values())) == {()}


@pytest.mark.parametrize("arch,want", [
    ("rwkv6-1.6b", {"tm_shift": (None, ("data",), None),
                    "cm_shift": (None, ("data",), None),
                    "wkv": (None, ("data",), None, "model", None)}),
    ("zamba2-1.2b", {"mamba/conv": (None, ("data",), None, None),
                     "mamba/ssd": (None, ("data",), None, "model", None),
                     "kv/k": (None, ("data",), None, "model", None),
                     "kv/v": (None, ("data",), None, "model", None)})])
def test_recurrent_state_layout_on_the_pod(arch, want):
    """``decode_32k`` on the 16x16 pod (batch 128): rwkv6-1.6b's wkv state
    on its keys (4 of every head's 64 a rank), its 24 layers' shifts whole
    (16 does not divide 24); zamba2-1.2b's SSD state on ds (4 of 64), its
    conv states whole (38 layers), its shared block's caches on their KV
    heads."""
    cfg = configs.get_config(arch)
    got = _layout(cfg, sharding.abstract_mesh((16, 16), ("data", "model")),
                  128, 32768)
    assert {k: tuple(v[0]) for k, v in got.items()} == want


# ----------------------------------------------------------------------------
# the encoder-decoder on 8 ranks
# ----------------------------------------------------------------------------

def _encdec_layout(case):
    """(self layout, cross layout, L) of an encoder-decoder case, from
    ``sharding.encdec_layout``."""
    from repro_torch.models import encdec
    cfg, batch, mesh_shape, max_len = _case(case)
    lay = sharding.encdec_layout(
        transformer.serving_cfg(cfg),
        sharding.abstract_mesh(mesh_shape, ("data", "model")), batch, max_len)
    self_at = _split_dim(lay["k"][0])
    return ({(): None, (3,): "heads", (2,): "seq"}.get(tuple(self_at),
                                                       "other"),
            encdec._cross_spec_layout(lay["cross_k"][0]), cfg.n_layers)


@pytest.mark.parametrize("case", ENCDEC)
def test_encdec_ranks_hold_their_shards_and_move_no_stack(run, case):
    """Every rank's parameters (prefill's and the decode step's) are its
    ``param_specs`` shards; a decode step gathers no weight but the
    embedding and the LM head; no self or cross K/V leaf is gathered or
    broadcast, whole or a layer: the only collective of the state is, where
    the cross K/V are split by the layers, the broadcast of each layer's
    cross-attention output (B/dp, 1, H hd) by the rank that holds it."""
    cfg, batch, mesh_shape, _ = _case(case)
    dcfg = transformer.serving_cfg(cfg)
    _, cross, L = _encdec_layout(case)
    width = cfg.n_heads * cfg.resolved_head_dim
    for r, res in enumerate(run["ranks"]):
        held = res[case]
        assert held["params"] == _expected_params(cfg, mesh_shape, r)
        dec = _expected_params(dcfg, mesh_shape, r)
        assert held["decode_params"] == dec
        readable = {tuple(v) for k, v in dec.items()
                    if k.startswith("embed.")}
        for shape in held["decode_gathered"]:
            assert tuple(shape) in readable, shape
        moved = held["decode_moved"]
        if cross == "layers":
            rows = len(held["rows"])
            assert moved == [["broadcast", "cross", [rows, 1, width]]] * L
        else:
            assert moved == []


@pytest.mark.parametrize("case", [c for c in ENCDEC if not c.endswith("x1")])
def test_the_collectives_an_encdec_decode_layer_issues(run, case):
    """One decode step's collectives a layer, by layout.  Self-attention:
    "heads" one all-reduce (wo); "seq" the q/k/v column slices gathered,
    the combine's max and sum, one all-reduce.  Cross-attention: "heads"
    one all-reduce; otherwise q's column slices gathered and one
    all-reduce (o's columns by wo's rows), with "frames" the LSE
    combine's max and sum and "layers" one broadcast of o.  The MLP one
    all-reduce."""
    self_layout, cross, L = _encdec_layout(case)
    for res in run["ranks"]:
        n = res[case]["counts"]["decode"]
        assert n["all_reduce/act"] == 3 * L
        assert n.get("all_gather/qkv", 0) == (L if self_layout == "seq"
                                              else 0)
        assert n.get("all_gather/q", 0) == (0 if cross == "heads" else L)
        splits = (self_layout == "seq") + (cross == "frames")
        assert n.get("all_reduce_max/combine", 0) == splits * L
        assert n.get("all_reduce/combine", 0) == splits * L
        assert n.get("broadcast/cross", 0) == (L if cross == "layers"
                                               else 0)
        assert not any(k.endswith("/cache") or (
            k.endswith("/cross") and not k.startswith("broadcast"))
            for k in n)


def test_encdec_layouts_on_the_test_meshes(run):
    """The cases' layouts (self K/V, cross K/V): the reduced whisper's 2
    KV heads divide (4, 2)'s "model" (heads, heads), not (2, 4)'s or (1,
    8)'s, whose sequence (32) and 8 frames do (seq, frames); with 6
    frames and 4 layers (2, 4) splits the cross K/V's layers and (1, 8)
    nothing of them; at batch 2 on (4, 2) the heads, the batch over no
    axis."""
    got = {c: _encdec_layout(c)[:2] for c in ENCDEC}
    assert got == {
        "whisper_8x1": (None, None), "whisper_4x2": ("heads", "heads"),
        "whisper_2x4": ("seq", "frames"), "whisper_1x8": ("seq", "frames"),
        "whisper6x4_2x4": ("seq", "layers"),
        "whisper6x4_1x8": ("seq", None),
        "whisperb2_4x2": ("heads", "heads"),
        "whisper-bf16_2x4": ("seq", "frames")}
    for r, res in enumerate(run["ranks"]):
        for c in ENCDEC:
            assert res[c]["layout"] == got[c][0], (r, c)


@pytest.mark.parametrize("name,kw,batch,mesh_shape,max_len", [
    ("whisper-large-v3", {}, 128, (16, 16), 32768),
    ("whisper-large-v3", {}, 8, (1, 8), 72),
    ("whisper-large-v3", {}, 8, (1, 4), 72),
    ("whisper-large-v3", {}, 2, (1, 3), 72),
    ("reduced", {}, 8, (4, 2), 32),
    ("reduced", {}, 8, (2, 4), 32),
    ("reduced", {}, 8, (1, 8), 32),
    ("reduced", dict(n_frames=6, n_layers=4), 8, (2, 4), 32),
    ("reduced", dict(n_frames=6, n_layers=4), 8, (1, 8), 32),
    ("reduced", {}, 2, (4, 2), 32)])
def test_encdec_layout_is_jax_decode_state_specs(name, kw, batch, mesh_shape,
                                                 max_len):
    """``sharding.encdec_layout`` against JAX's ``decode_state_specs`` on
    JAX's state shapes (self (L, B, S, Hkv, hd), cross (L, B, F, Hkv,
    hd)): the self specs equal, the cross specs with entries 2 and 3
    swapped onto the port's (L, B, Hkv, F, hd); on the pod (batch 128)
    the self K/V on the sequence and the cross K/V on the layers, the
    batch over "data"; on the production widths (1, 8) gives the pod's
    layouts, (1, 4) the heads, (1, 3) the sequence and the frames."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.parallel import sharding as jsharding

    def cfg_of(mod):
        if name == "reduced":
            return dataclasses.replace(
                mod.get_reduced("whisper-large-v3"), **kw)
        return mod.get_config(name)

    cfg, jcfg = cfg_of(configs), cfg_of(jconfigs)
    mesh = sharding.abstract_mesh(mesh_shape, ("data", "model"))
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    sd = jax.ShapeDtypeStruct
    shapes = {"k": sd((L, batch, max_len, Hkv, hd), jnp.float32),
              "cross_k": sd((L, batch, cfg.n_frames, Hkv, hd), jnp.float32)}
    def axes(spec):      # JAX writes an entry of one axis as its name
        return tuple(sharding.spec_axes(e) for e in spec)

    want = jsharding.decode_state_specs(jcfg, shapes, mesh, batch)
    got = sharding.encdec_layout(cfg, mesh, batch, max_len)
    assert axes(got["k"][0]) == axes(want["k"])
    assert axes(got["v"][0]) == axes(want["k"])
    w = axes(want["cross_k"])
    assert axes(got["cross_k"][0]) == w[:2] + (w[3], w[2]) + w[4:]
    assert got["cross_k"][1] == (L, batch, Hkv, cfg.n_frames, hd)
    assert got["cross_v"] == got["cross_k"]
    if mesh_shape == (16, 16):
        assert axes(got["k"][0]) == ((), ("data",), ("model",), (), ())
        assert axes(got["cross_k"][0]) == (("model",), ("data",), (), (),
                                           ())


# ----------------------------------------------------------------------------
# the recurrent rank programs in one process: ranks as threads
# ----------------------------------------------------------------------------

class _Line:
    """The ranks of one "model" line meeting at in-process collectives:
    each deposits its tensor, and every rank reads them all in rank
    order."""

    def __init__(self, n: int) -> None:
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n)

    def exchange(self, rank: int, x):
        self.slots[rank] = x
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts


class _Group:
    def __init__(self, line: _Line, rank: int) -> None:
        self.line, self.rank, self.size = line, rank, line.n


class _Mesh:
    """A (1, tp) mesh that plays rank ``rank`` of the "model" line."""

    def __init__(self, line: _Line, rank: int) -> None:
        self.shape = {"data": 1, "model": line.n}
        self.axis_names = ("data", "model")
        self.rank, self._group = rank, _Group(line, rank)

    def axis_index(self, axis):
        return self.rank if axis == "model" else 0

    def group(self, axis):
        return self._group


@pytest.fixture
def lockstep(monkeypatch):
    """``lockstep(tp, fn)``: fn(mesh) on tp threads, one a rank, the
    collectives of ``spmd`` among them; returns the ranks' results."""
    def gather(x, dim, group, n):
        return torch.cat(group.line.exchange(group.rank, x), dim)

    def scatter(x, dim, group, n):
        total = sum(group.line.exchange(group.rank, x))
        return total.chunk(n, dim)[group.rank]

    def reduce(x, group, op=None):
        parts = group.line.exchange(group.rank, x)
        if op is not None and op != torch.distributed.ReduceOp.SUM:
            return torch.stack(parts).amax(0)
        return sum(parts)

    monkeypatch.setattr(spmd, "_gather", gather)
    monkeypatch.setattr(spmd, "_scatter", scatter)
    monkeypatch.setattr(spmd, "_reduce", reduce)

    def run(tp, fn):
        line, out, errors = _Line(tp), [None] * tp, []

        def one(r):
            try:
                with torch.no_grad():
                    out[r] = fn(_Mesh(line, r))
            except BaseException as e:      # surfaced below
                errors.append(e)
                line.barrier.abort()

        threads = [threading.Thread(target=one, args=(r,))
                   for r in range(tp)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out
    return run


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
def test_k4_split_plain_version_sums_to_the_full_step(tp):
    """``ref.rwkv6_scan_split`` on tp slices of the 64 keys: its state
    rows are the full-state step's rows, and the sum of its readout parts
    the full readout (``ref.rwkv6_scan`` at S = 1, fp32)."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(tp)
    B, H, dh = 3, 4, 64
    r, k, v = (torch.randn(B, 1, H, dh, generator=g) for _ in range(3))
    w = torch.rand(B, 1, H, dh, generator=g) * 0.5 + 0.45
    u = torch.randn(H, dh, generator=g) * 0.1
    s0 = torch.randn(B, H, dh, dh, generator=g)
    y, s = ref.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
    dk, parts = dh // tp, []
    for i in range(tp):
        keys = slice(i * dk, (i + 1) * dk)
        yp, sp = ref.rwkv6_scan_split(
            *(t[..., keys].contiguous() for t in (r, k)), v,
            w[..., keys].contiguous(), u[:, keys], s0[:, :, keys])
        assert yp.dtype == sp.dtype == torch.float32
        assert yp.shape == (B, 1, H, dh) and sp.shape == (B, H, dk, dh)
        torch.testing.assert_close(sp, s[:, :, keys], rtol=1e-6, atol=1e-6)
        parts.append(yp)
    torch.testing.assert_close(sum(parts), y, rtol=1e-5, atol=1e-5)


def _block(module, name, **over):
    import dataclasses
    cfg = dataclasses.replace(configs.get_reduced(name), **over)
    return cfg, module(cfg, torch.Generator().manual_seed(5), "cpu")


@pytest.mark.parametrize("tp", [2, 4])
def test_mamba_ds_split_step_counts_d_x_once(lockstep, tp):
    """``ssm.mamba_decode_ds`` on tp ranks, each holding ds/tp of the SSD
    state's rows, against the plain ``mamba_decode_step``: the output on
    every rank, the conv state and each rank's new rows.  D is 3 (the
    reduced config's is 1), so adding D x on every rank, not once after
    the readout's sum, would miss by (tp - 1) 3 x."""
    from repro_torch.models import ssm
    cfg, blk = _block(ssm.MambaBlock, "zamba2-1.2b")
    p = blk.mixer
    p.D.data.fill_(3.0)
    d_inner, H, ds, cw = ssm._dims(cfg)
    g = torch.Generator().manual_seed(1)
    hx = torch.randn(2, 1, cfg.d_model, generator=g)
    conv = torch.randn(2, cw - 1, d_inner + 2 * ds, generator=g)
    ssd = torch.randn(2, H, ds, cfg.ssm.head_dim, generator=g)
    with torch.no_grad():
        out, conv1, ssd1 = ssm.mamba_decode_step(cfg, p, hx, conv, ssd)
    n = ds // tp
    got = lockstep(tp, lambda mesh: ssm.mamba_decode_ds(
        cfg, p, hx, conv, ssd[:, :, mesh.rank * n:(mesh.rank + 1) * n],
        mesh))
    for r, (o, c, s) in enumerate(got):
        torch.testing.assert_close(o, out, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(c, conv1, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(s, ssd1[:, :, r * n:(r + 1) * n],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tp", [2, 4])
def test_rwkv6_key_split_time_mix_is_the_plain_step(lockstep, tp):
    """``rwkv._time_mix_keys`` on tp ranks, each holding dh/tp of every
    head's keys of the wkv state (u's bonus for its keys in its part of
    the readout), against the plain ``time_mix`` with the whole state."""
    from repro_torch.models import rwkv
    cfg, blk = _block(rwkv.RwkvBlock, "rwkv6-1.6b")
    H, hd = rwkv._heads(cfg)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 1, cfg.d_model, generator=g)
    prev = torch.randn(2, cfg.d_model, generator=g)
    wkv = torch.randn(2, H, hd, hd, generator=g)
    with torch.no_grad():
        out, (_, wkv1) = rwkv.time_mix(cfg, blk.tm, x, state=(prev, wkv))
    n = hd // tp
    got = lockstep(tp, lambda mesh: rwkv._time_mix_keys(
        cfg, blk.tm, x, prev,
        wkv[:, :, mesh.rank * n:(mesh.rank + 1) * n], mesh))
    for r, (o, (last, s)) in enumerate(got):
        torch.testing.assert_close(o, out, rtol=1e-5, atol=1e-5)
        assert torch.equal(last, x[:, -1])
        torch.testing.assert_close(s, wkv1[:, :, r * n:(r + 1) * n],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,family", [
    ("rwkv6-1.6b", None), ("zamba2-1.2b", "mamba2"), ("zamba2-1.2b", None)])
def test_recurrent_serving_on_one_rank_is_the_plain_path(name, family):
    """On a 1 x 1 mesh (a "model" line of one rank) ``prefill`` and
    ``decode_step`` are the plain path's, bitwise."""
    import dataclasses

    cfg = configs.get_reduced(name)
    if family:
        cfg = dataclasses.replace(cfg, family=family)
    model = api.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 5),
                         generator=torch.Generator().manual_seed(1))
    kw = {"max_len": 8} if cfg.family == "zamba2" else {}

    def serve():
        with torch.no_grad():
            lg, st = model.prefill(params, {"tokens": toks}, **kw)
            l2, st = model.decode_step(params, lg.argmax(-1), st, 5)
        return lg, l2, tdc.state_leaves(st)

    want = serve()
    sharding.set_runtime_mesh(Mesh((1, 1), ("data", "model"), [0],
                                   abstract_rank=0), sharding.P("data"))
    try:
        got = serve()
    finally:
        sharding.set_runtime_mesh(None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].keys() == want[2].keys()
    assert all(torch.equal(got[2][k], want[2][k]) for k in want[2])


@pytest.mark.parametrize("name,family", [
    ("rwkv6-1.6b", None), ("zamba2-1.2b", "mamba2"), ("zamba2-1.2b", None)])
def test_recurrent_decode_refuses_a_shard_of_another_shape(name, family):
    """Under a mesh the decode step reads its state's layout from the
    global batch (and zamba2's carried cache depth), never from a shard's
    shape: a state whose shards are not ``decode_state_specs``' raises
    before anything moves, as does a zamba2 state without its depth."""
    import dataclasses

    cfg = configs.get_reduced(name)
    if family:
        cfg = dataclasses.replace(cfg, family=family)
    model = api.get_model(cfg)
    mesh = Mesh((2, 4), ("data", "model"), range(8), abstract_rank=1)
    params = weights.model_class(cfg)(cfg, device="meta")
    shard_params(cfg, params, mesh)
    state = _whole_state(cfg, 8, 16)       # every leaf whole: wrong
    if cfg.family == "zamba2":
        state["max_len"] = 16
    token = torch.zeros((4, 1), dtype=torch.long, device="meta")
    sharding.set_runtime_mesh(mesh, sharding.P("data"))
    spmd.reset_counts()
    try:
        with pytest.raises(ValueError, match="decode_state_specs gives"):
            model.decode_step(params, token, state, 3)
        if cfg.family == "zamba2":
            del state["max_len"]
            with pytest.raises(ValueError, match="max_len"):
                model.decode_step(params, token, state, 3)
    finally:
        sharding.set_runtime_mesh(None)
    assert not spmd.counts


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("attn_dtype", ["f32", "bf16"])
def test_encdec_frames_combine_is_whole_cross_attention(lockstep, tp,
                                                        attn_dtype):
    """The "frames" layout's cross-attention in a decode step
    (``encdec._cross_decode``) on tp ranks, each holding F/tp of the
    frames: every head's q from the rank's column slices, K2's function
    with its LSE on the rank's frames, the slices combined by their
    log-sum-exp and o's columns by wo's rows summed over "model", against
    the plain ``attn_cross`` over every frame.  fp32 compute to 1e-5; bf16
    compute rounds each slice's probabilities to bf16 where the whole
    row's are rounded, and each slice's output, so to 2^-6 of the largest
    output."""
    import dataclasses

    from repro_torch.models import encdec
    cfg = dataclasses.replace(configs.get_reduced("whisper-large-v3"),
                              n_frames=16, attn_dtype=attn_dtype)
    g = torch.Generator().manual_seed(4)
    lp = encdec.DecLayer(cfg, g, "cpu")
    B, Hkv, hd, Fr = 3, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_frames
    x = torch.randn(B, 1, cfg.d_model, generator=g)
    k, v = (torch.randn(B, Hkv, Fr, hd, generator=g) for _ in range(2))
    with torch.no_grad():
        want = attention.attn_cross(cfg, lp.cross_attn, x, (k, v))
    n = Fr // tp
    spec = sharding.P(None, None, None, "model", None)

    def rank(mesh):
        i = mesh.rank
        state = {"cross_k": k[None, :, :, i * n:(i + 1) * n].contiguous(),
                 "cross_v": v[None, :, :, i * n:(i + 1) * n].contiguous()}
        return encdec._cross_decode(cfg, lp.cross_attn, x, state, 0, spec,
                                    mesh)

    got = lockstep(tp, rank)
    for r, o in enumerate(got):
        if attn_dtype == "f32":
            torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-5)
        else:
            assert (o - want).abs().max() <= 2.0 ** -6 * want.abs().max(), r


def test_k2_lse_plain_version_is_the_rows_logsumexp():
    """``ops.flash_attention(..., return_lse=True)`` on the CPU (the plain
    version): the output is the one without the LSE; the LSE is each
    row's log-sum-exp of its scaled logits over the keys it sees (causal,
    grouped heads), +inf for a row that sees none (K2's convention); on
    meta the shapes, fp32."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(6)
    q = torch.randn(2, 4, 5, 16, generator=g)
    k, v = (torch.randn(2, 2, 3, 16, generator=g) for _ in range(2))
    o, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(o, ops.flash_attention(q, k, v, causal=True))
    logits = torch.einsum("bhqd,bhkd->bhqk", q * 16 ** -0.5,
                          k.repeat_interleave(2, 1))
    seen = torch.arange(3)[None, :] <= torch.arange(5)[:, None] - 2
    want = torch.logsumexp(logits.masked_fill(~seen, float("-inf")), -1)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 5)
    assert torch.isinf(lse[:, :, :2]).all() and (lse[:, :, :2] > 0).all()
    torch.testing.assert_close(lse[:, :, 2:], want[:, :, 2:], rtol=1e-6,
                               atol=1e-6)
    mo, ml = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                 causal=False, return_lse=True)
    assert mo.shape == q.shape and ml.shape == (2, 4, 5)
    assert ml.dtype == torch.float32 and ml.device.type == "meta"


def test_encdec_serving_on_one_rank_is_the_plain_path():
    """On a 1 x 1 mesh (a "model" line of one rank) whisper's ``prefill``
    and ``decode_step`` are the plain path's, bitwise."""
    cfg = configs.get_reduced("whisper-large-v3")
    model = api.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 5), generator=g),
             "frames": torch.randn(2, cfg.n_frames, cfg.d_model,
                                   generator=g)}

    def serve():
        with torch.no_grad():
            lg, st = model.prefill(params, batch, max_len=8)
            l2, st = model.decode_step(params, lg.argmax(-1), st, 5)
        return lg, l2, tdc.state_leaves(st)

    want = serve()
    sharding.set_runtime_mesh(Mesh((1, 1), ("data", "model"), [0],
                                   abstract_rank=0), sharding.P("data"))
    try:
        got = serve()
    finally:
        sharding.set_runtime_mesh(None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].keys() == want[2].keys()
    assert all(torch.equal(got[2][k], want[2][k]) for k in want[2])


def test_encdec_decode_refuses_a_shard_of_another_shape():
    """Under a mesh whisper's decode step reads its state's layout from the
    global batch and the carried depth, never from a shard's shape: a
    state whose leaves are whole, or a cross K/V left in JAX's layout,
    raises before anything moves, as does a state without its depth.
    16 frames, so that a rank's quarter of them (4) is not the KV heads'
    count (2)."""
    import dataclasses

    cfg = dataclasses.replace(configs.get_reduced("whisper-large-v3"),
                              n_frames=16)
    model = api.get_model(cfg)
    mesh = Mesh((2, 4), ("data", "model"), range(8), abstract_rank=1)
    params = weights.model_class(cfg)(cfg, device="meta")
    shard_params(cfg, params, mesh)
    lay = sharding.encdec_layout(cfg, mesh, 8, 16)

    def meta(shape):
        return torch.empty(shape, device="meta")

    whole = {n: meta(shape) for n, (_, shape) in lay.items()}
    jax_cross = {n: meta(sharding.local_shape(spec, shape, mesh))
                 for n, (spec, shape) in lay.items()}
    for n in ("cross_k", "cross_v"):
        t = jax_cross[n]
        jax_cross[n] = t.transpose(2, 3)       # (L, B, F/4, Hkv, hd)
    token = torch.zeros((4, 1), dtype=torch.long, device="meta")
    sharding.set_runtime_mesh(mesh, sharding.P("data"))
    spmd.reset_counts()
    try:
        for state in (whole, jax_cross):
            with pytest.raises(ValueError, match="decode_state_specs gives"):
                model.decode_step(params, token, dict(state, max_len=16), 3)
        with pytest.raises(ValueError, match="max_len"):
            model.decode_step(params, token, whole, 3)
    finally:
        sharding.set_runtime_mesh(None)
    assert not spmd.counts


# ----------------------------------------------------------------------------
# the combine, in one process
# ----------------------------------------------------------------------------

def _decode_case(attn_dtype, B=3, H=8, Hkv=2, S=64, D=16, seed=0):
    cfg = ArchCfg(name="t", family="dense", n_layers=1, d_model=H * D,
                  n_heads=H, n_kv_heads=Hkv, d_ff=32, vocab=16,
                  attn_dtype=attn_dtype, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, D, generator=g).to(torch.bfloat16)
    k = torch.randn(B, S, Hkv, D, generator=g).to(torch.bfloat16)
    v = torch.randn(B, S, Hkv, D, generator=g).to(torch.bfloat16)
    return cfg, q, k, v


@pytest.mark.parametrize("attn_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [3, 20, 63])
def test_combine_of_slices_equals_whole_sequence_attention(attn_dtype, pos):
    """``combine_partials`` of 4 slices' ``decode_partials`` against
    ``attend_decode`` over the whole cache: pos 3 leaves slices 1-3 empty,
    pos 20 slices 2-3, pos 63 none.  fp32 compute to 2e-6; bf16 compute
    rounds each slice's probabilities to bf16 where the whole row's are
    rounded, so to 2^-7 of the largest output (two bf16 roundings)."""
    cfg, q, k, v = _decode_case(attn_dtype)
    S, R = k.shape[1], 4
    visible = torch.arange(S) <= pos
    whole = attention.attend_decode(cfg, q, k, v, visible)
    parts = [attention.decode_partials(cfg, q, k[:, i:i + S // R],
                                       v[:, i:i + S // R],
                                       visible[i:i + S // R])
             for i in range(0, S, S // R)]
    o, m, l = (torch.stack(t) for t in zip(*parts))
    empty = (~torch.isfinite(m)).all(-1).all(-1)
    assert empty.tolist() == [i * S // R > pos for i in range(R)]
    assert (l[empty] == 0).all() and (o[empty] == 0).all()
    got = attention.combine_partials(o, m, l)
    assert torch.isfinite(got).all()
    if attn_dtype == "f32":
        torch.testing.assert_close(got, whole, rtol=2e-6, atol=2e-6)
    else:
        assert (got - whole).abs().max() <= 2.0 ** -7 * whole.abs().max()


def test_one_slice_combines_to_itself_and_none_visible_gives_zero():
    cfg, q, k, v = _decode_case("f32")
    visible = torch.arange(k.shape[1]) <= 40
    o, m, l = attention.decode_partials(cfg, q, k, v, visible)
    torch.testing.assert_close(
        attention.combine_partials(o[None], m[None], l[None]),
        attention.attend_decode(cfg, q, k, v, visible), rtol=2e-6,
        atol=2e-6)
    none = torch.zeros(k.shape[1], dtype=torch.bool)
    parts = attention.decode_partials(cfg, q, k, v, none)
    got = attention.combine_partials(*(t[None] for t in parts))
    assert torch.equal(got, torch.zeros_like(got))


def test_attn_decode_slice_form_on_one_slice_is_the_plain_form():
    """The "seq" layout's decode attention (``transformer._attn_seq``) on a
    "model" line of one rank, whose slice is the whole cache (the combine
    over a stack of one), writes the same row and gives the same output
    as the plain ``attn_decode``, to fp32 rounding; a position past the
    cache raises."""
    from repro_torch.models import common
    cfg = configs.get_reduced("qwen2-0.5b")
    g = torch.Generator().manual_seed(3)
    lp = transformer.Block(cfg, g, "cpu")
    x = torch.randn(2, 1, cfg.d_model, generator=g)
    hd = cfg.resolved_head_dim
    kc = torch.randn(2, 12, cfg.n_kv_heads, hd, generator=g)
    vc = torch.randn(2, 12, cfg.n_kv_heads, hd, generator=g)
    freqs = common.rope_freqs(cfg, "cpu")
    mesh = Mesh((1, 1), ("data", "model"), range(1), abstract_rank=0)
    a, k1, v1 = attention.attn_decode(cfg, lp.attn, x, kc.clone(),
                                      vc.clone(), 7, freqs=freqs)
    k2, v2 = kc.clone(), vc.clone()
    with torch.no_grad():
        b = transformer._attn_seq(cfg, lp.attn, x, k2, v2, 7, freqs, mesh)
        with pytest.raises(IndexError):
            transformer._attn_seq(cfg, lp.attn, x, kc, vc, 12, freqs, mesh)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_all_reduce_max_refuses_grad_and_reports_an_all_reduce():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        spmd.all_reduce_max(x, None, "model")
    mesh = Mesh((2, 4), ("data", "model"), range(8), abstract_rank=5)
    seen = []
    spmd.collective_sinks.append(lambda *a: seen.append((a[0], a[3])))
    spmd.reset_counts()
    try:
        with torch.no_grad():
            out = spmd.all_reduce_max(torch.empty(3, 5, device="meta"),
                                      mesh, "model", tag="combine")
    finally:
        spmd.collective_sinks.clear()
    assert out.shape == (3, 5) and out.device.type == "meta"
    assert seen == [("all-reduce", 4)]
    assert spmd.counts == {("all_reduce_max", "combine"): 1}


def test_each_staged_collective_finds_its_group(monkeypatch):
    """The host staging of a CUDA tensor on a gloo group (``_staged``)
    reads each collective's group: on an abstract mesh every collective
    is recognised as abstract there and never asks whether to stage (a
    wrong argument taken for the group would ask, with a number)."""
    asked = []
    monkeypatch.setattr(spmd, "_host", lambda x, g: asked.append(g))
    mesh = Mesh((2, 4), ("data", "model"), range(8), abstract_rank=5)
    x = torch.empty(4, 8, device="meta")
    seen = []
    spmd.collective_sinks.append(lambda *a: seen.append(a[0]))
    try:
        with torch.no_grad():
            spmd.all_gather(x, 0, mesh, "model")
            spmd.reduce_scatter(x, 1, mesh, "model")
            spmd.all_reduce(x, mesh, "model")
            spmd.all_reduce_max(x, mesh, "model")
            spmd.all_to_all(x, 0, 1, mesh, "model")
            spmd.broadcast(x, 1, mesh, "model")
    finally:
        spmd.collective_sinks.clear()
    assert not asked
    assert seen == ["all-gather", "reduce-scatter", "all-reduce",
                    "all-reduce", "all-to-all", "broadcast"]


@pytest.mark.parametrize("arch,layout", [
    ("deepseek-7b", "heads"), ("olmoe-1b-7b", "heads"),
    ("moonshot-v1-16b-a3b", "heads"), ("internvl2-76b", "seq"),
    ("qwen2-0.5b", "seq"), ("starcoder2-3b", "seq"), ("smollm-135m", "seq")])
def test_cache_layout_on_the_pod(arch, layout):
    """``decode_32k`` on the 16x16 pod (batch 128, 32768 deep): the KV
    heads over "model" where 16 divides them, else the sequence; the
    batch over "data" either way."""
    cfg = transformer.serving_cfg(configs.get_config(arch))
    got, spec = sharding.cache_layout(
        cfg, sharding.abstract_mesh((16, 16), ("data", "model")), 128, 32768)
    assert got == layout
    assert sharding.spec_axes(spec[1]) == ("data",)
