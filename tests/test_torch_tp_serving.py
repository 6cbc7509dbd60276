"""Tensor-parallel serving of the decoder families (``prefill`` and
``decode_step`` under a runtime mesh) against the JAX package's, on the CPU.

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
its bf16 attention on (2, 4)).  Each case prefills an 8-token prompt into
a 32-deep cache (24 and 48 for those TINY cases, 17 for ODD) and takes 8
greedy decode steps.

Bars: fp32 logits (prefill's last and 8 decode steps') rtol 1e-4 / atol
1e-5 against JAX's partitioned run; greedy tokens identical; each rank's
cache shard equal to the ``decode_state_specs`` slice of JAX's cache at
rtol 1e-5 (atol 1e-5 of its largest value).  The "seq" layout combines its slices'
softmaxes by their log-sum-exp, so under bf16 attention it rounds each
slice's probabilities where JAX rounds the whole row's: that case is fed
JAX's tokens and held to 2^-6 of the largest logit.  The combine itself
is held here in one process against whole-sequence attention.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs, weights  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.common import ArchCfg  # noqa: E402
from repro_torch.parallel import sharding, spmd  # noqa: E402
from repro_torch.runtime.trainer import shard_params  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as tdc  # noqa: E402

CFGS = tdc.serve_cfgs(configs, ArchCfg, torch.float32)
CASES = [tdc._tag(t, s) for t, (_, _, meshes, _) in CFGS.items()
         for s in meshes]
EXACT = [c for c in CASES if c.split("_")[0] not in tdc.SERVE_FORCED]
FORCED = [c for c in CASES if c.split("_")[0] in tdc.SERVE_FORCED]
RTOL, ATOL = 1e-4, 1e-5
BF16_BAR = 2.0 ** -6


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
    """Each rank's cache, after prefill and after the 8 decode steps, is
    its ``decode_state_specs`` slice (the serving config's: TP specs even
    under dp_only) of JAX's cache, and holds nothing else."""
    cfg, batch, mesh_shape, _ = _case(case)
    mesh = sharding.abstract_mesh(mesh_shape, ("data", "model"))
    want = run["jax"](case)
    spec = sharding.decode_state_specs(
        transformer.serving_cfg(cfg), {"k": want["k"]}, mesh, batch)["k"]
    forced = case.split("_")[0] in tdc.SERVE_FORCED
    for r, arr in enumerate(run["arrays"]):
        for name in ("prefill_k", "prefill_v", "k", "v"):
            w = _shard_np(want[name], spec, mesh_shape, r)
            got = arr[f"{case}/{name}"]
            assert got.shape == w.shape, (r, name)
            if forced and not name.startswith("prefill"):
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


@pytest.mark.parametrize("case", CASES)
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


@pytest.mark.parametrize("case", [c for c in CASES if c.endswith("x2")
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
    for case in [c for c in CASES if c.endswith("_2x4")]:
        for res in run["ranks"]:
            if res[case]["layout"] == "seq":
                assert res[case]["finite"], case


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
        b = transformer._attn_seq(cfg, lp, x, k2, v2, 7, freqs, mesh)
        with pytest.raises(IndexError):
            transformer._attn_seq(cfg, lp, x, kc, vc, 12, freqs, mesh)
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
