"""The port's dry run (``repro_torch.launch.dryrun``) and its op-level
analyzer (``repro_torch.launch.op_analysis``), against the JAX package's
``launch/dryrun.py`` and ``launch/hlo_analysis.py``.

The cells and the useful-FLOP formula equal JAX's exactly; the analyzer
mirrors each case of ``tests/test_hlo_analysis.py`` (the port runs its
loops unrolled, so a loop's work is counted once a pass, with no trip
count to find); the kernels' costs reported on meta equal
``kernels/cost.py``; the collectives of an abstract mesh report JAX's ring
link bytes; and one production cell runs in-process with
``tests/test_dryrun.py``'s bars.  Nothing here allocates a full-size
tensor: every large tensor is on the meta device.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

jax.devices()   # JAX's backend up before its dryrun module sets XLA_FLAGS

from repro import configs as jconfigs  # noqa: E402
from repro.launch import hlo_analysis as H  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import configs, weights  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.parallel import sharding, spmd  # noqa: E402

ARCHS = [configs.canonical(a) for a in configs.ALL_ARCHS]


@pytest.fixture(scope="module")
def jdryrun():
    """JAX's dryrun module, imported with the environment kept as it was
    (its first line sets XLA_FLAGS for a process of its own)."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jd


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


# ----------------------------------------------------------------------------
# cells and the useful-FLOP formula
# ----------------------------------------------------------------------------

def test_cells_equal_jax(jdryrun):
    meshes = ["pod", "multipod"]
    cells = list(dryrun.all_cells(ARCHS, None, meshes))
    assert cells == list(jdryrun.all_cells(
        [jconfigs.canonical(a) for a in jconfigs.ALL_ARCHS], None, meshes))
    # 10 archs x 3 shapes + 2 long_500k (zamba2, rwkv6) = 32 per mesh
    assert len(cells) == 64
    longs = sorted({c[0] for c in cells if c[1] == "long_500k"})
    assert longs == ["rwkv6-1_6b", "zamba2-1_2b"]
    for arch in configs.ALL_ARCHS:
        cfg = configs.get_config(arch)
        assert ("long_500k" in api.applicable_shapes(cfg)) == \
            (not cfg.full_attention)


def test_variants_equal_jax(jdryrun):
    assert dryrun.VARIANTS.keys() == jdryrun.VARIANTS.keys()
    for name, v in dryrun.VARIANTS.items():
        jv = jdryrun.VARIANTS[name]
        assert (v.remat, v.donate, v.grad_accum, v.cfg_overrides) == \
            (jv.remat, jv.donate, jv.grad_accum, jv.cfg_overrides), name


@pytest.mark.parametrize("arch", ARCHS)
def test_model_attn_flops_equal_jax(jdryrun, arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name, shape in api.SHAPES.items():
        for decode in (False, True):
            assert dryrun.model_attn_flops(cfg, shape, decode=decode) == \
                jdryrun.model_attn_flops(jcfg, japi.SHAPES[name],
                                         decode=decode), (name, decode)


def test_list_prints_jax_cells(capsys, jdryrun):
    assert dryrun.main(["--list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "64 cells"
    assert [tuple(ln.split()) for ln in out[:-1]] == list(
        jdryrun.all_cells([jconfigs.canonical(a)
                           for a in jconfigs.ALL_ARCHS], None,
                          ["pod", "multipod"]))


# ----------------------------------------------------------------------------
# the analyzer: tests/test_hlo_analysis.py's cases
# ----------------------------------------------------------------------------

def analyze(fn, *args):
    with OA.OpAnalysis(args) as a:
        fn(*args)
    return a.result


def test_matmul_flops_exact():
    a = analyze(lambda x, w: x @ w, meta(64, 128), meta(128, 32))
    assert a.flops == 2 * 64 * 128 * 32


def test_batched_dot_flops():
    a = analyze(lambda x, w: torch.einsum("bij,bjk->bik", x, w),
                meta(4, 8, 16), meta(4, 16, 8))
    assert a.flops == 2 * 4 * 8 * 16 * 8


@pytest.mark.parametrize("loops", [(11,), (3, 5)])
def test_loops_count_every_pass(loops):
    """JAX's scans need a trip count; the port's layer loops run in
    Python, so each pass is dispatched and counted (one loop, and one
    nested in another)."""
    d, L = 16, 1
    for n in loops:
        L *= n

    def fn(x, ws):
        for i in range(L):
            x = torch.tanh(x @ ws[i])
        return x

    a = analyze(fn, meta(8, d), meta(L, d, d))
    assert a.flops == L * 2 * 8 * d * d


def test_bytes_are_sane():
    nb = 256 * 256 * 4
    a = analyze(lambda x: (x @ x).sum(), meta(256, 256))
    # at least: read x twice + write result; far below pathological 10x
    assert 2 * nb <= a.bytes <= 12 * nb


def test_written_operands_count_once():
    nb = 1024 * 4
    a = analyze(lambda x, y: x.copy_(y), meta(1024), meta(1024))
    assert a.bytes == 2 * nb               # y read, x written
    a = analyze(lambda x: x.zero_(), meta(1024))
    assert a.bytes == nb


@pytest.fixture
def line4():
    return Mesh((4,), ("x",), range(4), abstract_rank=1)


def test_collectives_parsed_with_ring_multipliers(line4):
    nb = 16 * 128 * 4

    def fn(x, y):
        spmd.all_reduce(x, line4, "x")
        spmd.all_gather(y, 0, line4, "x")      # (4, 128) -> (16, 128)

    a = analyze(fn, meta(16, 128), meta(4, 128))
    assert a.collectives["all-reduce"]["count"] == 1
    assert a.collectives["all-reduce"]["link_bytes"] == 2 * nb
    assert a.collectives["all-gather"]["link_bytes"] == nb
    assert a.link_bytes == 3 * nb
    assert a.top_buffers(1)[0] == ("all-reduce f32[16,128]", 2 * nb, 1)
    d = OA.analysis_dict(a)
    assert (d["flops"], d["link_bytes"]) == (0, 3 * nb)
    assert d["collectives"] == a.collectives


def test_collectives_in_a_loop_counted_every_pass(line4):
    nb = 64 * 4

    def fn(x):
        for _ in range(24):
            x = spmd.all_reduce(x, line4, "x")

    a = analyze(fn, meta(64))
    assert a.collectives["all-reduce"]["count"] == 24
    assert a.collectives["all-reduce"]["link_bytes"] == 24 * 2 * nb


def test_collective_adjoints_and_reduce_scatter(line4):
    x = meta(8, 32, grad=True)
    with OA.OpAnalysis() as a:
        spmd.all_gather(x, 0, line4, "x").sum().backward()
    rs = a.result.collectives["reduce-scatter"]
    assert rs["count"] == 1 and rs["operand_bytes"] == 4 * 8 * 32 * 4
    assert rs["link_bytes"] == rs["operand_bytes"]     # 1x the operand
    assert x.grad.shape == x.shape


def test_abstract_mesh_refuses_real_tensors(line4):
    for fn in (lambda t: spmd.all_reduce(t, line4, "x"),
               lambda t: spmd.all_gather(t, 0, line4, "x"),
               lambda t: spmd.reduce_scatter(t, 0, line4, "x"),
               lambda t: spmd.all_to_all(t, 0, 1, line4, "x")):
        with pytest.raises(ValueError, match="meta tensors only"):
            fn(torch.zeros(8, 8))


def test_production_mesh_abstract_and_live():
    m = make_production_mesh(multi_pod=True, abstract=True, rank=37)
    assert m.abstract and m.size == 512
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.coords == (0, 2, 5)
    assert m.group("model").size == 16
    assert m.group(("pod", "data")).size == 32
    # without abstract it needs the world's 256 ranks and a process group
    with pytest.raises(RuntimeError, match="not initialised"):
        make_production_mesh()


# ----------------------------------------------------------------------------
# the kernels' meta route reports cost.py's counts
# ----------------------------------------------------------------------------

def test_meta_attention_reports_k2_and_k2_bwd():
    B, H, Hkv, S, D = 2, 8, 2, 48, 64
    q = meta(B, H, S, D, dtype=torch.bfloat16, grad=True)
    k = meta(B, Hkv, S, D, dtype=torch.bfloat16, grad=True)
    v = meta(B, Hkv, S, D, dtype=torch.bfloat16, grad=True)
    with OA.OpAnalysis() as a:
        out = ops.flash_attention(q, k, v, causal=True)
        out.float().sum().backward()
    assert out.shape == q.shape and out.dtype == q.dtype
    assert q.grad.shape == q.shape and k.grad.dtype == torch.bfloat16
    fw = cost.flash_attention(B, H, Hkv, S, S, D, True, 2)
    bw = cost.flash_attention_bwd(B, H, Hkv, S, S, D, True, 2)
    assert a.result.kernels == {
        "flash_attention": {"count": 1, "flops": int(fw[0]),
                            "bytes": fw[1]},
        "flash_attention_bwd": {"count": 1, "flops": int(bw[0]),
                                "bytes": bw[1]}}


def test_meta_scans_report_forward_and_backward():
    B, S, H, dh, ds = 2, 40, 4, 64, 64
    x = meta(B, S, H, dh, dtype=torch.bfloat16, grad=True)
    dt = meta(B, S, H, grad=True)
    A, Dv = meta(H, grad=True), meta(H, grad=True)
    Bm = meta(B, S, ds, dtype=torch.bfloat16, grad=True)
    Cm = meta(B, S, ds, dtype=torch.bfloat16, grad=True)
    r, k, v, w = (meta(B, S, H, dh, dtype=torch.bfloat16, grad=True)
                  for _ in range(4))
    u = meta(H, dh, grad=True)
    with OA.OpAnalysis() as a:
        y, h = ops.mamba2_scan(x, dt, A, Bm, Cm, Dv, return_state=True)
        y2 = ops.rwkv6_scan(r, k, v, w, u)
        (y.float().sum() + h.sum() + y2.float().sum()).backward()
    assert h.shape == (B, H, ds, dh) and h.dtype == torch.float32
    assert y2.shape == r.shape and dt.grad.dtype == torch.float32
    want = {"mamba2_scan": cost.mamba2_scan(B, S, H, dh, ds, 2),
            "mamba2_scan_bwd": cost.mamba2_scan_bwd(B, S, H, dh, ds, 2),
            "rwkv6_scan": cost.rwkv6_scan(B, S, H, dh, 2, state_out=False),
            "rwkv6_scan_bwd": cost.rwkv6_scan_bwd(B, S, H, dh, 2)}
    assert a.result.kernels == {
        n: {"count": 1, "flops": int(f), "bytes": b}
        for n, (f, b) in want.items()}


def test_meta_paged_attention_counts_the_table_and_refuses_grad():
    B, H, Hkv, D, page, P, W = 4, 8, 2, 64, 16, 40, 6
    q = meta(B, H, D, dtype=torch.bfloat16)
    kp = meta(P, page, Hkv, D, dtype=torch.bfloat16)
    pt = meta(B, W, dtype=torch.int32)
    sl = meta(B, dtype=torch.int32)
    with OA.OpAnalysis() as a:
        out = ops.paged_attention(q, kp, kp, pt, sl)
    assert out.shape == q.shape
    f, b, _ = cost.paged_attention(B, H, Hkv, D, page, W, [W * page] * B, 2)
    assert a.result.kernels["paged_attention"] == {
        "count": 1, "flops": int(f), "bytes": b}
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.paged_attention(meta(B, H, D, grad=True), kp.float(),
                            kp.float(), pt, sl)


# ----------------------------------------------------------------------------
# a model: 6ND, JAX's count, and a production cell
# ----------------------------------------------------------------------------

def test_model_train_flops_match_6nd_and_jax():
    """The reduced smollm's ``grad(train_loss)`` at B = 2, S = 32 lies in
    the 6ND band, and within 5 % of ``hlo_analysis.analyze`` of JAX's
    jitted grad.  Measured (my CPU run): 42 786 816 against JAX's
    44 040 192, 2.85 % below; the whole gap is attention: JAX's dots
    multiply the full S x S score matrix, masked half included, and save
    P for the backward (12 B H D S^2 a layer), where K2 and K2-bwd report
    the pairs the causal mask leaves, S recomputed in the backward (14 B H
    D x 528 of 1024 pairs).  Every other product is counted alike."""
    import jax.numpy as jnp

    B, S = 2, 32
    cfg = configs.get_config("smollm-135m").reduced()
    m = weights.model_class(cfg)(cfg, device="meta")
    for p in m.parameters():
        p.requires_grad_(True)
    batch = {k: meta(B, S, dtype=api.TOKEN_DTYPE)
             for k in ("tokens", "labels")}
    with OA.OpAnalysis() as a:
        api.get_model(cfg).train_loss(m, batch, remat=False).backward()
    flops = a.result.flops
    n = api.param_count(cfg)
    assert 0.5 * 6 * n * B * S <= flops <= 2.0 * 6 * n * B * S

    jcfg = jconfigs.get_config("smollm-135m").reduced()
    jmodel = japi.get_model(jcfg)
    jbatch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
              for k in ("tokens", "labels")}
    grad = jax.jit(jax.grad(lambda p, b: jmodel.train_loss(p, b,
                                                           remat=False)))
    jflops = H.analyze(grad.lower(japi.param_shapes(jcfg),
                                  jbatch).compile().as_text()).flops
    assert abs(flops - jflops) <= 0.05 * jflops
    attn = sum(k["flops"] for k in a.result.kernels.values())
    L, Hh, hd = cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim
    assert jflops - flops == L * 12 * B * Hh * hd * S * S - attn


def test_smollm_multipod_cell_meets_the_dryrun_bars(tmp_path):
    """``tests/test_dryrun.py``'s bars, in-process on meta, through the
    CLI (``--force --out``)."""
    import json
    import time

    t0 = time.perf_counter()
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                        "--mesh", "multipod", "--force", "--out",
                        str(tmp_path)]) == 0
    assert time.perf_counter() - t0 < 60
    out = json.loads(
        (tmp_path / "smollm-135m_train_4k_multipod.json").read_text())
    assert out["chips"] == 512
    assert out["flops_per_device"] > 0
    assert out["link_bytes_per_device"] > 0
    assert out["roofline"]["bottleneck"] in ("compute_s", "memory_s",
                                             "collective_s")
    assert 0.01 <= out["useful_flop_ratio_attn"] <= 3.0
    assert out["useful_flop_ratio"] <= out["useful_flop_ratio_attn"]
    assert "live_bytes_per_device" in out["memory_analysis"]
    # 9 heads do not divide 16-way TP: the port gathers smollm's leaves
    assert out["partitioned"] is False
    assert out["kernels"]["flash_attention"]["count"] == 2 * 30


def test_nodonate_counts_the_arguments_twice():
    cfg = configs.get_config("qwen2-0.5b").reduced()
    mesh = Mesh((1, 1), ("data", "model"), [0], abstract_rank=0)
    shape = api.ShapeCfg("t", 32, 2, "train")
    peaks = {}
    for donate in (True, False):
        v = dataclasses.replace(dryrun.get_variant("baseline"),
                                donate=donate)
        step, args, _ = dryrun.build_train(cfg, mesh, v)(shape)
        ana, _ = dryrun.analyze_step(step, args, donate=donate)
        peaks[donate] = ana.peak_live_bytes
    params, opt_state, _ = args
    state = sum(t.numel() * t.element_size()
                for t in dryrun._tensors((params, opt_state)))
    assert peaks[False] - peaks[True] == state


def test_partitioned_train_cell_runs_tensor_parallel():
    """deepseek-7b's heads divide the pod's 16-way "model" axis: its
    train cell runs the dense stack tensor-parallel (one all-reduce a
    sub-block, forward and backward) and says so."""
    out = dryrun.run_cell("deepseek-7b", "train_4k", "pod",
                          dryrun.get_variant("baseline"))
    assert out["partitioned"] is True
    assert out["collectives"]["all-reduce"]["count"] >= 4 * 30
    assert out["memory_analysis"]["fits_hbm"] is False
    assert out["n_params"] == japi.param_count(
        jconfigs.get_config("deepseek-7b"))


@pytest.mark.parametrize("arch", ["deepseek-7b", "internvl2-76b",
                                  "moonshot-v1-16b-a3b", "olmoe-1b-7b"])
def test_pod_decode_cells_are_partitioned_and_fit(arch):
    """decode_32k on the pod (batch 128, 32768 deep): each rank holds its
    ``decode_state_specs`` shard of the cache (deepseek, moonshot and
    olmoe their KV heads, internvl2 its slice of the sequence) and its
    experts, and the step splits its layers over "model"; the three cells
    that did not fit 80 GB with every head a rank now fit."""
    out = dryrun.run_cell(arch, "decode_32k", "pod",
                          dryrun.get_variant("baseline"))
    assert out["partitioned"] is True
    assert out["memory_analysis"]["fits_hbm"] is True
    assert out["memory_analysis"]["live_bytes_per_device"] < 20e9
    kinds = out["collectives"]
    assert kinds["all-reduce"]["count"] >= 2 * configs.get_config(
        arch).n_layers


def test_qwen2_prefill_cell_is_partitioned_through_the_sequence():
    """qwen2-0.5b's 2 KV heads do not divide the pod's 16-way "model"
    axis: prefill_32k runs each rank on its 2048 positions, K/V gathered a
    layer; as shipped (dp_only) the batch spec itself cuts the sequence."""
    for variant in ("baseline", "production"):
        spmd.reset_counts()
        out = dryrun.run_cell("qwen2-0.5b", "prefill_32k", "pod",
                              dryrun.get_variant(variant))
        assert out["partitioned"] is True
        assert spmd.counts[("all_gather", "kv")] == 24
        assert ("all_reduce", "act") not in spmd.counts


def test_deepseek_prefill_cell_is_partitioned_over_heads():
    spmd.reset_counts()
    out = dryrun.run_cell("deepseek-7b", "prefill_32k", "pod",
                          dryrun.get_variant("baseline"))
    assert out["partitioned"] is True
    assert spmd.counts[("all_reduce", "act")] == 2 * 30
    assert out["kernels"]["flash_attention"]["count"] == 30


def test_prefill_into_a_deeper_cache_relays_it_a_layer_at_a_time():
    """internvl2-76b's prefill_32k on the pod into a 65536-deep cache: the
    rank computes its 2048 positions (the KV heads do not divide "model")
    and each layer's K and V move to the rank's 4096 positions of the
    deeper cache one layer at a time.  The peak grows by no more than the
    two cache shards' growth and two layers' whole sequence; gathering the
    whole stack of K over the rank's rows at that depth would take 21.5 GB
    more."""
    cfg = configs.get_config("internvl2-76b")
    mesh = make_production_mesh(multi_pod=False, abstract=True)
    peaks = []
    for depth in (None, 65536):
        spmd.reset_counts()
        step, args, _ = dryrun.build_prefill(
            cfg, mesh, dryrun.get_variant("baseline"),
            max_len=depth)("prefill_32k")
        peaks.append(dryrun.analyze_step(step, args)[0].peak_live_bytes)
    assert spmd.counts[("all_gather", "cache")] == 2 * cfg.n_layers
    rows = api.SHAPES["prefill_32k"].global_batch // mesh.shape["data"]
    layer = rows * 65536 * cfg.n_kv_heads * cfg.resolved_head_dim \
        * cfg.dtype.itemsize
    growth = 2 * cfg.n_layers * layer // 2 // mesh.shape["model"]
    assert cfg.n_layers * layer > 21e9
    assert peaks[1] - peaks[0] <= growth + 2 * layer


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_recurrent_pod_decode_cells_are_partitioned_and_fit(arch, shape):
    """The recurrent families' decode cells on the pod run their rank
    programs: each rank holds its ``decode_state_specs`` shard (rwkv6's
    wkv keys, zamba2's SSD ds slice and its shared block's KV heads) and
    sums its part of every layer's readout over "model"; zamba2-1.2b's
    live bytes fall from 20.1 GB (decode_32k) and 34.7 GB (long_500k) a
    rank, every head's cache on every rank, to under 2 GB."""
    cfg = configs.get_config(arch)
    spmd.reset_counts()
    out = dryrun.run_cell(arch, shape, "pod", dryrun.get_variant("baseline"))
    assert out["partitioned"] is True
    assert out["memory_analysis"]["fits_hbm"] is True
    assert out["memory_analysis"]["live_bytes_per_device"] < 2e9
    assert spmd.counts[("all_reduce", "readout")] == cfg.n_layers
    assert out["kernels"].get("rwkv6_scan_split", {}).get("count", 0) == (
        cfg.n_layers if cfg.family == "rwkv6" else 0)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_recurrent_prefill_relays_its_state_a_layer_at_a_time(arch,
                                                              monkeypatch):
    """prefill_32k on the pod: the prefill runs each layer on the rank's
    heads (K4 / K3 at full width, zamba2's shared block through K2) and
    re-lays each layer's final state onto the decode layout (the rank's
    keys or ds slice) on its own: every state or cache re-lay takes one
    layer (no layer dim), one gather of the heads a layer; the shared
    block's caches are the rank's KV heads already and move not at
    all."""
    cfg = configs.get_config(arch)
    seen = []
    plain = spmd.relayout

    def relayout(x, src, dst, mesh, tag=""):
        if tag in ("state", "cache"):
            seen.append((tag, x.dim()))
        return plain(x, src, dst, mesh, tag)

    monkeypatch.setattr(spmd, "relayout", relayout)
    spmd.reset_counts()
    out = dryrun.run_cell(arch, "prefill_32k", "pod",
                          dryrun.get_variant("baseline"))
    assert out["partitioned"] is True
    layer_dims = {t.dim() - 1 for t in sharding.state_paths(
        api.get_model(cfg).init_decode_state(32, 32768,
                                             device="meta")).values()}
    assert seen and {d for _, d in seen} <= layer_dims
    assert spmd.counts[("all_gather", "state")] == cfg.n_layers
    assert ("all_gather", "cache") not in spmd.counts
    kernel = "rwkv6_scan" if cfg.family == "rwkv6" else "mamba2_scan"
    assert out["kernels"][kernel]["count"] == cfg.n_layers


def test_whisper_pod_serving_cells_are_partitioned_and_fit():
    """whisper-large-v3 on the pod runs its rank programs.  decode_32k
    (batch 128): each rank holds its ``decode_state_specs`` shard, the
    self K/V on its 2048 positions and the cross K/V on its 2 of the 32
    layers, and the step splits every layer over "model" (the self
    attention's log-sum-exp combine; the cross-attention computed by the
    layer's owner, its output broadcast: K2 twice a step on a rank, the
    cross K/V never moved); its live bytes fall from 49.2 GB a rank (the
    rank's rows of the whole state) to under 5 GB.  prefill_32k: the
    encoder whole (20 heads and 1500 frames on 16), the decoder on the
    rank's 2048 positions, K/V gathered a layer."""
    spmd.reset_counts()
    out = dryrun.run_cell("whisper-large-v3", "decode_32k", "pod",
                          dryrun.get_variant("baseline"))
    L = configs.get_config("whisper-large-v3").n_layers
    assert out["partitioned"] is True
    assert out["memory_analysis"]["live_bytes_per_device"] < 5e9
    assert spmd.counts[("all_reduce_max", "combine")] == L
    assert spmd.counts[("broadcast", "cross")] == L
    assert not any(tag in ("cache", "state") for _, tag in spmd.counts)
    assert out["kernels"]["flash_attention"]["count"] == 2
    spmd.reset_counts()
    out = dryrun.run_cell("whisper-large-v3", "prefill_32k", "pod",
                          dryrun.get_variant("baseline"))
    assert out["partitioned"] is True
    assert spmd.counts[("all_gather", "kv")] == L
    assert out["kernels"]["flash_attention"]["count"] == 3 * L
