"""Multi-pod dry run on meta tensors: every (arch x shape x mesh) cell.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each cell's step for the production mesh over 512 forced
host devices and reads XLA's HLO.  The port runs eagerly and has neither:
each cell traces **one rank's** step on the ``meta`` device (shapes and
dtypes, no memory, no values) under ``sharding.set_runtime_mesh`` of an
abstract production mesh (``launch.mesh.make_production_mesh(abstract=
True)``: the layout, playing rank 0, with no process group), inside the
op-level analyzer (``launch/op_analysis.py``), and prices what it counts
against one H100 (``core.hw.H100_SXM``):

  * train cells run the GSPMD trainer's rank program
    (``Trainer.rank_program``): the parameter and ZeRO-1 moment shards of
    ``parallel/sharding.py``, the rank's batch shard, forward and backward
    (``remat`` as the variant says; ``grad_accum`` as JAX's microbatch
    loop) and the AdamW update.  The update is in place, so a donated
    step's arguments are counted once; without ``donate`` the caller's
    copies of the parameters and moments stay live beside the new ones;
  * prefill and decode cells run the model's own entry points on the
    rank's part of the batch (``batch_specs``: its rows, and its slice of
    the sequence where the spec puts it over "model"), its parameters
    sharded by ``param_specs``, a decode cell's state sharded by
    ``decode_state_specs``.  The decoder families (dense, moe, vlm) run
    their rank programs (``models/transformer.py``: heads, d_ff and
    experts over "model", or the sequence), and so do the recurrent ones
    (rwkv6, mamba2, zamba2: ``models/rwkv.py``, ``models/ssm.py``,
    ``models/hybrid.py``; decode on the state's slice of the readout's
    contracted dim, prefill on the rank's heads), and so does the
    encoder-decoder (``models/encdec.py``: its self K/V laid out as a
    decoder's cache, its cross K/V on the heads, the frames or the layers,
    ``sharding.encdec_layout``).  The embedding and the LM head are read
    gathered; their bytes are in the collectives (``all-gather``).

The JSON keeps JAX's keys where their meaning holds.  There is no
compile and no XLA cost analysis, so ``t_compile_s`` and ``cost_analysis``
are left out; ``t_trace_s`` is the trace's wall time.  Bytes are the eager
program's traffic (no fusion), an upper bound on what XLA's fusion-
boundary count gives.  Results go under ``build/dryrun_torch/``, one file
per (arch, shape, mesh, variant).

Usage (the CPU; nothing is allocated):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k --mesh multipod --force
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs, weights
from repro_torch.core import hw
from repro_torch.core.apelink import protocol_efficiency
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api, transformer
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import sharding, spmd
from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                         shard_params)

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

MESHES = {
    "pod": dict(multi_pod=False, chips=256),
    "multipod": dict(multi_pod=True, chips=512),
}

# ----------------------------------------------------------------------------
# variants (perf hillclimbing) — "baseline" is the paper-faithful default
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Variant:
    """JAX's variants, less its ``out_shardings`` knob (pinning the jitted
    step's output layouts): the port's update writes every shard in
    place, in its own layout, so the knob has nothing to pin, and the
    variants that set it run as they would without it."""
    name: str = "baseline"
    remat: bool = True           # activation checkpointing in train_loss
    donate: bool = True          # donate params/opt buffers (in-place update)
    # microbatch gradient accumulation (activation memory / overlap knob)
    grad_accum: int = 1
    # ArchCfg field overrides (dataclasses.replace) — the hillclimb knobs
    cfg_overrides: tuple = ()    # (("field", value), ...)


_FAITHFUL = (("scan_impl", "pertoken"), ("moe_impl", "global"),
             ("tp_activations", "free"), ("parallelism", "tp_dp"),
             ("attn_dtype", "f32"))

VARIANTS: dict[str, Variant] = {
    # the paper-faithful baseline pins every §Perf knob to the naive
    # setting (sequential scans, global MoE dispatch, free activation
    # sharding, TPxDP for all archs, f32 attention)
    "baseline": Variant(cfg_overrides=_FAITHFUL),
    # per-arch production defaults (the configuration each config file
    # ships with)
    "production": Variant(name="production"),
    "noremat": Variant(name="noremat", remat=False,
                       cfg_overrides=_FAITHFUL),
    "nodonate": Variant(name="nodonate", donate=False,
                        cfg_overrides=_FAITHFUL),
    # hillclimb variants
    "chunked_ssm": Variant(name="chunked_ssm",
                           cfg_overrides=(("scan_impl", "chunked"),)),
    "ep_a2a": Variant(name="ep_a2a",
                      cfg_overrides=(("moe_impl", "ep_a2a"),)),
    "tp_megatron": Variant(name="tp_megatron",
                           cfg_overrides=(("tp_activations", "megatron"),)),
    "tp_sp": Variant(name="tp_sp",
                     cfg_overrides=(("tp_activations", "sp"),)),
    "ep_a2a_megatron": Variant(
        name="ep_a2a_megatron",
        cfg_overrides=(("moe_impl", "ep_a2a"),
                       ("tp_activations", "megatron"))),
    "dp_only": Variant(name="dp_only",
                       cfg_overrides=(("parallelism", "dp_only"),)),
    # attribution singles
    "attn_bf16": Variant(name="attn_bf16",
                         cfg_overrides=(("attn_dtype", "bf16"),)),
    "outsharded": Variant(name="outsharded"),
    # combined per-cell winners
    "sp_fast": Variant(name="sp_fast",
                       cfg_overrides=(("tp_activations", "sp"),
                                      ("attn_dtype", "bf16"))),
    "ep_fast": Variant(name="ep_fast",
                       cfg_overrides=(("moe_impl", "ep_a2a"),
                                      ("attn_dtype", "bf16"))),
    "ssm_fast": Variant(name="ssm_fast",
                        cfg_overrides=(("scan_impl", "chunked"),
                                       ("attn_dtype", "bf16"))),
    "dp_fast": Variant(name="dp_fast",
                       cfg_overrides=(("parallelism", "dp_only"),
                                      ("attn_dtype", "bf16"))),
    # microbatch gradient accumulation (activation memory knob)
    "accum4": Variant(name="accum4", grad_accum=4),
    "accum8": Variant(name="accum8", grad_accum=8),
    # hand-SPMD Megatron-SP dense layer (explicit bf16 AG/RS)
    "manual_sp": Variant(name="manual_sp",
                         cfg_overrides=(("tp_activations", "manual_sp"),)),
    "manual_sp_bf16": Variant(
        name="manual_sp_bf16",
        cfg_overrides=(("tp_activations", "manual_sp"),
                       ("attn_dtype", "bf16"))),
}


def get_variant(name: str) -> Variant:
    return VARIANTS[name]


def apply_variant(cfg, variant: Variant):
    if not variant.cfg_overrides:
        return cfg
    return dataclasses.replace(cfg, **dict(variant.cfg_overrides))


# ----------------------------------------------------------------------------
# useful attention flops (causal-masked QK^T + AV, one forward pass)
# ----------------------------------------------------------------------------


def model_attn_flops(cfg, shape, *, decode: bool = False) -> float:
    """Useful attention-matmul FLOPs for one forward pass (global).

    Causal attention does 2*0.5*S^2*H*hd flops for each of QK^T and AV per
    sequence; a decode step attends one query against a seq_len cache.
    Recurrent families (rwkv6, mamba2) have no S^2 term; zamba2 has one
    shared attention block applied every ``attn_every`` mamba layers;
    whisper adds the non-causal encoder and cross-attention.
    """
    B, S = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    H = max(cfg.n_heads, 1)

    def causal(n_layers, s):
        per_seq = 2 * 0.5 * s * s * H * hd * 2  # QK + AV, causal half
        return n_layers * B * per_seq

    def one_step(n_layers, cache):
        return n_layers * B * (2 * cache * H * hd * 2)

    fam = cfg.family
    if fam in ("rwkv6", "mamba2"):
        return 0.0
    if fam == "zamba2":
        n_attn = max(cfg.n_layers // max(cfg.attn_every, 1), 1)
        return one_step(n_attn, S) if decode else causal(n_attn, S)
    if fam == "encdec":
        enc = cfg.n_enc_layers * B * (2 * cfg.n_frames ** 2 * H * hd * 2)
        if decode:
            dec = one_step(cfg.n_layers, S)
            cross = cfg.n_layers * B * (2 * cfg.n_frames * H * hd * 2)
            return dec + cross  # encoder ran at prefill
        dec = causal(cfg.n_layers, S)
        cross = cfg.n_layers * B * (2 * S * cfg.n_frames * H * hd * 2)
        return enc + dec + cross
    # dense / moe / vlm decoder stacks
    s_eff = S + (cfg.n_patches if fam == "vlm" else 0)
    if decode:
        return one_step(cfg.n_layers, s_eff)
    return causal(cfg.n_layers, s_eff)


# ----------------------------------------------------------------------------
# step builders: (step, args, spec) — step() runs one rank's step on meta;
# args is every tensor it starts from (parameters, optimizer state, batch);
# spec is the spec of the token rows the rank holds
# ----------------------------------------------------------------------------


# every family's serving entry points run a rank's part of the partitioned
# program (models/transformer.py, rwkv.py, ssm.py, hybrid.py, encdec.py);
# the families whose decode state carries its caches' depth
_DEPTH = ("dense", "moe", "vlm", "zamba2", "encdec")


def _rows(cfg, batch: dict, mesh) -> tuple[dict, tuple]:
    """This rank's part of the batch as ``batch_specs`` lays it out (the
    batch dim over the dividing DP-axis prefix; under dp_only the
    sequence over an idle "model" axis) and the tokens' spec."""
    specs = sharding.batch_specs(cfg, batch, mesh)
    return {k: spmd.shard(v, specs[k], mesh).clone()
            for k, v in batch.items()}, tuple(specs["tokens"])


def _serving(mesh, spec, fn):
    """A serving step: ``fn()`` with no grad under the runtime mesh."""
    def step():
        sharding.set_runtime_mesh(mesh, spec)
        try:
            with torch.no_grad():
                return fn()
        finally:
            sharding.set_runtime_mesh(None)
    return step


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def build_train(cfg, mesh, variant: Variant, *, device="meta"):
    """The GSPMD trainer's rank program for ``mesh``'s rank: returns
    ``specs(shape) -> (step, args, spec)`` for a shape's name or a
    ``ShapeCfg``; on ``device`` (meta, or elsewhere with seeded weights
    and a batch of zeros)."""
    def specs(shape):
        if isinstance(shape, str):
            shape = api.SHAPES[shape]
        batch = api.train_input_specs(cfg, shape)
        if device != "meta":
            batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                     for k, v in batch.items()}
        tcfg = TrainerConfig(batch=shape.global_batch,
                             seq_len=shape.seq_len,
                             grad_accum=variant.grad_accum,
                             remat=variant.remat, comm="gspmd",
                             opt=AdamWConfig(), bucket_mb=4.0)
        tr = Trainer.rank_program(cfg, tcfg, mesh, batch, device=device)
        local = {k: spmd.shard(v, tr.bspecs[k], mesh).clone()
                 for k, v in batch.items()}
        args = (list(tr.params.parameters()), tr.opt_state, local)
        return (lambda: tr.gspmd_step(local)), args, tr.bspecs["tokens"]

    return specs


def build_prefill(cfg, mesh, variant: Variant, *, max_len=None):
    """The prefill's rank program: ``specs(shape_name) -> (step, args,
    spec)``, its cache ``max_len`` deep (default the prompt's length)."""
    model = api.get_model(cfg)

    def specs(shape_name):
        shape, batch = api.input_specs(cfg, shape_name)
        params = weights.model_class(cfg)(cfg, device="meta")
        shard_params(cfg, params, mesh)
        local, spec = _rows(cfg, batch, mesh)
        depth = max_len or shape.seq_len
        kw = ({} if cfg.family in ("rwkv6", "mamba2") else
              {"max_len": depth, "remat": False}
              if cfg.family == "encdec" else {"max_len": depth})
        step = _serving(mesh, spec, lambda: model.prefill(params, local,
                                                          **kw))
        return step, (list(params.parameters()), local), spec

    return specs


def build_decode(cfg, mesh, variant: Variant, *, device="meta"):
    """The decode step's rank program: ``specs(shape) -> (step, args,
    spec)`` for a shape's name or a ``ShapeCfg``; on ``device`` (meta, or
    elsewhere with seeded weights, zero tokens and a zero cache)."""
    cfg = transformer.serving_cfg(cfg)    # TP specs even under dp_only
    model = api.get_model(cfg)

    def specs(shape):
        if isinstance(shape, str):
            shape = api.SHAPES[shape]
        token = torch.empty((shape.global_batch, 1), dtype=api.TOKEN_DTYPE,
                            device="meta")
        local, spec = _rows(cfg, {"tokens": token}, mesh)
        # the rank's shard of the state
        st = api.decode_input_specs(cfg, shape)["state"]
        if cfg.family == "encdec":     # the cross K/V in the port's layout
            sspecs = {k: sp for k, (sp, _) in sharding.encdec_layout(
                cfg, mesh, shape.global_batch, shape.seq_len).items()}
        else:
            sspecs = sharding.decode_state_specs(cfg, st, mesh,
                                                 shape.global_batch)
        st = _tree(lambda v, sp: spmd.shard(v, sp, mesh).clone(), st, sspecs)
        if device == "meta":
            params = weights.model_class(cfg)(cfg, device="meta")
        else:
            params = model.init(torch.Generator(device).manual_seed(0))
            local, st = (_tree(lambda v: torch.zeros(
                v.shape, dtype=v.dtype, device=device), t)
                for t in (local, st))
        if cfg.family in _DEPTH:   # the whole cache's depth
            st["max_len"] = shape.seq_len
        shard_params(cfg, params, mesh)
        step = _serving(mesh, spec, lambda: model.decode_step(
            params, local["tokens"], st, shape.seq_len - 1))
        return step, (list(params.parameters()), local, st), spec

    return specs


def _tree(fn, tree, *others):
    """``fn`` over the leaves of nested dicts (and the matching leaves of
    ``others``)."""
    if isinstance(tree, dict):
        return {k: _tree(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def build_cell(cfg, mesh, shape_name: str, variant: Variant):
    kind = api.SHAPES[shape_name].kind
    builder = {"train": build_train, "prefill": build_prefill,
               "decode": build_decode}[kind]
    return builder(cfg, mesh, variant)(shape_name)


# ----------------------------------------------------------------------------
# per-cell dry run
# ----------------------------------------------------------------------------


def analyze_step(step, args, *, donate: bool = True):
    """Run ``step()`` inside the analyzer, ``args`` live from the start;
    without ``donate`` the caller's copies of the arguments (made in the
    analysis, so they count) stay live through the step.  Returns
    (Analysis, wall seconds)."""
    t0 = time.perf_counter()
    with op_analysis.OpAnalysis(args) as ana:
        kept = None if donate else [t.detach().clone()
                                    for t in _tensors(args[:2])]
        step()
        del kept
    return ana.result, time.perf_counter() - t0


# the collectives of the rank programs that split a layer over "model":
# training's tensor- and sequence-parallel stack; serving's heads, d_ff
# and experts (all-reduces "act", "expert"), the sequence (K/V gathered,
# "kv"), a decode cache's slices (the log-sum-exp combine, "combine") and
# a recurrent state's slices (the readout's partial sums, "readout")
_SPLIT_TAGS = {"train": ("act", "seq", "kv"),
               "prefill": ("act", "expert", "kv"),
               "decode": ("act", "expert", "combine", "readout")}


def _partitioned(mesh, spec, kind: str) -> bool:
    """Whether the ranks of a "model" line split the step's layers: its
    batch rows or sequence over "model", or a rank program's collectives
    that split a layer ran (``_SPLIT_TAGS``)."""
    if mesh.shape.get("model", 1) == 1:
        return True
    if any("model" in sharding.spec_axes(e) for e in spec):
        return True
    return any(tag in _SPLIT_TAGS[kind] for _, tag in spmd.counts)


def roofline(flops: float, nbytes: float, link_bytes: float,
             chip=hw.H100_SXM) -> dict:
    """The three roofline terms against one card.  The link term uses the
    card's aggregate rate (every NVLink of an H100 reaches the switch, so
    a transfer stripes over all of them; JAX's TPU term uses one torus
    link), derated by APElink's protocol efficiency as JAX's is."""
    eta = protocol_efficiency()
    link = chip.ici_aggregate_bandwidth
    terms = {
        "compute_s": flops / chip.peak_flops_bf16,
        "memory_s": nbytes / chip.hbm_bandwidth,
        "collective_s": link_bytes / link,
        "collective_derated_s": link_bytes / (link * eta),
    }
    terms["bottleneck"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    return terms


def run_cell(arch: str, shape_name: str, mesh_name: str,
             variant: Variant) -> dict:
    cfg = apply_variant(configs.get_config(arch), variant)
    chips = MESHES[mesh_name]["chips"]
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name]["multi_pod"],
                                abstract=True)
    shape = api.SHAPES[shape_name]
    spmd.reset_counts()
    step, args, spec = build_cell(cfg, mesh, shape_name, variant)
    ana, t_trace = analyze_step(step, args, donate=variant.donate)
    partitioned = _partitioned(mesh, spec, shape.kind)

    chip = hw.H100_SXM
    flops_dev = float(ana.flops)
    bytes_dev = float(ana.bytes)
    link_bytes = ana.link_bytes
    live = ana.peak_live_bytes
    terms = roofline(flops_dev, bytes_dev, link_bytes, chip)

    # model FLOPs: 6*N_active*D for train (fwd+bwd), 2*N_active*D for
    # inference, per chip; the _attn variant adds the useful causal
    # attention-matmul flops (QK^T + AV)
    n_active = api.active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * n_active * tokens
        attn_flops = 3.0 * model_attn_flops(cfg, shape)
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * n_active * tokens
        attn_flops = model_attn_flops(cfg, shape)
    else:  # decode: one token per sequence against a seq_len cache
        model_flops = 2.0 * n_active * shape.global_batch
        attn_flops = model_attn_flops(cfg, shape, decode=True)
    model_flops_dev = model_flops / chips
    attn_flops_dev = attn_flops / chips

    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": variant.name, "chips": chips, "chip": chip.name,
        "partitioned": partitioned,
        "t_trace_s": round(t_trace, 2),
        "memory_analysis": {"argument_size_in_bytes": ana.arg_bytes,
                            "live_bytes_per_device": live,
                            "fits_hbm": bool(live <= chip.hbm_bytes)},
        "collectives": ana.collectives,
        "top_collective_buffers": ana.top_buffers(12),
        "link_bytes_per_device": link_bytes,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "kernels": ana.kernels,
        "n_ops": ana.n_ops,
        "model_flops_per_device": model_flops_dev,
        "attn_model_flops_per_device": attn_flops_dev,
        "useful_flop_ratio":
            model_flops_dev / flops_dev if flops_dev else None,
        "useful_flop_ratio_attn":
            (model_flops_dev + attn_flops_dev) / flops_dev
            if flops_dev else None,
        "roofline": terms,
        "n_params": api.param_count(cfg),
        "n_active_params": n_active,
    }


def cell_path(arch, shape, mesh_name, variant, out_dir=None) -> Path:
    v = "" if variant == "baseline" else f"_{variant}"
    return (out_dir or OUT_DIR) / f"{arch}_{shape}_{mesh_name}{v}.json"


def all_cells(archs, shapes_filter, mesh_names):
    for arch in archs:
        cfg = configs.get_config(arch)
        for shape in api.applicable_shapes(cfg):
            if shapes_filter and shape not in shapes_filter:
                continue
            for mesh_name in mesh_names:
                yield arch, shape, mesh_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=None, help="output dir override")
    args = ap.parse_args(argv)
    out_dir = Path(args.out) if args.out else OUT_DIR

    archs = [configs.canonical(a) for a in (args.arch or configs.ALL_ARCHS)]
    mesh_names = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    variant = get_variant(args.variant)
    cells = list(all_cells(archs, args.shape, mesh_names))
    if args.list:
        for c in cells:
            print(*c)
        print(f"{len(cells)} cells")
        return 0

    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch, shape, mesh_name in cells:
        path = cell_path(arch, shape, mesh_name, variant.name, out_dir)
        if path.exists() and not args.force:
            print(f"[skip] {path.name}")
            continue
        print(f"[cell] {arch} x {shape} x {mesh_name} ({variant.name}) ...",
              flush=True)
        try:
            out = run_cell(arch, shape, mesh_name, variant)
        except Exception:
            traceback.print_exc()
            failures.append((arch, shape, mesh_name))
            continue
        path.write_text(json.dumps(out, indent=1))
        r = out["roofline"]
        print(f"   ok: trace {out['t_trace_s']}s  "
              f"flops/dev {out['flops_per_device']:.3e}  "
              f"bytes/dev {out['bytes_per_device']:.3e}  "
              f"link/dev {out['link_bytes_per_device']:.3e}  "
              f"live/dev {out['memory_analysis']['live_bytes_per_device']:.3e}"
              f"  fits_hbm {out['memory_analysis']['fits_hbm']}  "
              f"bottleneck {r['bottleneck']}", flush=True)
    if failures:
        print("FAILED CELLS:", failures)
        return 1
    print("all requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
