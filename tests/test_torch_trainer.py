"""The port's training stack vs the JAX package, on the CPU: AdamW, the
data stream, checkpoints, and the ``Trainer`` single and apex (8 gloo
ranks), with its link-fault reroute and elastic re-mesh (GSPMD over 8
ranks: ``test_torch_gspmd.py``).

The multi-rank half runs in one module fixture: ``tests/torch_dist_checks
.py`` runs the JAX trainers (8 forced host devices) in one subprocess and
the port's 8 ranks (a ``file://`` store in a temporary directory) in 8
more, side by side; the port starts from JAX's initial weights
(``weights.from_jax_params``).  Model: ``test_runtime.py``'s tiny fp32
config.  Losses are held to JAX's to rtol 1e-5 (fp32; the two frameworks
sum in other orders); the overlap engine to the sequential step bitwise.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.common import ArchCfg as JCfg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.common import ArchCfg  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as tdc  # noqa: E402

CFG = ArchCfg(**tdc.TINY, dtype=torch.float32)
JCFG = JCfg(**tdc.TINY, dtype=jnp.float32)
OPT = tadamw.AdamWConfig(**tdc.OPT)
RTOL = 1e-5


# ----------------------------------------------------------------------------
# the multi-rank runs (one fixture for the file)
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("trainer"))
    tdc.launch("trainer", out, timeout=600)
    with open(os.path.join(out, "jax_trainer.json")) as f:
        ref = json.load(f)
    ranks = []
    for r in range(8):
        with open(os.path.join(out, f"rank{r}_trainer.json")) as f:
            ranks.append(json.load(f))
    return {"out": out, "jax": ref, "ranks": ranks, "port": ranks[0]}


def jax_init(out: str, name: str = "jax_init.npz", cfg=CFG):
    with np.load(os.path.join(out, name)) as z:
        flat = {k: z[k] for k in z.files}
    return weights.from_jax_params(cfg, weights.nest(flat), device="cpu")


def test_apex_losses_match_jax_on_8_ranks(dist_run):
    np.testing.assert_allclose(dist_run["port"]["apex_losses"],
                               dist_run["jax"]["apex_losses"], rtol=RTOL)
    for r in dist_run["ranks"]:      # every rank reports the mean loss
        assert r["apex_losses"] == dist_run["port"]["apex_losses"]


def test_apex_predicted_comm_equals_jax(dist_run):
    assert dist_run["port"]["apex_predicted_comm_s"] == \
        dist_run["jax"]["apex_predicted_comm_s"]


def test_overlap_is_bitwise_the_sequential_step(dist_run):
    p = dist_run["port"]
    assert p["n_buckets"] > 1
    assert p["ov_losses"] == p["seq_losses"]
    assert all(r["ov_params_equal"] for r in dist_run["ranks"])


def test_overlap_reports_predicted_and_measured_efficiency(dist_run):
    last = dist_run["port"]["ov_metrics"]
    for key in ("overlap_eff_pred", "overlap_eff_measured",
                "overlap_pred_reduction", "predicted_comm_s"):
        assert np.isfinite(last[key]), key
    assert 0.0 <= last["overlap_eff_pred"] <= 1.0
    assert 0.0 <= last["overlap_eff_measured"] <= 1.0


def test_reroute_around_a_dead_link_keeps_the_losses(dist_run):
    p = dist_run["port"]
    assert any("rerouted collectives around [(2, 3)]" in e
               for e in p["reroute_events"])
    assert p["reroute_max_hops"] == dist_run["jax"]["reroute_max_hops"] == 7
    assert p["reroute_losses"] == p["apex_losses"]


def test_elastic_remesh_events_equal_jax(dist_run):
    assert dist_run["port"]["remesh_events"] == \
        dist_run["jax"]["remesh_events"]
    assert "elastic re-mesh: 8 -> 4 devices" in dist_run["port"][
        "remesh_events"]


def test_elastic_remesh_losses_finite_and_equal_jax(dist_run):
    post = dist_run["port"]["remesh_post"]
    assert all(np.isfinite(post))
    np.testing.assert_allclose(post, dist_run["jax"]["remesh_post"],
                               rtol=RTOL)


def test_remesh_drops_the_ranks_past_the_power_of_two_prefix(dist_run):
    for r, res in enumerate(dist_run["ranks"]):
        assert res["remesh_active"] == (r < 4), r
        if r < 4:
            assert res["remesh_mesh"] == [0, 1, 2, 3]
        else:
            assert res["remesh_events"][-1] == "dropped by the re-mesh: leaving"


def test_zero_moments_keep_the_checkpoint_layout_across_remesh(dist_run):
    """JAX takes the restore template before re-building for the new mesh,
    so the restored moments keep the checkpoint's (8 * chunk,) layout; the
    port's gathered moments have the same shapes."""
    assert dist_run["port"]["remesh_moment_shapes"] == \
        dist_run["jax"]["remesh_moment_shapes"]


def test_moments_in_a_nondividing_layout_fail_after_remesh_as_in_jax(
        dist_run):
    """Leaves of 12 * 257 elements: the 8-rank layout pads to 3088, the
    4-rank one to 3084; JAX fails at the first step after the re-mesh
    (a broadcast of (772,) against (771,)), and so does the port."""
    assert dist_run["jax"]["odd_remesh_error"] is not None
    for r in dist_run["ranks"][:4]:
        assert r["odd_remesh_error"] == "ValueError"
        assert "another DP size's padded layout" in r["odd_remesh_message"]
        assert r["odd_events"] == dist_run["jax"]["odd_events"]


def test_jax_apex_checkpoint_resumes_on_8_ranks(dist_run):
    p = dist_run["port"]
    assert p["interop_step"] == 3
    np.testing.assert_allclose(p["interop_loss"],
                               dist_run["jax"]["apex_losses"][3], rtol=RTOL)


# ----------------------------------------------------------------------------
# the trainer on one rank
# ----------------------------------------------------------------------------

def tcfg(tmp_path, tag="t", **kw):
    return TrainerConfig(ckpt_dir=str(tmp_path / tag),
                         **{"ckpt_every": 0, "batch": 8, "seq_len": 32,
                            "opt": OPT, "comm": "single", **kw})


def test_single_losses_match_jax(dist_run, tmp_path):
    tr = Trainer(CFG, tcfg(tmp_path), device="cpu",
                 init_params=jax_init(dist_run["out"]))
    got = [m["loss"] for m in tr.train(6)]
    np.testing.assert_allclose(got, dist_run["jax"]["single_losses"],
                               rtol=RTOL)


def test_jax_checkpoint_restores_into_the_port(dist_run, tmp_path):
    tr = Trainer(CFG, tcfg(tmp_path), device="cpu",
                 init_params=jax_init(dist_run["out"]))
    tr.store.directory = os.path.join(dist_run["out"], "jax_single_ckpt")
    tr.resume()
    assert tr.data.step == 3 and int(tr.opt_state["step"]) == 3
    np.testing.assert_allclose(tr.train(1)[0]["loss"],
                               dist_run["jax"]["single_losses"][3],
                               rtol=RTOL)


def test_grad_accum_2_equals_accum_1(tmp_path):
    init = api.get_model(CFG).init(torch.Generator().manual_seed(1))
    losses = {}
    for accum in (1, 2):
        tr = Trainer(CFG, tcfg(tmp_path, f"a{accum}", grad_accum=accum),
                     device="cpu", init_params=init)
        losses[accum] = [m["loss"] for m in tr.train(4)]
    np.testing.assert_allclose(losses[2], losses[1], rtol=RTOL)


def test_checkpoint_restart_is_bitwise(tmp_path):
    init = api.get_model(CFG).init(torch.Generator().manual_seed(2))
    tr1 = Trainer(CFG, tcfg(tmp_path, "a", ckpt_every=3), device="cpu",
                  init_params=init)
    tr1.train(6)            # checkpoints at 3 and 6
    ref = [m["loss"] for m in tr1.train(2)]
    tr2 = Trainer(CFG, tcfg(tmp_path, "a"), device="cpu", init_params=init)
    tr2.store.keep_last = 10
    tr2.resume()            # the step-6 checkpoint (step 8's too, later)
    assert tr2.data.step == 6
    assert [m["loss"] for m in tr2.train(2)] == ref


def test_single_step_on_the_cpu_takes_the_eager_update(tmp_path):
    """The card's in-place kernel pair is the card's alone: on the CPU the
    single step runs the stacked eager update, and the moments keep JAX's
    keys and stacked shapes (what checkpoints and ``from_jax_opt_state``
    read)."""
    from repro_torch.core.fabric import process_hub
    hub = process_hub()
    tr = Trainer(CFG, tcfg(tmp_path), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in tr._leaf_values().items()}
    e0, f0 = hub.value("adamw.eager_elems"), hub.value("adamw.fused_elems")
    tr.train(2)
    assert hub.value("adamw.eager_elems") - e0 == 2 * tr.n_params
    assert hub.value("adamw.fused_elems") == f0
    for mom in ("m", "v"):
        assert {k: tuple(t.shape) for k, t in tr.opt_state[mom].items()} \
            == shapes
        assert list(tr.opt_state[mom]) == list(weights.jax_leaves(
            CFG, tr.params))


def test_fault_recovery_restores_and_replays(tmp_path):
    tr = Trainer(CFG, tcfg(tmp_path, ckpt_every=2, torus_dims=(4,)),
                 device="cpu")
    tr.train(4)                               # checkpoints at 2, 4 (and 6)

    def fault_at_1(i):
        if i == 1:
            tr.lofamo.kill_host(1)            # neighbours 0 and 2 report it

    tr.train(3, fault_hook=fault_at_1)
    evs = " | ".join(tr.events)
    assert "LO|FA|MO: master aware of faults [1]" in evs
    assert "restored step 6; data stream replayed" in evs   # host: 2 stale reads
    assert np.isfinite(tr.metrics_log[-1]["loss"])


def test_trainer_telemetry_and_straggler_bookkeeping(tmp_path):
    """Counters per step on the passed hub, which gets no wall-clock
    event; a wall-clock ``train.step`` span a step on the process hub;
    and a step slower than straggler_factor x the running median
    flagged."""
    from repro_torch.core.fabric import Telemetry, process_hub
    tel = Telemetry()
    hub = process_hub()
    tr = Trainer(CFG, tcfg(tmp_path, straggler_factor=0.0), device="cpu",
                 telemetry=tel)
    n0 = hub.n_events
    ms = tr.train(6)
    assert tel.value("trainer.steps") == 6
    assert tel.value("trainer.step_time_s") > 0
    assert tel.n_events == 0                 # no logical-clock span
    new = list(hub.events)[-(hub.n_events - n0):]
    steps = [e for e in new if e[2] == "train.step"]
    assert len(steps) == 6                   # one wall-clock span a step
    assert all(a[0] + a[3] <= b[0] for a, b in zip(steps, steps[1:]))
    assert [m["step"] for m in ms] == list(range(1, 7))
    assert ms[-1].get("straggler") and "straggler step=6" in tr.events[-1]
    assert "straggler" not in ms[3]          # fewer than 5 steps timed


def test_trainer_owns_gradients_and_serving_builds_none(tmp_path):
    model = api.get_model(CFG).init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    tr = Trainer(CFG, tcfg(tmp_path), device="cpu", init_params=model)
    assert all(p.requires_grad for p in tr.params.parameters())
    assert not any(p.requires_grad for p in model.parameters())


def test_trainer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is then valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(CFG, tcfg(tmp_path))


def test_gspmd_over_a_mesh_names_its_roadmap_item(tmp_path):
    """ROADMAP item 7 is done: olmoe and moonshot select the
    expert-parallel MoE dispatch (moe_impl="ep_a2a", JAX's apply_moe_ep),
    and ``Trainer(comm="gspmd")`` accepts it under a "model" axis: on a
    (4, 2) mesh of 8 gloo ranks it builds and steps both, with finite
    losses, every rank the same, two all-to-alls a layer in the forward
    (again in remat's recompute) and their two adjoints in the backward
    (their losses against JAX's: test_torch_gspmd.py)."""
    tdc.launch("ep_step", str(tmp_path), timeout=300, jax=False)
    ranks = []
    for r in range(8):
        with open(tmp_path / f"rank{r}_ep_step.json") as f:
            ranks.append(json.load(f))
    for name in ("olmoe-1b-7b", "moonshot-v1-16b-a3b"):
        res = ranks[0][name]
        assert res["moe_impl"] == "ep_a2a" and res["model_axis"] == 2
        assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
        assert all(r[name]["losses"] == res["losses"] for r in ranks)
        layer_steps = 2 * 2                        # 2 layers, 2 steps
        assert res["counts"]["all_to_all/moe"] == 4 * layer_steps
        assert res["counts"]["all_to_all/moe/bwd"] == 2 * layer_steps


def test_gspmd_on_a_1x1_mesh_is_the_single_step_bitwise(tmp_path):
    """One rank, a ("data", "model") mesh of 1 x 1: every spec shards
    nothing and every collective is the identity, so GSPMD's losses and
    weights are single's, bit for bit; a checkpoint-restart too."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        assert mesh.coords == (0, 0) and mesh.line(("data", "model")) == (0,)
        init = api.get_model(CFG).init(torch.Generator().manual_seed(0))
        runs = {}
        for comm, m in (("single", None), ("gspmd", mesh)):
            tr = Trainer(CFG, tcfg(tmp_path, comm, comm=comm, ckpt_every=2),
                         mesh=m, device="cpu", init_params=init)
            runs[comm] = ([x["loss"] for x in tr.train(3)],
                          [p.clone() for p in tr.params.parameters()], tr)
        assert runs["gspmd"][0] == runs["single"][0]
        assert all(torch.equal(a, b) for a, b in zip(runs["gspmd"][1],
                                                     runs["single"][1]))
        tr = runs["gspmd"][2]
        assert tr.n_params == runs["single"][2].n_params
        again = Trainer(CFG, tcfg(tmp_path, "gspmd", comm="gspmd"),
                        mesh=mesh, device="cpu", init_params=init)
        again.resume()
        assert again.data.step == 2
        assert again.train(1)[0]["loss"] == runs["gspmd"][0][2]
    finally:
        dist.destroy_process_group()


def test_trainer_config_keeps_jax_fields_and_defaults():
    want = {f.name: f.default for f in
            jtrainer.TrainerConfig.__dataclass_fields__.values()}
    got = {f.name: f.default for f in
           TrainerConfig.__dataclass_fields__.values()}
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "opt"} == \
        {k: v for k, v in want.items() if k != "opt"}


@pytest.mark.parametrize("arch", ["qwen2", "rwkv6", "zamba2"])
def test_remat_changes_no_loss_or_gradient(arch):
    """Per-layer recompute (zamba2: its mamba layers, not its shared block)
    gives the loss and every gradient of the plain backward, bitwise."""
    from repro_torch import configs
    cfg = CFG if arch == "qwen2" else configs.get_reduced(
        {"rwkv6": "rwkv6-1.6b", "zamba2": "zamba2-1.2b"}[arch])
    model = api.get_model(cfg).init(torch.Generator().manual_seed(3))
    for p in model.parameters():
        p.requires_grad_(True)
    b = tpipe.make_batch_arrays(tpipe.SyntheticTokens(cfg, 2, 16).next_batch(),
                                cfg, "cpu")
    out = {}
    for remat in (False, True):
        for p in model.parameters():
            p.grad = None
        loss = api.get_model(cfg).train_loss(model, b, remat=remat)
        loss.backward()
        out[remat] = (loss.item(), [p.grad.clone()
                                    for p in model.parameters()])
    assert out[True][0] == out[False][0]
    for a, b_ in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_launcher_trains_on_the_cpu(tmp_path):
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "2", "--seq", "16", "--batch", "2",
         "--ckpt-dir", str(tmp_path / "ck")], capture_output=True,
        text=True, env=env, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert "comm=single device=cpu" in out.stdout
    assert "[train] done" in out.stdout
    # the process hub's span summary: count, total and self ms a name
    rows = {ln.split()[0]: ln.split()[1:] for ln in out.stdout.splitlines()
            if ln.strip().startswith("train.")}
    assert set(rows) == {"train.step", "train.data", "train.fwd_bwd",
                         "train.update", "train.wait"}
    assert all(r[0] == "2" and float(r[2]) <= float(r[1]) + 1e-3
               for r in rows.values())


def test_launcher_defaults_to_gspmd_and_runs_single_on_one_rank():
    """As JAX's launcher: --comm defaults to gspmd, and one rank trains
    single (src/repro/launch/train.py)."""
    from repro_torch.launch import train
    args = train.parse_args(["--reduced", "--device", "cpu"])
    assert args.comm == "gspmd" and args.mesh == ""
    assert train.resolve_comm(args.comm, world=1) == "single"
    assert train.resolve_comm("gspmd", world=8) == "gspmd"
    assert train.parse_mesh("4,2", world=8) == (4, 2)
    assert train.parse_mesh("", world=8) == (8, 1)


# ----------------------------------------------------------------------------
# AdamW, the data stream and checkpoints vs the JAX package
# ----------------------------------------------------------------------------

def _opt_case(seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stacked": (2, 3, 4), "norm": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 0.3
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


def test_adamw_update_matches_jax():
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    params, grads = _opt_case(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    for g in grads:
        jp, js, jm = jadamw.adamw_update(
            jcfg, {k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts, tm = tadamw.adamw_update(
            cfg, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            for mom in ("m", "v"):
                np.testing.assert_allclose(ts[mom][k].numpy(),
                                           np.asarray(js[mom][k]),
                                           rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"])


@pytest.mark.parametrize("clip_norm", [1e9, 0.05])
def test_in_place_update_is_the_functional_update(clip_norm):
    """``adamw_update_plain_`` (the kernel pair's plain version) over
    per-layer tensors is ``adamw_update`` over their stacked leaves,
    bitwise: a stacked leaf's 1-D tensors decay (the leaf's rank), a lone
    1-D leaf does not, and a tensor without a gradient takes zeros."""
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                             clip_norm=clip_norm)
    assert weights.is_stacked(CFG, "layers/x") and \
        not weights.is_stacked(CFG, "w")
    params, grads = _opt_case(1)
    params["ln"] = params["norm"][None].repeat(2, 0)      # stacked 1-D
    key = {"stacked": "layers/stacked", "ln": "layers/ln"}   # CFG stacks
    tensors = {key.get(k, k): [torch.from_numpy(x.copy()) for x in v]
               if k in key else [torch.from_numpy(v.copy())]
               for k, v in params.items()}
    stacked = {key.get(k, k): torch.from_numpy(v.copy())
               for k, v in params.items()}
    state_ = tadamw.adamw_init(stacked)
    state = tadamw.adamw_init(stacked)
    for i, g in enumerate(grads):
        g = dict(g, ln=np.stack([g["norm"], -g["norm"]]))
        if i == 1:
            g["w"] = np.zeros_like(g["w"])                  # no gradient
        g = {key.get(k, k): x for k, x in g.items()}
        for k, ts in tensors.items():
            gs = [g[k]] if len(ts) == 1 else list(g[k])
            for t, x in zip(ts, gs):
                t.grad = None if i == 1 and k == "w" else \
                    torch.from_numpy(x.copy())
        m_ = tadamw.adamw_update_plain_(cfg, tensors, state_, arch=CFG)
        stacked, state, m = tadamw.adamw_update(
            cfg, {k: torch.from_numpy(x) for k, x in g.items()}, state,
            stacked)
        for k, ts in tensors.items():
            assert torch.equal(torch.stack(ts) if len(ts) > 1 else ts[0],
                               stacked[k]), k
            for mom in ("m", "v"):
                assert torch.equal(state_[mom][k], state[mom][k]), (k, mom)
        assert int(state_["step"]) == int(state["step"]) == i + 1
        assert torch.equal(m_["grad_norm"], m["grad_norm"])
        assert torch.equal(m_["lr"], m["lr"])


def test_in_place_update_refuses_the_cpu():
    """``adamw_update_`` is the card's kernel pair alone: on CPU tensors it
    raises before it touches the state (the trainer picks the eager update
    there)."""
    params, _ = _opt_case(2)
    tensors = {k: [torch.from_numpy(v)] for k, v in params.items()}
    state = tadamw.adamw_init({k: ts[0] for k, ts in tensors.items()})
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tadamw.adamw_update_(tadamw.AdamWConfig(), tensors, state)
    assert int(state["step"]) == 0


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 99, 100, 150])
def test_cosine_schedule_matches_jax(step):
    cfg = tadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_frac=0.1)
    jcfg = jadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_frac=0.1)
    np.testing.assert_allclose(float(tadamw.cosine_schedule(cfg, step)),
                               float(jadamw.cosine_schedule(jcfg, step)),
                               rtol=1e-6, atol=1e-7)


def test_clipping_bounds_the_update_as_in_jax():
    cfg = tadamw.AdamWConfig(lr=1e-3, clip_norm=1.0, weight_decay=0.0)
    jcfg = jadamw.AdamWConfig(lr=1e-3, clip_norm=1.0, weight_decay=0.0)
    tp, jp = {"w": torch.zeros(4)}, {"w": jnp.zeros(4)}
    _, ts, tm = tadamw.adamw_update(cfg, {"w": torch.full((4,), 1e9)},
                                    tadamw.adamw_init(tp), tp)
    _, js, jm = jadamw.adamw_update(jcfg, {"w": jnp.full(4, 1e9)},
                                    jadamw.adamw_init(jp), jp)
    assert float(tm["grad_norm"]) > 1e8
    assert float(ts["m"]["w"].abs().max()) <= 0.11
    np.testing.assert_allclose(ts["m"]["w"].numpy(), np.asarray(js["m"]["w"]),
                               rtol=1e-6)


@pytest.mark.parametrize("family", ["dense", "vlm"])
def test_synthetic_tokens_equal_jax(family):
    kw = dict(tdc.TINY, family=family, n_patches=3)
    t = tpipe.SyntheticTokens(ArchCfg(**kw), 4, 24, seed=7)
    j = jpipe.SyntheticTokens(JCfg(**kw), 4, 24, seed=7)
    for _ in range(3):
        a, b = t.next_batch(), j.next_batch()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    r = tpipe.SyntheticTokens.from_state(ArchCfg(**kw), 4, 24,
                                         {"seed": 7, "step": 1})
    np.testing.assert_array_equal(
        r.next_batch()["tokens"],
        jpipe.SyntheticTokens(JCfg(**kw), 4, 24, seed=7, step=1)
        .next_batch()["tokens"])


def test_make_batch_arrays_lands_on_the_given_device():
    b = tpipe.SyntheticTokens(CFG, 2, 8).next_batch()
    out = tpipe.make_batch_arrays(b, CFG, "cpu")
    assert out["tokens"].device.type == "cpu"
    assert out["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(out["labels"].numpy(), b["labels"])


def test_prefetcher_yields_and_closes():
    pf = tpipe.Prefetcher(iter(tpipe.SyntheticTokens(CFG, 2, 16)), depth=2)
    batches = [next(pf) for _ in range(3)]
    assert all(b["tokens"].shape == (2, 16) for b in batches)
    pf.close()


def test_checkpoint_roundtrip_and_layout(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32),
                  "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}}
    tstore.save_checkpoint(str(tmp_path), 5, tree, extra={"x": 1})
    got, extra = tstore.load_checkpoint(str(tmp_path), template=tree)
    for k in ("a",):
        assert torch.equal(got[k], tree[k])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    assert got["b"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["h"], tree["b"]["h"])
    assert extra == {"x": 1}
    assert tstore.latest_step(str(tmp_path)) == 5
    # JAX's store reads the port's fp32 and integer leaves under the same
    # keys (bf16 leaves it would need as ml_dtypes arrays)
    del tree["b"]["h"]
    tstore.save_checkpoint(str(tmp_path / "j"), 1, tree)
    flat, _ = jstore.load_checkpoint(str(tmp_path / "j"))
    np.testing.assert_array_equal(flat["a"], tree["a"].numpy())
    np.testing.assert_array_equal(flat["b/c"], tree["b"]["c"].numpy())


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"a": torch.arange(100, dtype=torch.float32)}
    path = tstore.save_checkpoint(str(tmp_path), 1, tree)
    z = dict(np.load(os.path.join(path, "tensors.npz")))
    z["a"][3] += 1.0
    np.savez(os.path.join(path, "tensors.npz"), **z)
    with pytest.raises(ValueError, match="CRC"):
        tstore.load_checkpoint(str(tmp_path), template=tree)


def test_checkpoint_gc_and_async_snapshot(tmp_path):
    st = tstore.CheckpointStore(str(tmp_path), keep_last=2)
    t = torch.zeros(4)
    for s in (1, 2, 3, 4):
        t.fill_(s)
        st.save_async(s, {"a": t})
        t.fill_(-1)          # an in-place update after the call
    st.wait()
    assert tstore.latest_step(str(tmp_path)) == 4
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) \
        == [3, 4]
    got, _ = tstore.load_checkpoint(str(tmp_path), 3)
    np.testing.assert_array_equal(got["a"], np.full(4, 3, np.float32))


def test_opt_state_bridge_round_trips_both_layouts():
    rng = np.random.default_rng(0)
    state = {"m": {"embed": {"tok": rng.normal(size=(16,))
                             .astype(np.float32)},
                   "layers": {"w": rng.normal(size=(8,))
                              .astype(np.float32)}},
             "v": {"embed": {"tok": np.ones(16, np.float32)},
                   "layers": {"w": np.ones(8, np.float32)}},
             "step": np.int32(5)}
    single = weights.from_jax_opt_state(state, device="cpu")
    assert set(single["m"]) == {"embed/tok", "layers/w"}
    back = weights.to_jax_opt_state(single)
    np.testing.assert_array_equal(back["m"]["embed"]["tok"],
                                  state["m"]["embed"]["tok"])
    assert int(back["step"]) == 5
    # apex: rank 2 of 4 keeps chunk [2 * n / 4, 3 * n / 4)
    apex = weights.from_jax_opt_state(state, dp=4, rank=2, device="cpu")
    np.testing.assert_array_equal(apex["m"]["embed/tok"].numpy(),
                                  state["m"]["embed"]["tok"][8:12])
    with pytest.raises(ValueError, match="apex moments"):
        weights.from_jax_opt_state(state, dp=3, device="cpu")


def test_jax_leaves_follow_the_jax_tree():
    jparams = jax.tree.map(np.asarray, jtrainer.api.get_model(JCFG).init(
        jax.random.key(0)))
    model = weights.from_jax_params(CFG, jparams, device="cpu")
    leaves = weights.jax_leaves(CFG, model)
    want, _ = jax.tree_util.tree_flatten_with_path(jparams)
    assert list(leaves) == ["/".join(p.key for p in path)
                            for path, _ in want]
    back = weights.to_jax_params(CFG, model)
    for (_, a), b in zip(want, jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
