"""Multi-rank checks of the PyTorch port's collectives and trainer against
the JAX package — run as subprocesses by ``test_torch_collectives.py`` and
``test_torch_trainer.py``; each mode is also directly runnable:

    # the JAX references (8 forced host devices), into OUT/
    PYTHONPATH=src XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_dist_checks.py jax-collectives OUT
    PYTHONPATH=src XLA_FLAGS=... python tests/torch_dist_checks.py \\
        jax-trainer OUT
    # the port: one process per rank, 8 gloo ranks meeting at a file store
    PYTHONPATH=src python tests/torch_dist_checks.py rank-collectives OUT \\
        RANK 8 STORE_FILE              # for RANK in 0..7
    PYTHONPATH=src python tests/torch_dist_checks.py rank-trainer OUT \\
        RANK 8 STORE_FILE
    # GSPMD: jax-gspmd OUT PART (8 forced host devices) for PART in 0, 1,
    # 2 (three processes, side by side), rank-gspmd OUT RANK 8 STORE_FILE
    # for RANK in 0..7
    # the expert-parallel MoE layer (jax-ep OUT, rank-ep OUT RANK 8
    # STORE_FILE) and the sharded attention wrappers (jax-sharded,
    # rank-sharded), likewise; tensor-parallel serving: jax-serve_tp OUT
    # PART for PART in 0, 1, rank-serve_tp OUT RANK 8 STORE_FILE

Both sides draw their inputs from the same numpy seeds and write what they
computed to ``OUT`` (``.npz`` / ``.json``); the tests compare the files.
The port's side imports no JAX, the JAX side no torch.
"""
import functools
import json
import os
import sys

import numpy as np

# 1D (8), 2D (2, 4) and 3D (2, 2, 2) meshes, as tests/fabric_checks.py
MESHES = {"1d": ((8,), ("x",)), "2d": ((2, 4), ("a", "b")),
          "3d": ((2, 2, 2), ("u", "v", "w"))}
SHIFTS = (1, -1, 3)
DEAD_NODE, DEAD_LINK = 3, (2, 3)
BUCKET_SHAPES = [(13,), (3, 5), (4, 4, 2), (25,), (7,)]


def inputs(tag: str):
    """Every collective case's inputs, from one seed per mesh: Gaussian
    (``g_*``, for the comparison with JAX) and integer-valued (``i_*``,
    whose sums are exact in fp32, so any summation order gives the numpy
    oracle's value)."""
    shape, _ = MESHES[tag]
    rng = np.random.default_rng({"1d": 1, "2d": 2, "3d": 3}[tag])
    out = {}
    for kind in ("g", "i"):
        def mk(s, kind=kind):
            if kind == "g":
                return rng.normal(size=s).astype(np.float32)
            return rng.integers(-8, 8, size=s).astype(np.float32)
        out[f"{kind}_ar"] = mk(shape + (51,))
        out[f"{kind}_rsag"] = mk(shape + (37,))
        if tag == "1d":
            out[f"{kind}_own"] = mk((8, 64))
            out[f"{kind}_a2a"] = mk((8, 8, 3))
            out[f"{kind}_halo"] = mk((8, 5, 4))
            out[f"{kind}_fault"] = mk((8, 100))
            out[f"{kind}_shift"] = mk((8, 6))
    return out


def bucket_inputs(tag: str):
    shape, _ = MESHES[tag]
    rng = np.random.default_rng(11 if tag == "1d" else 12)
    return [rng.normal(size=shape + s).astype(np.float32)
            for s in BUCKET_SHAPES]


def _save_npz(path: str, arrays: dict) -> None:
    """Written whole, then renamed: a reader polling for ``path`` never
    sees a part of it.  A bf16 array (JAX's, as numpy gives it) is written
    as fp32, which holds it exactly."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: a.astype(np.float32) if a.dtype.name == "bfloat16"
                     else a for k, a in arrays.items()})
    os.rename(tmp, path)


def _save_json(path: str, obj) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.rename(path + ".tmp", path)


def wait_for(path: str, timeout: float = 600.0) -> str:
    """Poll until ``path`` exists (the JAX reference writes it)."""
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)
    return path


def launch(mode: str, out_dir: str, *, world: int = 8,
           timeout: float = 600.0, jax: bool = True) -> None:
    """Run the JAX reference of ``mode`` ("collectives", "trainer",
    "gspmd", "ep", "sharded" or "serve_tp"; none with ``jax=False``) and the port's ``world`` gloo ranks side by side; raise with
    the logs if any process fails."""
    import subprocess
    import tempfile
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    jax_env = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=8"))
    me = os.path.abspath(__file__)
    store = os.path.join(tempfile.mkdtemp(dir=out_dir), "store")
    n = {"gspmd": len(GSPMD_JAX_PARTS), "serve_tp": SERVE_JAX_PARTS}
    parts = [[str(i)] for i in range(n[mode])] if mode in n \
        else [[]] if jax else []
    procs = [subprocess.Popen(
        [sys.executable, me, f"jax-{mode}", out_dir] + part, env=jax_env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in parts]
    procs += [subprocess.Popen(
        [sys.executable, me, f"rank-{mode}", out_dir, str(r), str(world),
         store], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs, failed = [], False
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
            failed |= p.returncode != 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise RuntimeError("\n".join(
            f"--- {i}: exit {p.returncode}\n{log[-3000:]}"
            for i, (p, log) in enumerate(zip(procs, logs))))


# ----------------------------------------------------------------------------
# JAX references
# ----------------------------------------------------------------------------

def jax_collectives(out_dir: str) -> None:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.core import fabric, jaxcompat
    from repro.core import rdma as jrdma
    from repro.core.topology import Torus
    from repro.launch.mesh import make_mesh

    assert jax.device_count() == 8, jax.device_count()
    res = {}

    def run(mesh, axes, fn, x):
        lead = len(axes)
        spec = P(*axes)

        def per_shard(v):
            return fn(v.reshape(v.shape[lead:])).reshape(v.shape)

        return np.asarray(jax.jit(jaxcompat.shard_map(
            per_shard, mesh=mesh, in_specs=(spec,), out_specs=spec))(x))

    def run_rows(mesh, fn, x):
        """1D: rank r's output (any shape) as row r."""
        return np.asarray(jax.jit(jaxcompat.shard_map(
            lambda v: fn(v[0])[None], mesh=mesh, in_specs=(P("x"),),
            out_specs=P("x")))(x))

    for tag, (shape, axes) in MESHES.items():
        mesh, torus = make_mesh(shape, axes), Torus(shape)
        for kind, x in inputs(tag).items():
            if not kind.startswith("g_"):
                continue
            name = kind[2:]
            if name == "ar":
                for bidi in (True, False):
                    s = fabric.lower_all_reduce(torus, axes,
                                                bidirectional=bidi)
                    res[f"{tag}/ar/{int(bidi)}"] = run(
                        mesh, axes,
                        lambda v, s=s: fabric.execute_all_reduce(s, v), x)
            elif name == "rsag":
                rs = fabric.lower_reduce_scatter(torus, axes)
                ag = fabric.lower_all_gather(
                    torus, tuple(reversed(axes)),
                    axis_dims=tuple(reversed(range(len(axes)))))

                def rt(v, rs=rs, ag=ag):
                    c, sizes = fabric.execute_reduce_scatter(rs, v)
                    return fabric.execute_all_gather(ag, c, sizes) \
                        .reshape(v.shape)

                res[f"{tag}/rsag"] = run(mesh, axes, rt, x)
            elif name == "own":
                s = fabric.lower_reduce_scatter(torus, axes)
                res[f"{tag}/own"] = run_rows(
                    mesh, lambda v, s=s: fabric.execute_reduce_scatter(s, v)[0],
                    x)
            elif name == "a2a":
                s = fabric.lower_all_to_all(torus, "x")
                res[f"{tag}/a2a"] = run(
                    mesh, axes,
                    lambda v, s=s: fabric.execute_all_to_all(s, v), x)
            elif name == "halo":
                s = fabric.lower_halo_exchange(torus, "x")
                res[f"{tag}/halo"] = run_rows(
                    mesh, lambda v, s=s: jax.numpy.stack(
                        fabric.execute_halo_exchange(s, v, halo=2)), x)
            elif name == "fault":
                clean = fabric.lower_all_reduce(torus, axes)
                fm_l = fabric.FaultMap.normalized(links=[DEAD_LINK])
                fm_n = fabric.FaultMap.normalized(nodes=[DEAD_NODE])
                for key, s in (
                        ("detour", fabric.rewrite(clean, fm_l)),
                        ("shrunk", fabric.rewrite(clean, fm_n)),
                        ("shrunk_mean", fabric.rewrite(
                            fabric.lower_all_reduce(torus, axes, mean=True),
                            fm_n))):
                    res[f"{tag}/{key}"] = run(
                        mesh, axes,
                        lambda v, s=s: fabric.execute_all_reduce(s, v), x)
                res["detour_max_hops"] = np.asarray(
                    fabric.rewrite(clean, fm_l).max_hops)
            elif name == "shift":
                for st in SHIFTS:
                    res[f"{tag}/shift/{st}"] = run(
                        mesh, axes,
                        lambda v, st=st: jrdma.put_shift(v, "x", st), x)
    # put_coords on 3D
    shape, axes = MESHES["3d"]
    x = inputs("3d")["g_ar"]
    res["3d/coords"] = run(make_mesh(shape, axes), axes,
                           lambda v: jrdma.put_coords(v, axes, (1, 0, -1)), x)
    np.savez(os.path.join(out_dir, "jax_collectives.npz"), **res)


TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=257)
# leaves of 12 * 257 elements: not a multiple of 8 (ROADMAP §3)
ODD = dict(TINY, d_model=12, n_heads=2, n_kv_heads=1)
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=50)
APEX = dict(batch=8, seq_len=32, comm="apex", dp_axis="x")
# the re-mesh runs, whose event lists are compared: a step slower than 3x
# the running median adds a "straggler" event on that side alone (a
# wall-clock reading: one stalled rank of eight under a loaded host is
# enough), so the detector is off there on both sides
REMESH_QUIET = dict(straggler_factor=float("inf"))


def jax_trainer(out_dir: str) -> None:
    import shutil

    import jax
    import jax.numpy as jnp

    from repro.core import fabric
    from repro.core.topology import Torus
    from repro.launch.mesh import make_mesh
    from repro.models.common import ArchCfg
    from repro.optim import AdamWConfig
    from repro.runtime.trainer import Trainer, TrainerConfig

    assert jax.device_count() == 8, jax.device_count()
    cfg = ArchCfg(**TINY, dtype=jnp.float32)
    opt = AdamWConfig(**OPT)
    res: dict = {}

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(getattr(p, "key", p)) for p in path):
                np.asarray(leaf) for path, leaf in leaves}

    # the reroute's hop count, as the trainer computes it
    t8 = Torus((8,))
    fm = fabric.FaultMap.normalized(links=[DEAD_LINK])
    res["reroute_max_hops"] = max(fabric.rewrite(s, fm).max_hops for s in (
        fabric.lower_reduce_scatter(t8, ("x",), mean=True),
        fabric.lower_all_gather(t8, ("x",)),
        fabric.lower_all_reduce(t8, ("x",), mean=True)))
    # apex: the init every port run starts from, 4 fault-free losses (a
    # checkpoint at step 3), then an elastic re-mesh after a dead node.
    # Its events are compared with the port's, so the wall-clock
    # straggler detector is off (REMESH_QUIET; it has a test of its own)
    ck = f"{out_dir}/jax_remesh"
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=ck, ckpt_every=3, opt=opt,
                                    **APEX, **REMESH_QUIET),
                 mesh=make_mesh((8,), ("x",)))
    _save_npz(os.path.join(out_dir, "jax_init.npz"), flat(tr.params))
    res["apex_losses"] = [m["loss"] for m in tr.train(4)]
    res["apex_predicted_comm_s"] = tr.predicted_comm_s
    tr.store.wait()
    # published whole (rename), since the port's ranks poll for it
    shutil.copytree(f"{ck}/step_00000003", f"{out_dir}/tmp_apex_ckpt/"
                    "step_00000003")
    os.rename(f"{out_dir}/tmp_apex_ckpt", f"{out_dir}/jax_apex_ckpt")

    def fault(i, tr=tr):
        if i == 1:
            tr.lofamo.kill_node(5)

    res["remesh_post"] = [m["loss"] for m in tr.train(4, fault_hook=fault)]
    res["remesh_events"] = tr.events
    res["remesh_moment_shapes"] = {k: list(v.shape) for k, v in
                                   flat(tr.opt_state["m"]).items()}
    # the same with leaves whose size 8 does not divide
    odd = ArchCfg(**ODD, dtype=jnp.float32)
    tr = Trainer(odd, TrainerConfig(ckpt_dir=f"{out_dir}/jax_odd",
                                    ckpt_every=1, opt=opt, **APEX),
                 mesh=make_mesh((8,), ("x",)))
    _save_npz(os.path.join(out_dir, "jax_init_odd.npz"), flat(tr.params))
    tr.train(1)

    def fault_odd(i, tr=tr):
        tr.lofamo.kill_node(5)

    try:
        tr.train(1, fault_hook=fault_odd)
        res["odd_remesh_error"] = None
    except Exception as e:   # the reference's own failure, recorded
        res["odd_remesh_error"] = type(e).__name__
    res["odd_events"] = tr.events
    # single: 6 losses, and a checkpoint written at step 3 + the next loss
    single = Trainer(cfg, TrainerConfig(ckpt_dir=f"{out_dir}/jax_single",
                                        ckpt_every=3, batch=8, seq_len=32,
                                        opt=opt, comm="single"))
    res["single_losses"] = [m["loss"] for m in single.train(3)]
    single.store.wait()
    shutil.copytree(f"{out_dir}/jax_single/step_00000003",
                    f"{out_dir}/tmp_single_ckpt/step_00000003")
    os.rename(f"{out_dir}/tmp_single_ckpt", f"{out_dir}/jax_single_ckpt")
    res["single_losses"] += [m["loss"] for m in single.train(3)]
    _save_json(os.path.join(out_dir, "jax_trainer.json"), res)


# ----------------------------------------------------------------------------
# GSPMD (comm="gspmd") over ("data", "model") meshes
# ----------------------------------------------------------------------------

GSPMD_MESHES = ((8, 1), (4, 2), (2, 4))
GSPMD_STEPS = 3
# manual_sp_check.py's deepseek: tp_dp, 4 heads and 4 KV heads (so every
# test mesh's "model" axis divides them), manual_sp; fp32 throughout
DSK = dict(n_heads=4, n_kv_heads=4, d_ff=128, attn_dtype="f32")


def gspmd_cfgs(configs_mod, ArchCfg, dtype):
    """{tag: (cfg, batch, meshes)}: TINY (tp_dp, "free"), the deepseek of
    manual_sp_check.py and the reduced qwen2 (dp_only; batch 4, so on the
    (4, 2) and (2, 4) meshes the sequence goes over "model") on every
    mesh; the reduced olmoe with the global dispatch (JAX's
    ``apply_moe``, its experts sharded over "model") and the reduced
    rwkv6 and whisper on (4, 2), and a 2-layer reduced zamba2 on (2, 4):
    their sharded leaves are gathered where a layer reads them; the
    reduced olmoe as configured, ``moe_impl="ep_a2a"`` (JAX's
    ``apply_moe_ep``: the expert-parallel all-to-alls over "model"), on
    (4, 2) and (2, 4)."""
    import dataclasses

    def reduced(name, **kw):
        return dataclasses.replace(configs_mod.get_reduced(name),
                                   **{"dtype": dtype, **kw})

    return {
        "tiny": (ArchCfg(**TINY, dtype=dtype), 8, GSPMD_MESHES),
        "dsk": (reduced("deepseek-7b", **DSK), 8, GSPMD_MESHES),
        "qwen": (reduced("qwen2-0.5b"), 4, GSPMD_MESHES),
        "olmoe": (reduced("olmoe-1b-7b", moe_impl="global"), 8, ((4, 2),)),
        "rwkv6": (reduced("rwkv6-1.6b"), 8, ((4, 2),)),
        "whisper": (reduced("whisper-large-v3"), 8, ((4, 2),)),
        "zamba2": (reduced("zamba2-1.2b", n_layers=2), 8, ((2, 4),)),
        "olmoe-ep": (reduced("olmoe-1b-7b"), 8, ((4, 2), (2, 4))),
    }


# the mesh of JAX's reference run, where it is not the port's: JAX's
# partitioned rwkv6 on a "model" axis of 2 drops the gradient of the
# second "model" shard of ``tm.u`` (ROADMAP §3), so the port's run on
# (4, 2) is held to JAX's on (8, 1), where no leaf is sharded (and whose
# losses equal JAX's single-rank ones); JAX runs (4, 2) too, for the
# test that pins the fault
JAX_REF_MESH = {"rwkv6": (8, 1)}


# the configs of each of the JAX reference's processes, which run side by
# side (the port's ranks wait on the reference's compiles); the first
# also runs the checkpoint and fault cases
GSPMD_JAX_PARTS = (("tiny", "dsk", "qwen"),
                   ("olmoe", "rwkv6", "whisper", "zamba2"),
                   ("olmoe-ep",))
# the configs whose router and expert gradients at the first batch are
# held to ``jax.grad`` on each mesh, and those leaves
GSPMD_GRAD_CFGS = ("olmoe-ep",)
GSPMD_GRAD_KEYS = ("layers/moe/router", "layers/moe/w_gate",
                   "layers/moe/w_up", "layers/moe/w_down")


def ref_tag(case: str) -> str:
    """The JAX run a port case is held to."""
    tag, _ = case.split("_")
    return _tag(tag, JAX_REF_MESH[tag]) if tag in JAX_REF_MESH else case


def _tag(cfg_tag, shape):
    return f"{cfg_tag}_{shape[0]}x{shape[1]}"


def jax_gspmd(out_dir: str, part: int) -> None:
    import shutil

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch.mesh import host_test_mesh, make_mesh
    from repro.models.common import ArchCfg
    from repro.optim import AdamWConfig
    from repro.parallel import sharding
    from repro.runtime.trainer import Trainer, TrainerConfig

    assert jax.device_count() == 8, jax.device_count()
    opt = AdamWConfig(**OPT)
    res: dict = {"losses": {}}

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(getattr(p, "key", p)) for p in path):
                np.asarray(leaf) for path, leaf in leaves}

    hm = host_test_mesh((2, 4), ("a", "b"))
    res["host_test_mesh"] = [[int(d.id) for d in row] for row in hm.devices]

    def trainer(cfg, batch, shape, ck, **kw):
        tc = TrainerConfig(ckpt_dir=ck, **{"ckpt_every": 0, "opt": opt,
                                           "batch": batch, "seq_len": 32,
                                           "comm": "gspmd", **kw})
        return Trainer(cfg, tc, mesh=make_mesh(shape, ("data", "model")))

    for tag, (cfg, batch, meshes) in gspmd_cfgs(jconfigs, ArchCfg,
                                                jnp.float32).items():
        if tag not in GSPMD_JAX_PARTS[part]:
            continue
        if tag in JAX_REF_MESH:     # the reference first, then the fault
            meshes = (JAX_REF_MESH[tag],) + meshes
        for shape in meshes:
            tr = trainer(cfg, batch, shape, f"{out_dir}/jax_g_{tag}")
            if shape == meshes[0]:
                _save_npz(os.path.join(out_dir, f"jax_gspmd_init_{tag}.npz"),
                          flat(tr.params))
            if tag in GSPMD_GRAD_CFGS:
                # jax.grad of the loss at the first batch, on this mesh
                first = tr._place_batch(tr.data.next_batch())
                tr.data.step -= 1
                sharding.set_runtime_mesh(tr.mesh)
                try:
                    with tr.mesh:
                        _, g = jax.jit(tr._loss_and_grads())(tr.params,
                                                             first)
                finally:
                    sharding.set_runtime_mesh(None)
                g = flat(g)
                _save_npz(os.path.join(
                    out_dir, f"jax_gspmd_grads_{_tag(tag, shape)}.npz"),
                    {k.replace("/", "."): g[k] for k in GSPMD_GRAD_KEYS})
            res["losses"][_tag(tag, shape)] = [
                m["loss"] for m in tr.train(GSPMD_STEPS)]
    if part:
        _save_json(os.path.join(out_dir, f"jax_gspmd_{part}.json"), res)
        return
    cfg, batch, _ = gspmd_cfgs(jconfigs, ArchCfg, jnp.float32)["tiny"]
    # a checkpoint at step 2 (published for the port), the step-3 loss;
    # then a node fault on the 2-D mesh: restored without a re-mesh
    ck = f"{out_dir}/jax_g_ckpt"
    tr = trainer(cfg, batch, (4, 2), ck, ckpt_every=2)
    res["ckpt_losses"] = [m["loss"] for m in tr.train(3)]
    tr.store.wait()
    shutil.copytree(f"{ck}/step_00000002",
                    f"{out_dir}/tmp_gspmd_ckpt/step_00000002")
    os.rename(f"{out_dir}/tmp_gspmd_ckpt", f"{out_dir}/jax_gspmd_ckpt")

    def fault(i, tr=tr):
        if i == 1:
            tr.lofamo.kill_node(5)

    res["fault_losses"] = [m["loss"] for m in tr.train(4, fault_hook=fault)]
    res["fault_events"] = tr.events
    res["fault_mesh"] = list(tr.mesh.devices.shape)
    # the port's GSPMD checkpoint (step 2) resumed here: the next loss
    tr = trainer(cfg, batch, (4, 2), wait_for(
        os.path.join(out_dir, "port_gspmd_ckpt")))
    tr.resume()
    res["from_port_step"] = tr.data.step
    res["from_port_loss"] = tr.train(1)[0]["loss"]
    _save_json(os.path.join(out_dir, f"jax_gspmd_{part}.json"), res)


# ----------------------------------------------------------------------------
# the port, one process per rank
# ----------------------------------------------------------------------------

def _init(rank: int, world: int, store: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    return torch, dist


def rank_collectives(out_dir: str, rank: int, world: int, store: str):
    torch, dist = _init(rank, world, store)
    from repro_torch.core import collectives as C
    from repro_torch.core import fabric
    from repro_torch.core import rdma
    from repro_torch.core.topology import Torus
    from repro_torch.launch.mesh import make_mesh

    res = {}
    T = torch.from_numpy

    def mine(x, mesh, axes):
        return T(x[tuple(mesh.axis_index(a) for a in axes)].copy())

    for tag, (shape, axes) in MESHES.items():
        mesh, torus = make_mesh(shape, axes), Torus(shape)
        for kind, x in inputs(tag).items():
            k, name = kind.split("_", 1)
            v = mine(x, mesh, axes)
            if name == "ar":
                for bidi in (True, False):
                    s = fabric.lower_all_reduce(torus, axes,
                                                bidirectional=bidi)
                    res[f"{k}/{tag}/ar/{int(bidi)}"] = \
                        fabric.execute_all_reduce(s, v, mesh)
                    # the wrappers take the same path
                    res[f"{k}/{tag}/ar_wrap/{int(bidi)}"] = \
                        C.make_stacked_all_reduce(
                            mesh, axes, bidirectional=bidi)(T(x))
            elif name == "rsag":
                c, sizes = C.dim_ordered_reduce_scatter(v, axes, mesh)
                res[f"{k}/{tag}/rsag"] = C.dim_ordered_all_gather(
                    c, axes, sizes, mesh).reshape(v.shape)
            elif name == "own":
                res[f"{k}/{tag}/own"] = C.ring_reduce_scatter(v, "x", mesh)
            elif name == "a2a":
                res[f"{k}/{tag}/a2a"] = C.ring_all_to_all(v, "x", mesh)
            elif name == "halo":
                res[f"{k}/{tag}/halo"] = torch.stack(
                    C.halo_exchange(v, "x", mesh, halo=2))
            elif name == "fault":
                clean = fabric.lower_all_reduce(torus, axes)
                fm_l = fabric.FaultMap.normalized(links=[DEAD_LINK])
                fm_n = fabric.FaultMap.normalized(nodes=[DEAD_NODE])
                res[f"{k}/{tag}/clean"] = fabric.execute_all_reduce(
                    clean, v, mesh)
                for key, s in (
                        ("detour", fabric.rewrite(clean, fm_l)),
                        ("shrunk", fabric.rewrite(clean, fm_n)),
                        ("shrunk_mean", fabric.rewrite(
                            fabric.lower_all_reduce(torus, axes, mean=True),
                            fm_n))):
                    res[f"{k}/{tag}/{key}"] = fabric.execute_all_reduce(
                        s, v, mesh)
            elif name == "shift":
                for st in SHIFTS:
                    res[f"{k}/{tag}/shift/{st}"] = rdma.put_shift(
                        v, "x", mesh, st)
                res[f"{k}/{tag}/send_recv"] = rdma.send_recv(
                    v, "x", mesh, [(0, 5), (5, 0), (2, 3)])
        res[f"i/{tag}/tree"] = C.tree_all_reduce(
            {"a": mine(inputs(tag)["i_ar"], mesh, axes)}, axes, mesh)["a"]
        if tag == "3d":
            res["g/3d/coords"] = rdma.put_coords(
                mine(inputs(tag)["g_ar"], mesh, axes), axes, mesh,
                (1, 0, -1))

    # every round of a bidirectional RS is ONE batch carrying both
    # directions (dual DMA); a unidirectional one carries one
    rounds = {}
    real = dist.batch_isend_irecv
    mesh = make_mesh((8,), ("x",))
    torus = Torus((8,))
    for bidi in (True, False):
        log = []

        def spy(ops, log=log):
            log.append(sorted((op.op.__name__, op.peer) for op in ops))
            return real(ops)

        dist.batch_isend_irecv = spy
        try:
            s = fabric.lower_reduce_scatter(torus, ("x",),
                                            bidirectional=bidi)
            fabric.execute_reduce_scatter(s, torch.ones(64), mesh)
        finally:
            dist.batch_isend_irecv = real
        rounds[str(int(bidi))] = {"steps": len(s.phases[0].steps),
                                  "batches": log}

    # the bucketed grad hook equals the sequential per-leaf RS, bitwise
    for tag, dim in (("1d", 0), ("2d", 1)):
        shape, axes = MESHES[tag]
        mesh, torus = make_mesh(shape, axes), Torus(shape)
        sched = fabric.lower_reduce_scatter(torus, (axes[dim],),
                                            axis_dims=(dim,), mean=True)
        m = torus.dims[dim]
        gs = [mine(g, mesh, axes) for g in bucket_inputs(tag)]
        plan = fabric.plan_buckets([int(np.prod(s)) for s in BUCKET_SHAPES],
                                   40 * 4, itemsize=4)
        assert plan.n_buckets > 1
        params = [torch.zeros_like(g, requires_grad=True) for g in gs]
        handles = fabric.make_bucket_grad_hook(plan, sched, mesh)(
            [[p] for p in params])
        sum((p * g).sum() for p, g in zip(params, gs)).backward()
        for h in handles:
            h.remove()
        slot = fabric.ring_slot(sched.phases[0], mesh)
        for i, g in enumerate(gs):
            chunk, _ = fabric.execute_reduce_scatter(sched, g, mesh)
            full = torch.zeros(chunk.numel() * m)
            full[slot * chunk.numel():(slot + 1) * chunk.numel()] = chunk
            res[f"g/{tag}/bucket/{i}"] = params[i].grad
            res[f"g/{tag}/bucket_seq/{i}"] = full[:g.numel()].reshape(
                g.shape)

    np.savez(os.path.join(out_dir, f"rank{rank}_collectives.npz"),
             **{k: v.numpy() for k, v in res.items()})
    with open(os.path.join(out_dir, f"rank{rank}_rounds.json"), "w") as f:
        json.dump(rounds, f)
    dist.destroy_process_group()


def rank_trainer(out_dir: str, rank: int, world: int, store: str):
    torch, dist = _init(rank, world, store)
    from repro_torch import weights
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import ArchCfg
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = ArchCfg(**TINY, dtype=torch.float32)
    opt = AdamWConfig(**OPT)
    res: dict = {}

    def load_init(name, c):
        with np.load(os.path.join(out_dir, name)) as z:
            flat = {k: z[k] for k in z.files}
        nested: dict = {}
        for path, a in flat.items():
            *head, last = path.split("/")
            d = nested
            for h in head:
                d = d.setdefault(h, {})
            d[last] = a
        return weights.from_jax_params(c, nested, device="cpu")

    wait_for(os.path.join(out_dir, "jax_init.npz"))
    init = load_init("jax_init.npz", cfg)

    def trainer(tag, c=cfg, params=init, **kw):
        tc = TrainerConfig(ckpt_dir=os.path.join(out_dir, f"port_{tag}"),
                           **{"ckpt_every": 0, "opt": opt, **APEX, **kw})
        return Trainer(c, tc, mesh=make_mesh((8,), ("x",)), device="cpu",
                       init_params=params)

    # a dead link under reroute: same losses, the detour's hops
    tr = trainer("reroute", fault_mode="reroute")

    def kill_link(i, tr=tr):
        if i == 1:
            tr.lofamo.kill_link(*DEAD_LINK)

    res["reroute_losses"] = [m["loss"] for m in tr.train(
        4, fault_hook=kill_link)]
    res["reroute_events"] = tr.events
    res["reroute_max_hops"] = max(
        s.max_hops for s in tr.apex_schedules.values())
    # overlap (bucketed hooks) vs sequential: bitwise
    seq, ov = trainer("seq"), trainer("ov", overlap=True, bucket_mb=0.05)
    res["n_buckets"] = ov.bucket_plan.n_buckets
    ls, lo = seq.train(3), ov.train(3)
    res["seq_losses"] = [m["loss"] for m in ls]
    res["ov_losses"] = [m["loss"] for m in lo]
    res["ov_metrics"] = {k: v for k, v in lo[-1].items()
                         if isinstance(v, float)}
    res["ov_params_equal"] = all(
        torch.equal(a, b) for a, b in zip(seq.params.parameters(),
                                          ov.params.parameters()))
    # apex, fault-free (a checkpoint at step 3), then an elastic re-mesh
    # after a dead node; no straggler detector, as in JAX's run
    tr = trainer("remesh", ckpt_every=3, **REMESH_QUIET)
    res["apex_losses"] = [m["loss"] for m in tr.train(4)]
    res["apex_predicted_comm_s"] = tr.predicted_comm_s

    def kill_node(i, tr=tr):
        if i == 1:
            tr.lofamo.kill_node(5)

    res["remesh_post"] = [m["loss"] for m in tr.train(
        4, fault_hook=kill_node)]
    res["remesh_events"] = tr.events
    res["remesh_active"] = tr.active
    if tr.active:
        res["remesh_mesh"] = list(tr.mesh.ranks)
        res["remesh_moment_shapes"] = {
            k: list(v.shape) for k, v in tr._global_moments()["m"].items()}
    # the same with leaves whose size 8 does not divide
    odd_cfg = ArchCfg(**ODD, dtype=torch.float32)
    wait_for(os.path.join(out_dir, "jax_init_odd.npz"))
    tr = trainer("odd", c=odd_cfg, params=load_init("jax_init_odd.npz",
                                                    odd_cfg), ckpt_every=1)
    tr.train(1)

    def kill_odd(i, tr=tr):
        tr.lofamo.kill_node(5)

    try:
        tr.train(1, fault_hook=kill_odd)
        res["odd_remesh_error"] = None
    except Exception as e:
        res["odd_remesh_error"] = type(e).__name__
        res["odd_remesh_message"] = str(e)
    res["odd_events"] = tr.events
    # JAX's apex checkpoint (step 3, global moment layout) resumed on 8
    # ranks: the next loss is JAX's step-4 loss
    tr = trainer("interop")
    tr.store.directory = wait_for(os.path.join(out_dir, "jax_apex_ckpt"))
    tr.resume()
    res["interop_step"] = tr.data.step
    res["interop_loss"] = tr.train(1)[0]["loss"]
    _save_json(os.path.join(out_dir, f"rank{rank}_trainer.json"), res)
    dist.destroy_process_group()


def rank_gspmd(out_dir: str, rank: int, world: int, store: str):
    import dataclasses
    import shutil

    torch, dist = _init(rank, world, store)
    from repro_torch import configs, weights
    from repro_torch.data import make_batch_arrays
    from repro_torch.launch.mesh import host_test_mesh, make_mesh
    from repro_torch.models import api
    from repro_torch.models.common import ArchCfg
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding, spmd
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    opt = AdamWConfig(**OPT)
    res: dict = {"losses": {}, "local_shapes": {}}
    hm = host_test_mesh((2, 4), ("a", "b"))
    res["host_test_mesh"] = {"coords": list(hm.coords),
                             "line_a": list(hm.line("a")),
                             "line_b": list(hm.line("b"))}

    def load(path, cfg):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return weights.from_jax_params(cfg, weights.nest(flat), device="cpu")

    def trainer(cfg, init, batch, shape, tag, **kw):
        tc = TrainerConfig(
            ckpt_dir=os.path.join(out_dir, f"port_g_{tag}"),
            **{"ckpt_every": 0, "opt": opt, "batch": batch, "seq_len": 32,
               "comm": "gspmd", **kw})
        return Trainer(cfg, tc, mesh=make_mesh(shape, ("data", "model")),
                       device="cpu", init_params=init)

    cfgs = gspmd_cfgs(configs, ArchCfg, torch.float32)
    inits = {}
    for tag, (cfg, batch, meshes) in cfgs.items():
        inits[tag] = load(wait_for(os.path.join(
            out_dir, f"jax_gspmd_init_{tag}.npz")), cfg)
        for shape in meshes:
            tr = trainer(cfg, inits[tag], batch, shape, _tag(tag, shape))
            vals = tr._leaf_values()
            res["local_shapes"][_tag(tag, shape)] = {
                k: [list(vals[k].shape), list(tr.opt_state["m"][k].shape),
                    list(tr.opt_state["v"][k].shape)] for k in vals}
            if tag in GSPMD_GRAD_CFGS:
                # the gradients of the first batch, gathered to JAX's
                # global layout
                np_batch = tr.data.next_batch()
                tr.data.step -= 1
                spmd.reset_counts()
                _, g = tr._gspmd_loss_and_grads(tr._place_batch(np_batch))
                res.setdefault("ep_counts", {})[_tag(tag, shape)] = {
                    f"{op}/{t}": n for (op, t), n in spmd.counts.items()}
                g = {k: spmd.unshard(g[k], tr.pspecs[k], tr.mesh)
                     for k in GSPMD_GRAD_KEYS}
                if rank == 0:
                    _save_npz(os.path.join(
                        out_dir, f"port_gspmd_grads_{_tag(tag, shape)}.npz"),
                        {k.replace("/", "."): v.numpy() for k, v in g.items()})
            res["losses"][_tag(tag, shape)] = [
                m["loss"] for m in tr.train(GSPMD_STEPS)]
            if (tag, shape) in (("dsk", (4, 2)), ("qwen", (2, 4))):
                # the collectives of one forward: under manual_sp, and on
                # dp_only's slices of the sequence (the rows as placed)
                b = tr._place_batch(tr.data.next_batch())
                sharding.set_runtime_mesh(tr.mesh, tr.bspecs["tokens"])
                spmd.reset_counts()
                try:
                    with torch.no_grad():
                        tr.model.train_loss(tr.params, b, remat=False)
                finally:
                    sharding.set_runtime_mesh(None)
                res.setdefault("fwd", {})[tag] = {
                    "counts": {f"{op}/{t}": n for (op, t), n
                               in spmd.counts.items()},
                    "layers": cfg.n_layers,
                    "rows": list(b["tokens"].shape)}
    cfg, batch, _ = cfgs["tiny"]
    # JAX's GSPMD checkpoint (step 2) resumed here: the next loss
    tr = trainer(cfg, inits["tiny"], batch, (4, 2), "from_jax")
    tr.store.directory = wait_for(os.path.join(out_dir, "jax_gspmd_ckpt"))
    tr.resume()
    res["from_jax_step"] = tr.data.step
    res["from_jax_loss"] = tr.train(1)[0]["loss"]
    # a checkpoint of the port at step 2 (published for JAX), then a node
    # fault on the 2-D mesh
    tr = trainer(cfg, inits["tiny"], batch, (4, 2), "ckpt", ckpt_every=2)
    res["ckpt_losses"] = [m["loss"] for m in tr.train(3)]
    tr.store.wait()
    dist.barrier()
    if rank == 0:
        src = os.path.join(out_dir, "port_g_ckpt", "step_00000002")
        shutil.copytree(src, os.path.join(out_dir, "tmp_port_ckpt",
                                          "step_00000002"))
        os.rename(os.path.join(out_dir, "tmp_port_ckpt"),
                  os.path.join(out_dir, "port_gspmd_ckpt"))

    def fault(i, tr=tr):
        if i == 1:
            tr.lofamo.kill_node(5)

    res["fault_losses"] = [m["loss"] for m in tr.train(4, fault_hook=fault)]
    res["fault_events"] = tr.events
    res["fault_mesh"] = list(tr.mesh.shape.values())
    # manual_sp_check.py on the port: the sequence-parallel stack's loss
    # and every gradient against the plain stack's, from the same weights
    # and the same batch (4 x 32, labels drawn uniformly), mesh (2, 4)
    rng = np.random.default_rng(0)
    np_batch = {"tokens": rng.integers(0, 512, (4, 32)).astype(np.int32),
                "labels": rng.integers(0, 512, (4, 32)).astype(np.int32)}
    flavours = {"dsk": dataclasses.replace(cfgs["dsk"][0],
                                           tp_activations="manual_sp"),
                "qwen_gqa_bias": dataclasses.replace(
                    configs.get_reduced("qwen2-0.5b"), n_heads=8,
                    n_kv_heads=4, d_ff=128, dtype=torch.float32,
                    tp_activations="manual_sp")}
    res["manual_sp"] = {}
    for tag, c in flavours.items():
        init = api.get_model(c).init(torch.Generator().manual_seed(0))
        plain = Trainer(c, TrainerConfig(
            ckpt_dir=os.path.join(out_dir, f"port_msp_{tag}_{rank}"),
            ckpt_every=0, opt=opt, batch=4, seq_len=32, comm="single"),
            device="cpu", init_params=init)
        l0, g0 = plain._loss_and_grads(make_batch_arrays(np_batch, c, "cpu"))
        tr = trainer(c, init, 4, (2, 4), f"msp_{tag}")
        spmd.reset_counts()
        l2, g2 = tr._gspmd_loss_and_grads(tr._place_batch(np_batch))
        seq = sum(n for (op, t), n in spmd.counts.items() if t == "seq")
        g2 = {k: spmd.unshard(g, tr.pspecs[k], tr.mesh)
              for k, g in g2.items()}
        res["manual_sp"][tag] = {
            "plain_loss": float(l0), "sp_loss": float(l2),
            "seq_collectives": seq,
            "grad_err": {k: [float((g2[k] - g0[k]).abs().max()),
                             float(g0[k].abs().max())] for k in g0},
            "grad_ok": all(bool(torch.allclose(g2[k], g0[k], rtol=5e-3,
                                               atol=5e-5)) for k in g0)}
    _save_json(os.path.join(out_dir, f"rank{rank}_gspmd.json"), res)
    dist.destroy_process_group()


# ----------------------------------------------------------------------------
# the expert-parallel MoE layer (apply_moe_ep), after tests/ep_moe_check.py
# ----------------------------------------------------------------------------

# (2, 4) and (4, 2) dispatch expert-parallel.  The port's rows on each mesh:
# "rows" as the GSPMD trainer lays them (batch over "data", each "model"
# line the same rows), "whole" every rank the whole batch.
EP_MESHES = {(2, 4): "rows", (4, 2): "whole"}
# capacity factors: ample (nothing drops) and tight (tokens drop; EP's
# local capacity is not the global dispatch's, so EP is held to JAX's EP)
EP_REGIMES = {"ample": 8.0, "drop": 0.5}
EP_GRADS = ("router", "w_gate", "w_up", "w_down")
# JAX's fallback conditions (moe.py:163-164), each met once: (mesh or None,
# the port's rows, experts, the input's (B, S)); every one runs the global
# dispatch
EP_FALLBACKS = {"no_mesh": (None, "whole", 8, (4, 16)),
                "tp_1": ((8, 1), "whole", 8, (4, 16)),
                "experts": ((2, 4), "rows", 6, (4, 16)),
                "sequence": ((2, 4), "rows", 8, (4, 18)),
                "batch": ((2, 4), "whole", 8, (3, 16))}


def ep_cfg(configs_mod, MoeCfg, dtype, cf: float, n_experts: int = 8):
    """tests/ep_moe_check.py's MoE: the reduced olmoe with 8 experts top-2
    of width 32, d_model 64, fp32."""
    import dataclasses
    return dataclasses.replace(
        configs_mod.get_config("olmoe-1b-7b").reduced(),
        moe=MoeCfg(n_experts=n_experts, top_k=2, d_expert=32,
                   capacity_factor=cf),
        d_model=64, dtype=dtype, moe_impl="ep_a2a")


def ep_inputs() -> dict:
    """x as tests/ep_moe_check.py draws it, the output's cotangent ct, and
    the fallback cases' inputs (``x_<case>``)."""
    rng = np.random.default_rng(0)
    out = {"x": (rng.normal(size=(4, 16, 64)) * 0.3).astype(np.float32)}
    out["ct"] = rng.normal(size=(4, 16, 64)).astype(np.float32)
    for case, (_, _, _, (b, s)) in EP_FALLBACKS.items():
        out[f"x_{case}"] = (rng.normal(size=(b, s, 64)) * 0.3) \
            .astype(np.float32)
    return out


def jax_ep(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch.mesh import make_mesh
    from repro.models import moe
    from repro.models.common import MoeCfg
    from repro.parallel import sharding

    assert jax.device_count() == 8, jax.device_count()
    inp = ep_inputs()
    x, ct = jnp.asarray(inp["x"]), jnp.asarray(inp["ct"])
    res = {}
    params = {}
    for n in (8, 6):
        params[n] = moe.init_moe(ep_cfg(jconfigs, MoeCfg, jnp.float32, 8.0,
                                        n), jax.random.key(0))
        res.update({f"p{n}/{k}": v for k, v in params[n].items()})
    p = params[8]

    def on_mesh(shape, fn, *args):
        if shape is None:
            return jax.jit(fn)(*args)
        mesh = make_mesh(shape, ("data", "model"))
        sharding.set_runtime_mesh(mesh)
        try:
            with mesh:
                return jax.jit(fn)(*args)
        finally:
            sharding.set_runtime_mesh(None)

    for regime, cf in EP_REGIMES.items():
        cfg = ep_cfg(jconfigs, MoeCfg, jnp.float32, cf)
        res[f"global/{regime}/y"], res[f"global/{regime}/aux"] = \
            moe.apply_moe(cfg, p, x)

        def f(p, x, cfg=cfg):
            y, aux = moe.apply_moe_ep(cfg, p, x)
            return jnp.sum(y * ct) + aux, (y, aux)

        for shape in EP_MESHES:
            (_, (y, aux)), (dp, dx) = on_mesh(
                shape, jax.value_and_grad(f, argnums=(0, 1), has_aux=True),
                p, x)
            tag = f"{regime}/{shape[0]}x{shape[1]}"
            res.update({f"{tag}/y": y, f"{tag}/aux": aux, f"{tag}/dx": dx})
            res.update({f"{tag}/d_{k}": dp[k] for k in EP_GRADS})
    for case, (shape, _, n, _) in EP_FALLBACKS.items():
        cfg = ep_cfg(jconfigs, MoeCfg, jnp.float32, 1.25, n)
        xc = jnp.asarray(inp[f"x_{case}"])
        res[f"fallback/{case}/global"] = moe.apply_moe(cfg, params[n], xc)[0]
        res[f"fallback/{case}/y"] = on_mesh(
            shape, lambda p, x, cfg=cfg: moe.apply_moe_ep(cfg, p, x)[0],
            params[n], xc)
    _save_npz(os.path.join(out_dir, "jax_ep.npz"),
              {k: np.asarray(v) for k, v in res.items()})


def rank_ep(out_dir: str, rank: int, world: int, store: str):
    torch, dist = _init(rank, world, store)
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import MoeCfg
    from repro_torch.parallel import sharding, spmd

    inp = {k: torch.from_numpy(v) for k, v in ep_inputs().items()}
    with np.load(wait_for(os.path.join(out_dir, "jax_ep.npz"))) as z:
        ref = {k: z[k] for k in z.files}
    res, counts = {}, {}

    def params(cfg):
        p = moe.init_moe(cfg, None, "cpu")
        with torch.no_grad():
            for k in EP_GRADS:
                p.local(k).copy_(torch.from_numpy(
                    ref[f"p{cfg.moe.n_experts}/{k}"]))
        return p

    def counted(tag, fn):
        spmd.reset_counts()
        out = fn()
        counts[tag] = {f"{op}/{t}": n for (op, t), n in spmd.counts.items()}
        return out

    for shape, layout in EP_MESHES.items():
        mesh = make_mesh(shape, ("data", "model"))
        spec = ("data",) if layout == "rows" else None
        replicas = mesh.size // spmd.axis_index(mesh, spec)[1]
        for regime, cf in EP_REGIMES.items():
            cfg = ep_cfg(configs, MoeCfg, torch.float32, cf)
            p = params(cfg)
            for k in EP_GRADS:
                p.local(k).requires_grad_(True)
            x = spmd.shard(inp["x"], (spec,), mesh).clone() \
                .requires_grad_(True)
            ct = spmd.shard(inp["ct"], (spec,), mesh)
            sharding.set_runtime_mesh(mesh, (spec,))

            def step():
                y, aux = moe.apply_moe_ep(cfg, p, x)
                # each rank's objective: its rows' share of sum(y * ct)
                # and of aux, so the ranks' objectives sum to JAX's
                ((y * ct).sum() / replicas + aux / mesh.size).backward()
                return y, aux

            tag = f"{regime}/{shape[0]}x{shape[1]}"
            try:
                y, aux = counted(tag, step)
            finally:
                sharding.set_runtime_mesh(None)
            every = mesh.axis_names
            with torch.no_grad():
                res[f"{tag}/y"] = spmd.unshard(y, (spec,), mesh)
                res[f"{tag}/aux"] = aux
                res[f"{tag}/dx"] = spmd.unshard(spmd.all_reduce(
                    x.grad, mesh, "model" if spec else every), (spec,),
                    mesh)
                for k in EP_GRADS:
                    res[f"{tag}/d_{k}"] = spmd.all_reduce(
                        p.local(k).grad, mesh, every)
    for case, (shape, layout, n, _) in EP_FALLBACKS.items():
        cfg = ep_cfg(configs, MoeCfg, torch.float32, 1.25, n)
        p, x = params(cfg), inp[f"x_{case}"]
        if shape is None:
            res[f"fallback/{case}/y"] = counted(
                f"fallback/{case}", lambda: moe.apply_moe_ep(cfg, p, x)[0])
            continue
        mesh = make_mesh(shape, ("data", "model"))
        spec = ("data",) if layout == "rows" else None
        sharding.set_runtime_mesh(mesh, (spec,))
        try:
            with torch.no_grad():
                y = counted(f"fallback/{case}", lambda: moe.apply_moe_ep(
                    cfg, p, spmd.shard(x, (spec,), mesh))[0])
                res[f"fallback/{case}/y"] = spmd.unshard(y, (spec,), mesh)
        finally:
            sharding.set_runtime_mesh(None)
    np.savez(os.path.join(out_dir, f"rank{rank}_ep.npz"),
             **{k: v.detach().numpy() for k, v in res.items()})
    _save_json(os.path.join(out_dir, f"rank{rank}_ep.json"), counts)
    dist.destroy_process_group()


# ----------------------------------------------------------------------------
# the sharded attention wrappers (ops.sharded_flash_attention,
# ops.sharded_paged_attention)
# ----------------------------------------------------------------------------

# meshes over ("data", "model") and, for the data axes given as two, over
# ("pod", "data", "model")
SHARDED_MESHES = {"2x4": ((2, 4), ("data", "model")),
                  "4x2": ((4, 2), ("data", "model")),
                  "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def sharded_inputs() -> dict:
    """(B, H, S, D) q over (B, Hkv, S, D) k/v; paged: q (B, H, D), pools
    (n_pages, page, Hkv, D), a scattered table and ragged lengths."""
    rng = np.random.default_rng(5)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    return dict(fa_q=f(4, 8, 24, 16), fa_k=f(4, 4, 24, 16),
                fa_v=f(4, 4, 24, 16), pa_q=f(4, 8, 16),
                pa_k=f(20, 8, 4, 16), pa_v=f(20, 8, 4, 16),
                pa_table=rng.permutation(20)[:16].reshape(4, 4)
                .astype(np.int32),
                pa_lens=np.array([1, 9, 32, 17], np.int32))


def _sharded_axes(names):
    return tuple(a for a in names if a != "model")


def jax_sharded(out_dir: str) -> None:
    import jax

    from repro.kernels import ops
    from repro.launch.mesh import make_mesh

    assert jax.device_count() == 8, jax.device_count()
    inp = sharded_inputs()
    res = {}
    for tag, (shape, names) in SHARDED_MESHES.items():
        mesh, dx = make_mesh(shape, names), _sharded_axes(names)
        with mesh:
            for causal in (True, False):
                res[f"{tag}/flash/{int(causal)}"] = jax.jit(
                    ops.sharded_flash_attention(mesh, data_axes=dx,
                                                causal=causal))(
                    inp["fa_q"], inp["fa_k"], inp["fa_v"])
            res[f"{tag}/paged"] = jax.jit(ops.sharded_paged_attention(
                mesh, data_axes=dx))(inp["pa_q"], inp["pa_k"], inp["pa_v"],
                                     inp["pa_table"], inp["pa_lens"])
    _save_npz(os.path.join(out_dir, "jax_sharded.npz"),
              {k: np.asarray(v) for k, v in res.items()})


def rank_sharded(out_dir: str, rank: int, world: int, store: str):
    torch, dist = _init(rank, world, store)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import spmd

    inp = {k: torch.from_numpy(v) for k, v in sharded_inputs().items()}
    res, shapes = {}, {}

    def run(fn, *args):
        blocks = [spmd.shard(a, s, fn.mesh).contiguous()
                  for a, s in zip(args, fn.in_specs)]
        out = fn(*blocks)
        return spmd.unshard(out, fn.out_spec, fn.mesh), \
            [list(b.shape) for b in blocks] + [list(out.shape)]

    for tag, (shape, names) in SHARDED_MESHES.items():
        mesh, dx = make_mesh(shape, names), _sharded_axes(names)
        for causal in (True, False):
            res[f"{tag}/flash/{int(causal)}"], shapes[f"{tag}/flash"] = run(
                ops.sharded_flash_attention(mesh, data_axes=dx,
                                            causal=causal),
                inp["fa_q"], inp["fa_k"], inp["fa_v"])
        res[f"{tag}/paged"], shapes[f"{tag}/paged"] = run(
            ops.sharded_paged_attention(mesh, data_axes=dx), inp["pa_q"],
            inp["pa_k"], inp["pa_v"], inp["pa_table"], inp["pa_lens"])
    np.savez(os.path.join(out_dir, f"rank{rank}_sharded.npz"),
             **{k: v.numpy() for k, v in res.items()})
    _save_json(os.path.join(out_dir, f"rank{rank}_sharded.json"), shapes)
    dist.destroy_process_group()


def rank_ep_step(out_dir: str, rank: int, world: int, store: str):
    """olmoe's and moonshot's reduced configs (``moe_impl="ep_a2a"``)
    built and stepped twice by ``Trainer(comm="gspmd")`` on a (4, 2)
    mesh, from the seed's weights: the losses and the collectives run."""
    torch, dist = _init(rank, world, store)
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import spmd
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    res = {}
    for name in ("olmoe-1b-7b", "moonshot-v1-16b-a3b"):
        cfg = configs.get_reduced(name)
        tr = Trainer(cfg, TrainerConfig(
            ckpt_dir=os.path.join(out_dir, f"port_{name}"), ckpt_every=0,
            opt=AdamWConfig(**OPT), batch=8, seq_len=32, comm="gspmd"),
            mesh=make_mesh((4, 2), ("data", "model")), device="cpu")
        spmd.reset_counts()
        res[name] = {"moe_impl": cfg.moe_impl,
                     "model_axis": tr.mesh.shape["model"],
                     "losses": [m["loss"] for m in tr.train(2)],
                     "counts": {f"{op}/{t}": n for (op, t), n
                                in spmd.counts.items()}}
    _save_json(os.path.join(out_dir, f"rank{rank}_ep_step.json"), res)
    dist.destroy_process_group()


# ----------------------------------------------------------------------------
# tensor-parallel serving (prefill, then greedy decode steps) over ("data",
# "model") meshes: JAX's prefill and decode_step jitted with its dry run's
# in_shardings (param_specs, batch_specs, decode_state_specs), and unsharded
# ----------------------------------------------------------------------------

SERVE_MESHES = ((8, 1), (4, 2), (2, 4))
SERVE_STEPS = 8
SERVE_PROMPT = 8


def serve_cfgs(configs_mod, ArchCfg, dtype, half):
    """{tag: (cfg, batch, meshes, max_len)}: TINY, manual_sp_check.py's
    deepseek, the reduced qwen2 (dp_only, batch 4: its prefill takes the
    sequence over "model"), the reduced olmoe with the global dispatch and
    as configured (``ep_a2a``) and the reduced internvl2 (vlm: 4 prefix
    embeddings before the prompt; fp32 attention) on every mesh, with a
    32-deep cache (4 slices of 8 where "model" is 4: the first decode
    steps leave the last two empty); TINY on (2, 4) with a 24-deep cache
    (slices of 6, shallower than the 8-token prompt) and a 48-deep one
    (slices of 12, the prompt inside the first): a "seq" shard whose depth
    alone would pass for a whole cache's; ODD (1 KV head) with a 17-deep cache
    on (4, 2), where ``decode_state_specs`` puts the batch over "model" at
    batch 2 and, at batch 4 (the batch over "data"), the layers (the
    "other" layout); and the reduced internvl2 as
    configured (bf16 attention) on (2, 4), where the "seq" layout's split
    softmax rounds its probabilities slice by slice (``SERVE_FORCED``).
    ``half`` is the framework's bf16: the reduced rwkv6 and zamba2 in bf16
    on (2, 4), whose rank programs sum bf16 partials over "model" as JAX's
    partitioned program does (``SERVE_FORCED`` too).
    The recurrent families (``SERVE_RECURRENT``): the reduced rwkv6,
    mamba2 (the reduced zamba2's backbone) and zamba2 on every mesh, where
    ``decode_state_specs`` splits the wkv / ssd states on their readout's
    contracted dim and, on (4, 2) and (2, 4) where "model" divides the
    layers, puts the token shifts (rwkv6's 2 layers, (4, 2) only) and the
    conv states (4 layers) on the layers; rwkv6 and zamba2 on (1, 8) too,
    where 8 divides neither rwkv6's 4 heads (its prefill runs whole and
    re-lays the state onto the keys) nor zamba2's 4 shared-block heads
    (the block runs whole, its caches split on the sequence and re-laid
    an application at a time); rwkv6 at batch 2 on (4, 2),
    whose shifts take the batch over "model"; zamba2 on (2, 4) with a
    2-token prompt, shorter than its conv window (``SERVE_PROMPTS``).
    The encoder-decoder (``SERVE_ENCDEC``, 8 frames from the seed): the
    reduced whisper on every mesh and (1, 8), its self K/V on the heads
    on (4, 2) and on the sequence elsewhere, its cross K/V on the heads
    on (4, 2) and on the frames on (2, 4) and (1, 8); with 6 frames and 4
    layers on (2, 4) (the cross K/V on the layers) and (1, 8) (not split
    over "model"); at batch 2 on (4, 2) (the batch over no axis); in
    bf16 on (2, 4) (``SERVE_FORCED``, ``SERVE_PLAIN``).
    The order is the port's; the JAX processes take alternate tags.  The
    environment's ``SERVE_TAGS`` (comma-separated) runs a subset."""
    import dataclasses

    def reduced(name, **kw):
        return dataclasses.replace(configs_mod.get_reduced(name),
                                   **{"dtype": dtype, **kw})

    cfgs = {
        "tiny": (ArchCfg(**TINY, dtype=dtype), 8, SERVE_MESHES, 32),
        "tiny24": (ArchCfg(**TINY, dtype=dtype), 8, ((2, 4),), 24),
        "tiny48": (ArchCfg(**TINY, dtype=dtype), 8, ((2, 4),), 48),
        "olmoe": (reduced("olmoe-1b-7b", moe_impl="global"), 8,
                  SERVE_MESHES, 32),
        "dsk": (reduced("deepseek-7b", **DSK), 8, SERVE_MESHES, 32),
        "olmoe-ep": (reduced("olmoe-1b-7b"), 8, SERVE_MESHES, 32),
        "qwen": (reduced("qwen2-0.5b"), 4, SERVE_MESHES, 32),
        "vlm": (reduced("internvl2-76b", attn_dtype="f32"), 8,
                SERVE_MESHES, 32),
        "odd": (ArchCfg(**ODD, dtype=dtype), 2, ((4, 2),), 17),
        "oddl": (ArchCfg(**ODD, dtype=dtype), 4, ((4, 2),), 17),
        "vlm-bf16": (reduced("internvl2-76b"), 8, ((2, 4),), 32),
        "rwkv": (reduced("rwkv6-1.6b"), 8, SERVE_MESHES + ((1, 8),), 32),
        "mamba": (reduced("zamba2-1.2b", family="mamba2"), 8, SERVE_MESHES,
                  32),
        "zamba": (reduced("zamba2-1.2b"), 8, SERVE_MESHES + ((1, 8),), 32),
        "rwkvb2": (reduced("rwkv6-1.6b"), 2, ((4, 2),), 32),
        "zambas": (reduced("zamba2-1.2b"), 8, ((2, 4),), 32),
        "rwkv-bf16": (reduced("rwkv6-1.6b", dtype=half), 8, ((2, 4),), 32),
        "zamba-bf16": (reduced("zamba2-1.2b", dtype=half), 8, ((2, 4),),
                       32),
        "whisper": (reduced("whisper-large-v3"), 8,
                    SERVE_MESHES + ((1, 8),), 32),
        "whisper6x4": (reduced("whisper-large-v3", n_frames=6, n_layers=4),
                       8, ((2, 4), (1, 8)), 32),
        "whisperb2": (reduced("whisper-large-v3"), 2, ((4, 2),), 32),
        "whisper-bf16": (reduced("whisper-large-v3", dtype=half), 8,
                         ((2, 4),), 32),
    }
    only = os.environ.get("SERVE_TAGS")     # a comma-separated subset
    return {k: v for k, v in cfgs.items()
            if not only or k in only.split(",")}


# the recurrent families' tags, and the prompts other than SERVE_PROMPT
SERVE_RECURRENT = ("rwkv", "mamba", "zamba", "rwkvb2", "zambas",
                   "rwkv-bf16", "zamba-bf16")
# the encoder-decoder's tags
SERVE_ENCDEC = ("whisper", "whisper6x4", "whisperb2", "whisper-bf16")
SERVE_PROMPTS = {"zambas": 2}
# the tags whose unsharded JAX run is kept (beside the partitioned ones)
SERVE_WHOLE = ("olmoe-ep", "rwkv-bf16", "zamba-bf16", "whisper-bf16")
# the tags whose port also runs its plain path (no mesh) on rank 0, and
# whose unsharded JAX run is fed the tokens of their one partitioned run,
# as that plain path is: the spread of the four bf16 runs
SERVE_PLAIN = ("rwkv-bf16", "zamba-bf16", "whisper-bf16")


def serve_prompt(tag: str) -> int:
    return SERVE_PROMPTS.get(tag, SERVE_PROMPT)


def serve_prefill_kw(cfg, max_len: int) -> dict:
    """The prefill's keywords: the caches' depth, for the families whose
    decode state has one."""
    return {} if cfg.family in ("rwkv6", "mamba2") else {"max_len": max_len}


def state_leaves(state) -> dict:
    """{"/"-joined path: tensor or array} of a decode state's leaves (a
    decoder's cache {"k", "v"}; a recurrent family's state; the
    encoder-decoder's self and cross K/V), its depth entry ("max_len")
    left out."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": t for p, t in state_leaves(v).items()})
        elif k != "max_len":
            out[k] = v
    return out


def jax_layout(state) -> dict:
    """``state_leaves`` of a port state as fp32 numpy copies in JAX's
    layout (a decode step writes its caches in place): the encoder-
    decoder's cross K/V, (L, B, Hkv, F, hd) in the port, permuted to
    JAX's (L, B, F, Hkv, hd)."""
    return {k: (v.transpose(2, 3) if k in ("cross_k", "cross_v") else v)
            .float().clone().numpy() for k, v in state_leaves(state).items()}


# JAX's processes (run side by side): alternate tags of serve_cfgs
SERVE_JAX_PARTS = 2
# the cases fed the JAX run's greedy tokens (teacher forcing), where the
# port parts from the reference by bf16 rounding (the split softmax; the
# bf16 models' sums in another order) and a near-tie can flip a token
SERVE_FORCED = ("vlm-bf16", "rwkv-bf16", "zamba-bf16", "whisper-bf16")


def serve_batch(cfg, batch: int, prompt: int = SERVE_PROMPT) -> dict:
    """The prompt (and a VLM's prefix embeddings, an encoder-decoder's
    frames), from one seed."""
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, prompt))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.normal(
            size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def serve_context(cfg, prompt: int = SERVE_PROMPT) -> int:
    """The prompt's positions: the first decode step writes there."""
    return prompt + (cfg.n_patches if cfg.family == "vlm" else 0)


def jax_serve_tp(out_dir: str, part: int) -> None:
    import contextlib
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.launch.mesh import make_mesh
    from repro.models import api
    from repro.models.common import ArchCfg
    from repro.parallel import sharding

    assert jax.device_count() == 8, jax.device_count()

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(getattr(p, "key", p)) for p in path):
                np.asarray(leaf) for path, leaf in leaves}

    cfgs = serve_cfgs(jconfigs, ArchCfg, jnp.float32, jnp.bfloat16)
    for tag in list(cfgs)[part::SERVE_JAX_PARTS]:
        cfg, B, meshes, max_len = cfgs[tag]
        # JAX's build_decode: TP specs for the decode step even under
        # dp_only
        dcfg = dataclasses.replace(cfg, parallelism="tp_dp") \
            if cfg.parallelism == "dp_only" else cfg
        model, dmodel = api.get_model(cfg), api.get_model(dcfg)
        params = model.init(jax.random.PRNGKey(0))
        _save_npz(os.path.join(out_dir, f"jax_serve_init_{tag}.npz"),
                  flat(params))
        prompt = serve_prompt(tag)
        batch = {k: jnp.asarray(v)
                 for k, v in serve_batch(cfg, B, prompt).items()}
        ctx = serve_context(cfg, prompt)
        whole = (None,) if tag in SERVE_WHOLE else ()
        # a SERVE_PLAIN tag's unsharded run comes last, fed the tokens of
        # its partitioned run
        shapes = tuple(meshes) + whole if tag in SERVE_PLAIN \
            else whole + tuple(meshes)
        fed = None
        for shape in shapes:
            prefill = functools.partial(model.prefill,
                                        **serve_prefill_kw(cfg, max_len))
            if shape is None:
                mesh, scope = None, contextlib.nullcontext()
                pre, dec = jax.jit(prefill), jax.jit(dmodel.decode_step)
            else:
                mesh = make_mesh(shape, ("data", "model"))
                scope = mesh
                psh = sharding.named(mesh, sharding.param_specs(cfg, params,
                                                                mesh))
                bsh = sharding.named(mesh, sharding.batch_specs(cfg, batch,
                                                                mesh))
                pre = jax.jit(prefill, in_shardings=(psh, bsh))
            sharding.set_runtime_mesh(mesh)
            try:
                with scope:
                    logits, cache = pre(params, batch)
                    if mesh is not None:
                        tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
                        dsh = (sharding.named(mesh, sharding.param_specs(
                                   dcfg, params, mesh)),
                               sharding.named(mesh, sharding.batch_specs(
                                   dcfg, {"t": tok}, mesh))["t"],
                               sharding.named(mesh, sharding.decode_state_specs(
                                   dcfg, cache, mesh, B)),
                               NamedSharding(mesh, P()))
                        dec = jax.jit(dmodel.decode_step, in_shardings=dsh)
                    res = {f"prefill_{k}": v
                           for k, v in state_leaves(cache).items()}
                    lgs, toks = [logits[:, -1]], []
                    for i in range(SERVE_STEPS):
                        t = jnp.argmax(lgs[-1], -1).astype(
                            jnp.int32)[:, None] if fed is None \
                            else fed[i][:, None]
                        toks.append(t[:, 0])
                        if mesh is not None:   # committed to the specs
                            t, cache = jax.device_put((t, cache), dsh[1:3])
                        logits, cache = dec(params, t, cache,
                                            jnp.int32(ctx + i))
                        lgs.append(logits[:, -1])
            finally:
                sharding.set_runtime_mesh(None)
            res.update(logits=jnp.stack(lgs), tokens=jnp.stack(toks),
                       **state_leaves(cache))
            if tag in SERVE_PLAIN:
                fed = res["tokens"]
            name = "whole" if shape is None else f"{shape[0]}x{shape[1]}"
            _save_npz(os.path.join(out_dir, f"jax_serve_{tag}_{name}.npz"),
                      {k: np.asarray(v) for k, v in res.items()})


def rank_serve_tp(out_dir: str, rank: int, world: int, store: str):
    """Each config and mesh: the JAX weights sharded by ``param_specs``
    (the decode step's by the serving config's), the prompt's rows (and
    sequence) by ``batch_specs``, ``prefill`` then 8 greedy
    ``decode_step``s under the runtime mesh; per rank the logits, the
    tokens, the cache shards, the collectives of the prefill and of one
    decode step, the parameters gathered in a decode step, and the shapes
    held; for the recurrent families the collectives of state and cache
    layers in a decode step, with their results' shapes."""
    import copy

    torch, dist = _init(rank, world, store)
    from repro_torch import configs, weights
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api, transformer
    from repro_torch.models.common import ArchCfg
    from repro_torch.parallel import sharding, spmd
    from repro_torch.runtime.trainer import shard_params

    gathered = []
    plain_gather = spmd.gather_param

    def gather_param(p):     # the parameters a layer reads gathered
        gathered.append(list(p.shape))
        return plain_gather(p)

    spmd.gather_param = gather_param
    moved = []       # (op, tag, result shape) of the state's collectives

    def watch(op, at):        # at: the position of the tag argument
        plain = getattr(spmd, op)

        def run(*args, **kw):
            out = plain(*args, **kw)
            tag = kw.get("tag", args[at] if len(args) > at else "")
            if tag in ("state", "cache", "cross"):
                moved.append([op, tag, list(out.shape)])
            return out
        return run

    for op, at in (("all_gather", 4), ("broadcast", 4),
                   ("reduce_scatter", 4), ("all_reduce", 3),
                   ("all_to_all", 5)):
        setattr(spmd, op, watch(op, at))
    res, arrays = {}, {}
    for tag, (cfg, B, meshes, max_len) in serve_cfgs(
            configs, ArchCfg, torch.float32, torch.bfloat16).items():
        with np.load(wait_for(os.path.join(
                out_dir, f"jax_serve_init_{tag}.npz"))) as z:
            init = weights.from_jax_params(
                cfg, weights.nest({k: z[k] for k in z.files}), device="cpu")
        prompt = serve_prompt(tag)
        batch = {k: torch.from_numpy(v).long() if k == "tokens" else
                 torch.from_numpy(v)
                 for k, v in serve_batch(cfg, B, prompt).items()}
        dcfg = transformer.serving_cfg(cfg)
        ctx = serve_context(cfg, prompt)
        if tag in SERVE_PLAIN and rank == 0:
            arrays.update({f"{tag}_whole/{k}": v for k, v in _serve_plain(
                cfg, init, batch, max_len, ctx,
                os.path.join(out_dir, f"jax_serve_{_tag(tag, meshes[0])}"
                             ".npz")).items()})
        for shape in meshes:
            case = _tag(tag, shape)
            mesh = make_mesh(shape, ("data", "model"))
            params = copy.deepcopy(init)
            shard_params(cfg, params, mesh)
            dparams = params
            if dcfg is not cfg:
                dparams = copy.deepcopy(init)
                shard_params(dcfg, dparams, mesh)
            bspec = sharding.batch_specs(cfg, batch, mesh)
            local = {k: spmd.shard(v, bspec[k], mesh) for k, v in
                     batch.items()}
            tspec = sharding.batch_specs(dcfg, {"t": batch["tokens"][:, :1]},
                                         mesh)["t"]
            rows = spmd.shard(torch.arange(B), (tspec[0],), mesh)
            out = {"counts": {}}
            sharding.set_runtime_mesh(mesh, bspec["tokens"])
            spmd.reset_counts()
            try:
                with torch.no_grad():
                    logits, cache = api.get_model(cfg).prefill(
                        params, local, **serve_prefill_kw(cfg, max_len))
            finally:
                sharding.set_runtime_mesh(None)
            out["counts"]["prefill"] = {f"{op}/{t}": n for (op, t), n
                                        in spmd.counts.items()}
            logits = spmd.relayout(logits, (bspec["tokens"][0],),
                                   (tspec[0],), mesh)
            for k, v in jax_layout(cache).items():
                arrays[f"{case}/prefill_{k}"] = v
            lgs, toks = [logits[:, -1]], []
            forced = None
            if tag in SERVE_FORCED:
                with np.load(wait_for(os.path.join(
                        out_dir, f"jax_serve_{case}.npz"))) as z:
                    forced = torch.from_numpy(z["tokens"]).long()[:, rows]
            sharding.set_runtime_mesh(mesh, tspec)
            try:
                for i in range(SERVE_STEPS):
                    t = lgs[-1].argmax(-1)[:, None] if forced is None \
                        else forced[i][:, None]
                    toks.append(t[:, 0])
                    spmd.reset_counts()
                    gathered.clear()
                    moved.clear()
                    with torch.no_grad():
                        logits, cache = api.get_model(dcfg).decode_step(
                            dparams, t, cache, ctx + i)
                    if i == 0:
                        out["counts"]["decode"] = {
                            f"{op}/{t}": n for (op, t), n
                            in spmd.counts.items()}
                        out["decode_gathered"] = list(gathered)
                        out["decode_moved"] = list(moved)
                    lgs.append(logits[:, -1])
            finally:
                sharding.set_runtime_mesh(None)
            logits = torch.stack(lgs)
            out["finite"] = bool(torch.isfinite(logits).all())
            if tag not in SERVE_RECURRENT:
                out["layout"] = sharding.cache_layout(dcfg, mesh, B,
                                                      max_len)[0]
            out["rows"] = rows.tolist()
            out["params"] = {k: list(v.shape) for k, v in
                             params.named_parameters()}
            out["decode_params"] = {k: list(v.shape) for k, v in
                                    dparams.named_parameters()}
            res[case] = out
            arrays.update({f"{case}/logits": logits.float().numpy(),
                           f"{case}/tokens": torch.stack(toks).numpy()})
            arrays.update({f"{case}/{k}": v
                           for k, v in jax_layout(cache).items()})
    _save_npz(os.path.join(out_dir, f"rank{rank}_serve_tp.npz"), arrays)
    _save_json(os.path.join(out_dir, f"rank{rank}_serve_tp.json"), res)
    dist.destroy_process_group()


def _serve_plain(cfg, params, batch, max_len, ctx, fed_from):
    """The port's plain path (no mesh) on the whole batch: prefill, then
    SERVE_STEPS decode steps fed the tokens of the JAX run saved at
    ``fed_from``.  Returns
    its logits (1 + steps, B, V) and its state's leaves after the prefill
    ("prefill_" and the path) and after the steps, as fp32 arrays."""
    import torch

    from repro_torch.models import api
    with np.load(wait_for(fed_from)) as z:
        forced = torch.from_numpy(z["tokens"]).long()
    model = api.get_model(cfg)
    with torch.no_grad():
        logits, state = model.prefill(params, batch,
                                      **serve_prefill_kw(cfg, max_len))
        out = {f"prefill_{k}": v
               for k, v in jax_layout(state).items()}
        lgs = [logits[:, -1]]
        for i in range(SERVE_STEPS):
            logits, state = model.decode_step(params, forced[i][:, None],
                                              state, ctx + i)
            lgs.append(logits[:, -1])
    out.update(jax_layout(state))
    out["logits"] = torch.stack(lgs).float().numpy()
    return out


def main(argv) -> None:
    mode, out_dir = argv[1], argv[2]
    if mode == "jax-collectives":
        jax_collectives(out_dir)
    elif mode == "jax-trainer":
        jax_trainer(out_dir)
    elif mode == "jax-gspmd":
        jax_gspmd(out_dir, int(argv[3]))
    elif mode == "jax-ep":
        jax_ep(out_dir)
    elif mode == "jax-sharded":
        jax_sharded(out_dir)
    elif mode == "jax-serve_tp":
        jax_serve_tp(out_dir, int(argv[3]))
    elif mode in ("rank-collectives", "rank-trainer", "rank-gspmd",
                  "rank-ep", "rank-sharded", "rank-ep_step",
                  "rank-serve_tp"):
        rank, world, store = int(argv[3]), int(argv[4]), argv[5]
        fn = {"rank-collectives": rank_collectives,
              "rank-trainer": rank_trainer, "rank-gspmd": rank_gspmd,
              "rank-ep": rank_ep, "rank-sharded": rank_sharded,
              "rank-ep_step": rank_ep_step,
              "rank-serve_tp": rank_serve_tp}[mode]
        fn(out_dir, rank, world, store)
    else:
        raise SystemExit(f"unknown mode {mode}")
    print(f"{mode} done")


if __name__ == "__main__":
    main(sys.argv)
