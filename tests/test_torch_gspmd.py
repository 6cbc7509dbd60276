"""The port's GSPMD training (``Trainer(comm="gspmd")``) against the JAX
package's, on the CPU.

One module fixture runs ``tests/torch_dist_checks.py``'s "gspmd" mode once:
JAX's ``Trainer(comm="gspmd")`` on 8 forced host devices in two
subprocesses, the port's 8 gloo ranks in 8 more, side by side, each port
config starting from JAX's initial weights.  Configs
(``torch_dist_checks.gspmd_cfgs``): TINY (tp_dp, "free"),
manual_sp_check.py's deepseek (tp_dp, manual_sp) and the reduced qwen2
(dp_only, batch 4) on meshes (8, 1), (4, 2) and (2, 4) over ("data",
"model"); the reduced olmoe (MoE, global dispatch), rwkv6, whisper and
zamba2 on one mesh each; the reduced olmoe as configured (the
expert-parallel dispatch, ``moe_impl="ep_a2a"``) on (4, 2) and (2, 4),
its router and expert gradients at the first batch held to ``jax.grad``
on the same mesh.  Losses are held to JAX's to rtol 1e-5
(fp32); checkpoints pass both ways; a node fault on the 2-D mesh
restores without a re-mesh, as in JAX; the sequence-parallel stack meets manual_sp_check.py's bars against
the plain stack (loss rtol 2e-5, gradients rtol 5e-3 / atol 5e-5).
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.common import ArchCfg  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as tdc  # noqa: E402

RTOL = 1e-5
CASES = [tdc._tag(t, s) for t, (_, _, meshes)
         in tdc.gspmd_cfgs(configs, ArchCfg, torch.float32).items()
         for s in meshes]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gspmd"))
    tdc.launch("gspmd", out, timeout=600)
    parts = []
    for i in range(len(tdc.GSPMD_JAX_PARTS)):
        with open(os.path.join(out, f"jax_gspmd_{i}.json")) as f:
            parts.append(json.load(f))
    ref = parts[0]
    for p in parts[1:]:
        ref["losses"].update(p["losses"])
    ranks = []
    for r in range(8):
        with open(os.path.join(out, f"rank{r}_gspmd.json")) as f:
            ranks.append(json.load(f))
    return {"jax": ref, "ranks": ranks, "port": ranks[0], "out": out}


@pytest.mark.parametrize("case", CASES)
def test_gspmd_losses_match_jax_on_8_ranks(run, case):
    np.testing.assert_allclose(run["port"]["losses"][case],
                               run["jax"]["losses"][tdc.ref_tag(case)],
                               rtol=RTOL)
    for r in run["ranks"]:        # every rank reports the global mean loss
        assert r["losses"][case] == run["port"]["losses"][case]


def test_jax_gspmd_rwkv6_on_a_model_axis_parts_from_its_unsharded_run(run):
    """ROADMAP §3: JAX's partitioned rwkv6 on (4, 2) drops the gradient
    of the second "model" shard of ``tm.u``, so its losses part from its
    (8, 1) run's after the first update; the port's (4, 2) run keeps to
    the (8, 1) one, the reference the losses test holds it to."""
    ref, port = run["jax"]["losses"], run["port"]["losses"]
    whole, cut = ref["rwkv6_8x1"], ref["rwkv6_4x2"]
    np.testing.assert_allclose(cut[0], whole[0], rtol=RTOL)
    assert abs(cut[-1] - whole[-1]) > RTOL * abs(whole[-1])
    np.testing.assert_allclose(port["rwkv6_4x2"], whole, rtol=RTOL)


@pytest.mark.parametrize("case", [
    tdc._tag(t, m) for t in tdc.GSPMD_GRAD_CFGS
    for m in tdc.gspmd_cfgs(configs, ArchCfg, torch.float32)[t][2]])
def test_ep_router_and_expert_gradients_match_jax_grad(run, case):
    """The expert-parallel olmoe's gradients at the first batch, gathered
    to JAX's layout: the router's (the sum of every rank's share, its aux
    term through the mean over the mesh) and each expert tensor's (each
    rank's own experts), against ``jax.grad`` of JAX's GSPMD loss on the
    same mesh; the forward dispatched over "model" (two all-to-alls a
    layer, each run again in remat's recompute)."""
    out = run["out"]
    with np.load(os.path.join(out, f"jax_gspmd_grads_{case}.npz")) as z:
        want = {k: z[k] for k in z.files}
    with np.load(os.path.join(out, f"port_gspmd_grads_{case}.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want) == sorted(
        k.replace("/", ".") for k in tdc.GSPMD_GRAD_KEYS)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
    layers = 2
    for r in run["ranks"]:
        n = r["ep_counts"][case]
        assert n["all_to_all/moe"] == 2 * 2 * layers
        assert n["all_to_all/moe/bwd"] == 2 * layers


def _expected_shard(shape, spec, mesh_shape):
    sizes = dict(zip(("data", "model"), mesh_shape))
    out = list(shape)
    for i, e in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            out[i] //= sizes[a]
    return out


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_only_its_spec_shards(run, case):
    """Every rank's parameter and moment shards have the shapes its specs
    give them (``param_specs``, ``zero1_specs``), not the leaves'."""
    tag, mesh_shape = case.split("_")[0], tuple(
        int(x) for x in case.split("_")[1].split("x"))
    cfg = tdc.gspmd_cfgs(configs, ArchCfg, torch.float32)[tag][0]
    mesh = sharding.abstract_mesh(mesh_shape, ("data", "model"))
    shapes = api.param_shapes(cfg)
    flat = sharding.flatten(shapes)
    pspecs = sharding.flatten(sharding.param_specs(cfg, shapes, mesh))
    zspecs = sharding.flatten(sharding.zero1_specs(cfg, shapes, mesh))
    sharded = False
    for r in run["ranks"]:
        held = r["local_shapes"][case]
        assert set(held) == set(flat)
        for k, t in flat.items():
            p, m, v = held[k]
            assert p == _expected_shard(t.shape, pspecs[k], mesh_shape), k
            assert m == v == _expected_shard(t.shape, zspecs[k],
                                             mesh_shape), k
            sharded |= p != list(t.shape)
    # TP configs shard parameters on a "model" axis; dp_only never does
    assert sharded == (mesh_shape[1] > 1 and cfg.parallelism != "dp_only")


def test_jax_gspmd_checkpoint_resumes_in_the_port(run):
    assert run["port"]["from_jax_step"] == 2
    np.testing.assert_allclose(run["port"]["from_jax_loss"],
                               run["jax"]["ckpt_losses"][2], rtol=RTOL)


def test_port_gspmd_checkpoint_resumes_in_jax(run):
    assert run["jax"]["from_port_step"] == 2
    np.testing.assert_allclose(run["jax"]["from_port_loss"],
                               run["port"]["ckpt_losses"][2], rtol=RTOL)
    np.testing.assert_allclose(run["port"]["ckpt_losses"],
                               run["jax"]["ckpt_losses"], rtol=RTOL)


def test_node_fault_on_a_2d_mesh_restores_without_remesh_as_in_jax(run):
    port, ref = run["port"], run["jax"]
    assert port["fault_events"] == ref["fault_events"]
    assert not any("re-mesh" in e for e in port["fault_events"])
    assert port["fault_mesh"] == ref["fault_mesh"] == [4, 2]
    np.testing.assert_allclose(port["fault_losses"], ref["fault_losses"],
                               rtol=RTOL)


@pytest.mark.parametrize("flavour", ["dsk", "qwen_gqa_bias"])
def test_manual_sp_matches_the_plain_stack(run, flavour):
    """manual_sp_check.py's bars on mesh (2, 4): the loss within rtol
    2e-5 of the plain stack's, every gradient within rtol 5e-3, atol 5e-5
    (both flavours; JAX's check holds the GQA + bias one by its loss)."""
    for r in run["ranks"]:
        res = r["manual_sp"][flavour]
        np.testing.assert_allclose(res["sp_loss"], res["plain_loss"],
                                   rtol=2e-5)
        assert res["grad_ok"], res["grad_err"]
        assert res["seq_collectives"] > 0    # the sequence-parallel stack


def test_manual_sp_issues_one_all_gather_and_one_reduce_scatter_a_sub_block(
        run):
    """One forward of the deepseek on (4, 2): each of the 2 x L sub-blocks
    one all-gather and one reduce-scatter of the sequence, plus the stack's
    closing all-gather."""
    L = run["port"]["fwd"]["dsk"]["layers"]
    for r in run["ranks"]:
        counts = r["fwd"]["dsk"]["counts"]
        assert counts["all_gather/seq"] == 2 * L + 1
        assert counts["reduce_scatter/seq"] == 2 * L
        assert "all_reduce/act" not in counts


def test_dp_only_computes_on_its_slice_of_the_sequence(run):
    """The reduced qwen2 (dp_only, batch 4) on (2, 4): the sequence is over
    "model", and each rank runs the stack on its 32 / 4 positions, with one
    all-gather of K/V a layer and one all-reduce of the label count, and
    no other collective (no rank computes another's rows)."""
    for r in run["ranks"]:
        fwd = r["fwd"]["qwen"]
        assert fwd["rows"] == [2, 8]
        assert fwd["counts"] == {"all_gather/kv": fwd["layers"],
                                 "all_reduce/loss": 1}


def test_host_test_mesh_lays_ranks_out_row_major_as_jax(run):
    devices = np.array(run["jax"]["host_test_mesh"])
    for rank, r in enumerate(run["ranks"]):
        coords = tuple(r["host_test_mesh"]["coords"])
        assert devices[coords] == rank
        assert r["host_test_mesh"]["line_a"] == list(devices[:, coords[1]])
        assert r["host_test_mesh"]["line_b"] == list(devices[coords[0]])
