"""Serving cluster of the PyTorch port vs the JAX package's.

The cases of ``tests/test_serving_cluster.py`` (router placement, live
migration mid-decode, a link-fault reroute, an unroutable fabric, a full
destination, rebalance, striped migration, QoS protecting decode,
contention, congestion-aware routing, the TP twin re-lowered around a
fault) run on both packages at the same reduced size: smollm-135m
reduced (fp32), the same weights (``weights.from_jax_params``), the same
prompts.  Tokens, ``MigrationReport``s and ``stats()`` (all but the
wall-clock fields) must be EQUAL; so must ``n_params``, which prices
every modelled second of the timeline.  The port's nodes run on the CPU
here (``device="cpu"``) and share one ``TransformerLM``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import apelink as j_apelink  # noqa: E402
from repro.core import fabric as j_fabric  # noqa: E402
from repro.core import hw as j_hw  # noqa: E402
from repro.core.fabric import sim as j_sim  # noqa: E402
from repro.core.topology import Torus as JTorus  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import cluster as j_cluster  # noqa: E402
from repro.serving import engine as j_engine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import apelink as t_apelink  # noqa: E402
from repro_torch.core import fabric as t_fabric  # noqa: E402
from repro_torch.core import hw as t_hw  # noqa: E402
from repro_torch.core.fabric import sim as t_sim  # noqa: E402
from repro_torch.core.topology import Torus as TTorus  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.serving import cluster as t_cluster  # noqa: E402
from repro_torch.serving import engine as t_engine  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(1)

WALL = ("measured_step_s", "decode_stall_s")


@pytest.fixture(scope="module")
def pkgs():
    jcfg = jconfigs.get_reduced("smollm-135m")
    tcfg = tconfigs.get_reduced("smollm-135m")
    jp = japi.get_model(jcfg).init(jax.random.key(0))
    tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    J = types.SimpleNamespace(
        name="jax", cfg=jcfg, params=jp, F=j_fabric, sim=j_sim,
        hw=j_hw, apelink=j_apelink, Torus=JTorus, cl=j_cluster,
        eng=j_engine, kw={})
    T = types.SimpleNamespace(
        name="torch", cfg=tcfg, params=tp, F=t_fabric, sim=t_sim,
        hw=t_hw, apelink=t_apelink, Torus=TTorus, cl=t_cluster,
        eng=t_engine, kw={"device": "cpu"})
    return J, T


def norm(x):
    if isinstance(x, (j_fabric.TrafficClass, t_fabric.TrafficClass)):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: norm(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items() if k not in WALL}
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def both(pkgs, fn, *args):
    out = []
    for P in pkgs:
        P.F.clear_route_cache()
        out.append(norm(fn(P, *args)))
    assert out[0] == out[1]
    return out[0]


def _cluster(P, **kw):
    kw.setdefault("torus", P.Torus((4,)))
    kw.setdefault("node_ranks", (0, 1))
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("page_tokens", 8)
    return P.cl.ServingCluster(P.cfg, P.params, **kw, **P.kw)


def _prompts(P, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, P.cfg.vocab, size=(n,)).astype(np.int32)
            for n in lens]


def _decode_alone(P, prompt, max_new):
    lm = P.eng.PagedLM(P.cfg, P.params, max_batch=2, max_seq=64,
                       page_tokens=8, **P.kw)
    eng = P.eng.Engine(lm)
    eng.submit(P.eng.Request(rid=0, prompt=prompt, max_new_tokens=max_new))
    eng.run_to_completion()
    return eng.finished[0].out_tokens


def _result(cl, **extra):
    return dict(tokens={r.rid: r.out_tokens for r in cl.finished},
                migrations=cl.migrations, stats=cl.stats(),
                n_params=cl.n_params, **extra)


def _slow_net(P):
    link = P.hw.ApenetLinkSpec("slow-test", lanes=1, lane_gbps=0.01,
                               encoding_efficiency=0.8)
    return P.apelink.NetModel(link=link)


_SLOW_SIM_KW = dict(credit_bytes=40e3, packet_bytes=256)


def test_n_params_equal_at_full_width():
    """``n_params`` feeds ``t_token_s`` and ``reprefill_stall_s``: the
    port's count (tied embeddings counted once) equals the JAX pytree's
    leaf count, for full-size qwen2-0.5b (tied) and olmoe (untied, MoE),
    built without memory (meta tensors; ``jax.eval_shape``)."""
    for name in ("qwen2-0.5b", "olmoe-1b-7b", "smollm-135m"):
        jcfg = jconfigs.get_config(name)
        shapes = jax.eval_shape(
            lambda: japi.get_model(jcfg).init(jax.random.key(0)))
        want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        model = TransformerLM(tconfigs.get_config(name), device="meta")
        assert t_cluster.count_params(model) == want, name


def test_router_places_least_loaded(pkgs):
    def run(P):
        cl = _cluster(P)
        for rid, p in enumerate(_prompts(P, 1, (6, 6, 6, 6))):
            cl.submit(P.eng.Request(rid=rid, prompt=p, max_new_tokens=3))
        where = P.cl.owners(cl, range(4))
        cl.run_to_completion()
        return _result(cl, where=where)
    out = both(pkgs, run)
    assert [out["where"][r] for r in range(4)] == [0, 1, 0, 1]


def _migrate_mid_decode(P):
    prompt = _prompts(P, 2, (9,))[0]
    baseline = _decode_alone(P, prompt, 8)
    cl = _cluster(P)
    cl.submit(P.eng.Request(rid=7, prompt=prompt, max_new_tokens=8))
    for _ in range(4):
        cl.step()
    rep = cl.migrate(7, 1)
    assert not cl.nodes[0].engine.running and not cl.nodes[0].lm.slot_pages
    cl.run_to_completion()
    assert cl.finished[0].out_tokens == baseline
    return _result(cl, baseline=baseline, rep=rep)


def test_migration_mid_decode_bitwise_identical(pkgs):
    out = both(pkgs, _migrate_mid_decode)
    assert out["stats"]["n_migrations"] == 1


def test_migration_through_link_fault_reroute(pkgs):
    def run(P):
        prompt = _prompts(P, 3, (11,))[0]
        baseline = _decode_alone(P, prompt, 7)
        cl = _cluster(P)
        cl.fail_link(0, 1)
        cl.submit(P.eng.Request(rid=0, prompt=prompt, max_new_tokens=7))
        for _ in range(3):
            cl.step()
        rep = cl.migrate(0, 1)
        cl.run_to_completion()
        assert cl.finished[0].out_tokens == baseline
        return _result(cl, rep=rep)
    out = both(pkgs, run)
    rep = out["rep"][1]
    assert rep["hops"] == 3 and rep["min_hops"] == 1
    assert out["stats"]["rerouted_migrations"] == 1


def test_migration_unroutable_when_fabric_partitioned(pkgs):
    def run(P):
        cl = _cluster(P, torus=P.Torus((2,)))
        cl.fail_link(0, 1)
        cl.submit(P.eng.Request(rid=0, prompt=_prompts(P, 4, (5,))[0],
                                max_new_tokens=4))
        for _ in range(2):
            cl.step()
        with pytest.raises(P.F.UnroutableError):
            cl.migrate(0, 1)
        with pytest.raises(P.F.UnroutableError):
            cl.rebalance(threshold=1)
        where = P.cl.owners(cl, [0])
        cl.run_to_completion()
        return _result(cl, where=where)
    out = both(pkgs, run)
    assert out["where"] == {0: 0} and len(out["tokens"]) == 1


def test_migration_rejected_when_destination_full(pkgs):
    def run(P):
        cl = _cluster(P, max_batch=1)
        for rid, p in enumerate(_prompts(P, 5, (6, 6))):
            cl.submit(P.eng.Request(rid=rid, prompt=p, max_new_tokens=6))
        cl.step()
        with pytest.raises(RuntimeError):
            cl.migrate(0, 1)
        where = P.cl.owners(cl, [0, 1])
        cl.run_to_completion()
        return _result(cl, where=where)
    out = both(pkgs, run)
    assert out["where"] == {0: 0, 1: 1} and len(out["tokens"]) == 2


def test_rebalance_moves_work_off_the_busiest_node(pkgs):
    def run(P):
        cl = _cluster(P, max_batch=3)
        for rid, p in enumerate(_prompts(P, 6, (6, 7, 8))):
            cl.nodes[0].engine.submit(
                P.eng.Request(rid=rid, prompt=p, max_new_tokens=6))
        for _ in range(2):
            cl.step()
        rep = cl.rebalance(threshold=2)
        loads = {r: n.load for r, n in cl.nodes.items()}
        again = cl.rebalance(threshold=2)
        cl.run_to_completion()
        return _result(cl, rep=rep, loads=loads, again=again)
    out = both(pkgs, run)
    assert out["rep"] is not None and out["again"] is None
    assert out["loads"] == {0: 2, 1: 1} and len(out["tokens"]) == 3


def test_striped_migration_bitwise_and_reported(pkgs):
    def run(P):
        prompt = _prompts(P, 7, (9,))[0]
        baseline = _decode_alone(P, prompt, 8)
        cl = _cluster(P, torus=P.Torus((4, 4)), node_ranks=(0, 5),
                      qos=P.F.QosPolicy())
        cl.submit(P.eng.Request(rid=0, prompt=prompt, max_new_tokens=8))
        for _ in range(4):
            cl.step()
        rep = cl.migrate(0, 5, route_policy="striped")
        cl.run_to_completion()
        assert cl.finished[0].out_tokens == baseline
        return _result(cl, rep=rep)
    out = both(pkgs, run)
    assert out["rep"][1]["stripes"] > 1


def test_qos_cluster_protects_decode_from_migration_bulk(pkgs):
    def run(P):
        prompt = _prompts(P, 8, (9,))[0]
        out = {}
        for name, qos in (("fifo", None), ("qos", P.F.QosPolicy())):
            cl = _cluster(P, tp_axes=None, net=_slow_net(P),
                          sim_kw=_SLOW_SIM_KW, qos=qos)
            cl.submit(P.eng.Request(rid=7, prompt=prompt, max_new_tokens=8))
            for _ in range(4):
                cl.step()
            cl.migrate(7, 1)
            cl.run_to_completion()
            out[name] = _result(cl)
        return out
    out = both(pkgs, run)
    tp = {k: v["stats"]["nodes"][0]["sim_tp_comm_s"] for k, v in out.items()}
    assert 0 < tp["qos"] < tp["fifo"]


def test_migration_contends_with_live_decode(pkgs):
    def run(P):
        prompt = _prompts(P, 9, (9,))[0]
        cl = _cluster(P, tp_axes=None, net=_slow_net(P),
                      sim_kw=_SLOW_SIM_KW)
        cl.submit(P.eng.Request(rid=7, prompt=prompt, max_new_tokens=8))
        for _ in range(4):
            cl.step()
        rep = cl.migrate(7, 1)
        cl.run_to_completion()
        return _result(cl, rep=rep)
    out = both(pkgs, run)
    rep = out["rep"][1]
    assert rep["modelled_s"] > rep["isolated_s"] * 1.01
    assert out["stats"]["nodes"][0]["sim_tp_comm_s"] > 0
    assert out["stats"]["nodes"][0]["sim_comm_steps"] > 0


def test_congestion_aware_migration_beats_hop_count(pkgs):
    def run(P):
        prompt = _prompts(P, 10, (9,))[0]
        out = {}
        for policy in ("congestion", "hops"):
            cl = _cluster(P, net=_slow_net(P), sim_kw=_SLOW_SIM_KW)
            cl.submit(P.eng.Request(rid=0, prompt=prompt, max_new_tokens=6))
            for _ in range(2):
                cl.step()
            cl.sim.inject(0, 1, 200_000)
            rep = cl.migrate(0, 1, route_policy=policy)
            cl.run_to_completion()
            out[policy] = _result(cl, rep=rep)
        return out
    out = both(pkgs, run)
    cong, hops = out["congestion"]["rep"][1], out["hops"]["rep"][1]
    assert hops["hops"] == 1 and cong["hops"] > 1
    assert cong["modelled_s"] < hops["modelled_s"]


def test_fail_link_relowers_decode_tp_twin(pkgs):
    def run(P):
        cl = _cluster(P, tp_axes=None)
        lm = cl.nodes[0].lm
        seen = [(lm.tp_schedule.max_hops, lm.predicted_tp_comm_s)]
        cl.fail_link(0, 1)
        seen.append((lm.tp_schedule.max_hops, lm.predicted_tp_comm_s))
        cl.clear_faults()
        seen.append((lm.tp_schedule.max_hops, lm.predicted_tp_comm_s))
        return seen
    seen = both(pkgs, run)
    assert [h for h, _ in seen] == [1, 3, 1]
    assert seen[1][1] > seen[0][1] == seen[2][1]


def test_telemetry_of_a_cluster_run(pkgs):
    """A hub attached to the cluster: the same counters and the same
    Perfetto bytes in both packages (and no change to the tokens)."""
    def run(P):
        hub = P.F.Telemetry()
        prompt = _prompts(P, 11, (9,))[0]
        cl = _cluster(P, tp_axes=None, telemetry=hub, qos=P.F.QosPolicy())
        cl.submit(P.eng.Request(rid=0, prompt=prompt, max_new_tokens=6))
        for _ in range(3):
            cl.step()
        cl.fail_link(0, 1)
        cl.migrate(0, 1)
        cl.run_to_completion()
        for k in P.sim.ROUTE_CACHE_STATS:   # process-wide tallies
            P.sim.ROUTE_CACHE_STATS[k] = 0
        hub.collect(cl.sim)
        return _result(cl, perfetto=hub.to_perfetto(),
                       counters=hub.counters_snapshot())
    out = both(pkgs, run)
    assert out["counters"]["cluster.migrations"] == 1.0


@pytest.mark.parametrize("fidelity,sim_kw", [
    ("fluid", None), ("hybrid", None),
    ("fluid", {"solver": "torch", "device": "cpu"})])
def test_fidelity_tiers_keep_the_tokens(pkgs, fidelity, sim_kw):
    """Timing never feeds sampling: on the fluid and hybrid tiers (and
    with the torch rate solver) the tokens are those of the packet tier;
    with the numpy solver the whole timeline equals the JAX package's."""
    def run(P, fidelity, sim_kw):
        kw = dict(sim_kw or {})
        if P.name == "jax" and kw.get("solver") == "torch":
            kw = {"solver": "jnp"}
        prompts = _prompts(P, 12, (9, 14, 6))
        cl = _cluster(P, tp_axes=None, fidelity=fidelity, sim_kw=kw,
                      qos=P.F.QosPolicy(), max_batch=3)
        for rid, p in enumerate(prompts):
            cl.submit(P.eng.Request(rid=rid, prompt=p, max_new_tokens=6))
        for _ in range(3):
            cl.step()
        rep = cl.migrate(0, 1, route_policy="striped")
        cl.run_to_completion()
        res = _result(cl, rep=rep)
        if kw.get("solver") in ("torch", "jnp"):
            # an fp32 solver: the timeline is close, not equal
            res = {"tokens": res["tokens"], "n_params": res["n_params"]}
        return res
    out = both(pkgs, run, fidelity, sim_kw)
    assert out["tokens"] == _packet_tokens(pkgs)


_PACKET: dict = {}


def _packet_tokens(pkgs):
    """The tokens of each prompt decoded alone (computed once)."""
    if not _PACKET:
        J, _ = pkgs
        for rid, p in enumerate(_prompts(J, 12, (9, 14, 6))):
            _PACKET[rid] = _decode_alone(J, p, 6)
    return _PACKET
