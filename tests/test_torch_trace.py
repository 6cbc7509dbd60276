"""Trace replay of the PyTorch port vs the JAX package's.

``generate_trace`` must give the same trace from the same seed, and
``replay(...).metrics()`` on modelled clusters must be EQUAL (``==``) to
the JAX package's: the shapes of ``tests/test_trace_replay.py`` (a 2x2
torus, reactive and proactive rebalancing, fluid and hybrid tiers, the
closed-loop QoS controller, background traffic) and the seeded 16-node
smoke of ``benchmarks/trace_replay.py`` (``TRACE_FAST=1``, 4x4 torus,
240 requests).  ``wall_s`` is the only field of ``ReplayReport`` allowed
to differ.  A modelled cluster holds no tensors, but the port's nodes
still name their device: ``device="cpu"`` here.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import fabric as j_fabric  # noqa: E402
from repro.core.topology import Torus as JTorus  # noqa: E402
from repro.serving import cluster as j_cluster  # noqa: E402
from repro.serving import engine as j_engine  # noqa: E402
from repro.serving import trace as j_trace  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import fabric as t_fabric  # noqa: E402
from repro_torch.core.topology import Torus as TTorus  # noqa: E402
from repro_torch.serving import cluster as t_cluster  # noqa: E402
from repro_torch.serving import engine as t_engine  # noqa: E402
from repro_torch.serving import trace as t_trace  # noqa: E402

torch.set_num_threads(1)

N_PARAMS = 7.0e9
T_TOK_S = 2.0 * N_PARAMS / 1.6e12

JAX = types.SimpleNamespace(
    cfg=jconfigs.get_config("deepseek-7b"), F=j_fabric, Torus=JTorus,
    cl=j_cluster, eng=j_engine, tr=j_trace, kw={})
TORCH = types.SimpleNamespace(
    cfg=tconfigs.get_config("deepseek-7b"), F=t_fabric, Torus=TTorus,
    cl=t_cluster, eng=t_engine, tr=t_trace, kw={"device": "cpu"})


def both(fn, *args, **kw):
    out = []
    for P in (JAX, TORCH):
        P.F.clear_route_cache()
        out.append(fn(P, *args, **kw))
    assert out[0] == out[1]
    return out[0]


def _cluster(P, **kw):
    kw.setdefault("torus", P.Torus((4,)))
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 96)
    kw.setdefault("page_tokens", 8)
    kw.setdefault("tp_axes", ())
    kw.setdefault("fidelity", "fluid")
    return P.cl.ServingCluster(P.cfg, None, modelled=True,
                               n_params=N_PARAMS, **kw, **P.kw)


def _small_cluster(P, fidelity="fluid", qos=None):
    return _cluster(P, torus=P.Torus((2, 2)), max_batch=4, max_seq=576,
                    page_tokens=16, chunked_prefill=True,
                    fidelity=fidelity, qos=qos,
                    slo=P.cl.SloPolicy(token_target_s=0.066, queue_limit=64,
                                       max_queue_wait_s=2.0))


def _small_trace(P, n=48, seed=3, util=0.9, n_nodes=4):
    rate = util * n_nodes / (T_TOK_S * 50.8)
    return P.tr.generate_trace(P.tr.TraceConfig(
        n_requests=n, seed=seed, base_rate=rate,
        diurnal_period_s=n / (2 * rate)))


def _report(rep):
    d = dataclasses.asdict(rep)
    d.pop("wall_s")
    return {"metrics": rep.metrics(), "report": d}


@pytest.mark.parametrize("seed,n", [(42, 300), (5, 400), (1, 100)])
def test_generate_trace_equal(seed, n):
    both(lambda P: [dataclasses.astuple(r) for r in P.tr.generate_trace(
        P.tr.TraceConfig(n_requests=n, seed=seed))])


@pytest.mark.parametrize("fidelity", ["fluid", "hybrid"])
@pytest.mark.parametrize("mode", ["proactive", "reactive"])
def test_replay_metrics_equal(fidelity, mode):
    def run(P):
        cl = _small_cluster(P, fidelity)
        out = _report(P.tr.replay(cl, _small_trace(P, n=48, seed=9),
                                  rebalance=mode))
        out["stamps"] = [(r.rid, r.arrival_s, r.first_token_s, r.finish_s)
                         for r in cl.finished]
        return out
    out = both(run)
    assert out["metrics"]["n_finished"] == 48


def test_replay_with_controller_and_background():
    """The closed-loop QoS controller under a tight SLO and a background
    BULK callback: the controller's history and the metrics equal."""
    def run(P):
        base = P.F.QosPolicy()
        cl = _small_cluster(P, qos=base)
        cl.slo = dataclasses.replace(cl.slo, token_target_s=1e-5)
        ctl = P.F.QosController(base, cl.slo)

        def background(cluster, t):
            cluster.sim.inject(0, 1, 1 << 20, cls=P.F.TrafficClass.BULK)

        rep = P.tr.replay(cl, _small_trace(P, n=24, seed=5),
                          rebalance="proactive", qos_ctl=ctl,
                          background=background)
        return {"report": _report(rep),
                "history": [(b, p, x) for b, p, x in ctl.history],
                "retunes": ctl.n_retunes,
                "weights": {c.name: w for c, w in cl.sim.qos.weights.items()}}
    out = both(run)
    assert out["retunes"] >= 1


def test_replay_telemetry_export_equal():
    def run(P):
        hub = P.F.Telemetry()
        cl = _small_cluster(P, qos=P.F.QosPolicy())
        rep = P.tr.replay(cl, _small_trace(P, n=24, seed=4),
                          rebalance="proactive", telemetry=hub)
        return {"report": _report(rep), "perfetto": hub.to_perfetto()}
    both(run)


def test_trace_fast_16_node_smoke():
    """``benchmarks/trace_replay.py``'s seeded 16-node smoke: 240
    requests at utilisation 0.92 on a 4x4 torus, both rebalancers."""
    def run(P):
        rate = 0.92 * 16 / (T_TOK_S * 50.8)
        tr = P.tr.generate_trace(P.tr.TraceConfig(
            n_requests=240, seed=11, base_rate=rate,
            diurnal_period_s=240 / (2 * rate), burst_size=16.0,
            burst_rate=0.3))
        out = {}
        for mode in ("reactive", "proactive"):
            cl = _cluster(P, torus=P.Torus((4, 4)), max_batch=4,
                          max_seq=576, page_tokens=16, chunked_prefill=True,
                          slo=P.cl.SloPolicy(token_target_s=0.066,
                                             queue_limit=48,
                                             max_queue_wait_s=1.0))
            out[mode] = _report(P.tr.replay(cl, tr, rebalance=mode))
        return out
    out = both(run)
    assert out["proactive"]["metrics"]["n_migrations"] > 0


def test_cluster_modelled_truncation_and_proactive():
    """Modelled-cluster paths of ``test_trace_replay.py``: truncation
    raises, the proactive rebalancer moves before a predicted breach."""
    def run(P):
        cl = _cluster(P, node_ranks=(0, 1),
                      slo=P.cl.SloPolicy(token_target_s=0.012, headroom=0.8))
        for rid in (0, 1):
            cl.nodes[0].engine.submit(P.eng.Request(
                rid=rid, prompt=[0] * 8, max_new_tokens=30))
        cl.step()
        cl.step()
        moves = cl.rebalance_proactive()
        with pytest.raises(P.eng.TruncatedRunError):
            cl.run_to_completion(max_steps=2)
        cl.run_to_completion(max_steps=2000)
        return {"moves": [dataclasses.asdict(m) for m in moves],
                "stats": {k: v for k, v in cl.stats().items()
                          if k != "nodes"},
                "slo": {k: v for k, v in cl.slo_stats().items()},
                "finish": [(r.rid, r.first_token_s, r.finish_s)
                           for r in cl.finished]}
    out = both(run)
    assert len(out["moves"]) == 1
