"""Fabric simulators of the PyTorch port vs the JAX package's.

The packet, fluid and hybrid tiers, telemetry, the QoS controller, the
RDMA endpoint's shared-timeline PUT/GET and ``estimate(backend="sim")``
are host float64 arithmetic in both packages: the same seeded workload
must give EQUAL (``==``) finish times, ``FlowResult``s, ``link_stats``,
``class_stats``, counters and Perfetto bytes.  Each scenario runs once
per package through the same code, with both packages' route caches
cleared first.  The one inexact part is the dense rate solver:
``solver="torch"`` (on the CPU here) against the JAX package's
``solver="jnp"`` within rtol 1e-4, against ``"np"`` within 5e-4.

Workload shapes: the small meshes of ``benchmarks/simscale.py``
(``_MESHES``) and the contention shapes of ``benchmarks/contention.py``
(shared-link sweep, migrate under a chained decode stream, a bulk
transfer on the direct link of a 4x4x4 torus), at sizes that keep the
packet oracle quick.
"""
import dataclasses
import enum
import json
import random
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import apelink as j_apelink  # noqa: E402
from repro.core import fabric as j_fabric  # noqa: E402
from repro.core import hw as j_hw  # noqa: E402
from repro.core.fabric import autotune as j_autotune  # noqa: E402
from repro.core.fabric import fluid as j_fluid  # noqa: E402
from repro.core.fabric import sim as j_sim  # noqa: E402
from repro.core.rdma import RdmaEndpoint as JEndpoint  # noqa: E402
from repro.core.topology import Torus as JTorus  # noqa: E402
from repro_torch.core import apelink as t_apelink  # noqa: E402
from repro_torch.core import fabric as t_fabric  # noqa: E402
from repro_torch.core import hw as t_hw  # noqa: E402
from repro_torch.core.fabric import autotune as t_autotune  # noqa: E402
from repro_torch.core.fabric import fluid as t_fluid  # noqa: E402
from repro_torch.core.fabric import sim as t_sim  # noqa: E402
from repro_torch.core.rdma import RdmaEndpoint as TEndpoint  # noqa: E402
from repro_torch.core.topology import Torus as TTorus  # noqa: E402

torch.set_num_threads(1)

JAX = types.SimpleNamespace(
    name="jax", F=j_fabric, sim=j_sim, fluid=j_fluid, apelink=j_apelink,
    hw=j_hw, autotune=j_autotune, Torus=JTorus, Endpoint=JEndpoint)
TORCH = types.SimpleNamespace(
    name="torch", F=t_fabric, sim=t_sim, fluid=t_fluid, apelink=t_apelink,
    hw=t_hw, autotune=t_autotune, Torus=TTorus, Endpoint=TEndpoint)

TIERS = ("packet", "fluid", "hybrid")
MESHES = [(8,), (2, 4), (2, 2, 2), (4, 4), (2, 2, 4)]   # simscale._MESHES


def fresh(P):
    """Both packages keep module-level route caches and tallies (and the
    JAX package a cache of compiled solvers): clear them so each run
    starts from the same state."""
    P.F.clear_route_cache()
    getattr(P.fluid, "_JNP_CACHE", {}).clear()
    for k in P.sim.ROUTE_CACHE_STATS:
        P.sim.ROUTE_CACHE_STATS[k] = 0


def norm(x):
    """Package-neutral plain data: enums by name, dataclasses as dicts."""
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: norm(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def both(fn, *args, **kw):
    """Run ``fn`` once per package; assert the outputs are equal."""
    out = []
    for P in (JAX, TORCH):
        fresh(P)
        out.append(norm(fn(P, *args, **kw)))
    assert out[0] == out[1]
    return out[0]


def timeline(sim, fids):
    return {"finish": [sim.finish_s(f) for f in fids],
            "flows": [sim.flow(f) for f in fids],
            "link_stats": sim.link_stats(),
            "class_stats": sim.class_stats(),
            "now": sim.now}


def _soup(P, tier, dims, seed, *, qos, fault, n=20):
    torus = P.Torus(dims)
    rnd = random.Random(seed)
    faults = None
    if fault:
        a = rnd.randrange(torus.size)
        b = torus.neighbors(a)[0]
        faults = P.F.FaultMap.normalized((), {(a, b)})
    sim = P.F.make_sim(torus, fidelity=tier,
                       qos=P.F.QosPolicy() if qos else None, faults=faults)
    classes = list(P.F.TrafficClass)
    fids = []
    for i in range(n):
        src = rnd.randrange(torus.size)
        dst = rnd.randrange(torus.size - 1)
        dst += dst >= src
        after = tuple(rnd.sample(fids, 1)) if fids and rnd.random() < 0.3 \
            else ()
        fids.append(sim.inject(src, dst, rnd.randint(16 << 10, 512 << 10),
                               cls=rnd.choice(classes),
                               start_s=rnd.randint(0, 3) * 20e-6,
                               after=after, label=f"f{i}"))
        if rnd.random() < 0.2:
            fids.append(sim.occupy(("hostif", src), 5e-6, after=(fids[-1],),
                                   cls=rnd.choice(classes)))
    sim.run()
    out = timeline(sim, fids)
    out["escalation"] = getattr(sim, "last_escalation", None)
    return out


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("dims", MESHES)
def test_seeded_soup_equals_reference(tier, dims):
    """Random multi-class flows with dependencies, host-IF occupancies,
    QoS arbitration and a dead link: every number equal."""
    seed = sum(dims) * 7 + len(dims)
    both(_soup, tier, dims, seed, qos=True, fault=len(dims) > 1)


@pytest.mark.parametrize("tier", TIERS)
def test_fifo_soup_equals_reference(tier):
    both(_soup, tier, (4, 4), 11, qos=False, fault=False, n=30)


def _shared_link_sweep(P, tier):
    """``benchmarks/contention.py``: k flows through link (0, 1) of an
    8-ring, and the same k on disjoint links."""
    ring = P.Torus((8,))
    out = []
    for k in (1, 2, 3, 4):
        sim = P.F.make_sim(ring, fidelity=tier)
        fids = [sim.inject(0, d, 1 << 20) for d in range(1, k + 1)]
        sim2 = P.F.make_sim(ring, fidelity=tier)
        fids2 = [sim2.inject(2 * i, 2 * i + 1, 1 << 20) for i in range(k)]
        out.append((timeline(sim, fids), timeline(sim2, fids2)))
    return out


@pytest.mark.parametrize("tier", TIERS)
def test_contention_shared_link_sweep(tier):
    both(_shared_link_sweep, tier)


def _decode_traffic(P, sim, torus, steps):
    tp = P.F.lower_all_reduce(torus, ("x",))
    fids, tail = [], []
    for _ in range(steps):
        tail = P.F.inject_schedule(sim, tp, 32 * 4096 * 2 * 4, start_s=0.0,
                                   after=tuple(tail), granularity="phase",
                                   cls=P.F.TrafficClass.DECODE)
        fids.extend(tail)
    return fids


def _migration_contention(P, tier, qos, descriptor_bytes):
    """``benchmarks/contention.py``'s migrate-under-decode: the exact
    ``put_pages`` call the cluster makes, against a chained decode
    stream on a 4-ring (scaled down)."""
    torus = P.Torus((4,))
    page = 16 * 2 * 4 * 2 * 64 * 2
    sim = P.F.make_sim(torus, fidelity=tier, packet_bytes=16384,
                       qos=P.F.QosPolicy() if qos else None)
    dec = _decode_traffic(P, sim, torus, 6)
    ep = P.Endpoint(torus, 0, sim=sim, descriptor_bytes=descriptor_bytes)
    dst = P.Endpoint(torus, 2, sim=sim)
    reg, dreg = ep.register(24 * page), dst.register(24 * page)
    t = ep.put_pages(2, reg, list(range(24)), page_nbytes=page,
                     dst_endpoint=dst, dst_region=dreg,
                     dst_pages=list(range(24)))
    g = dst.get_time(0, 3 * page, dreg)
    return {"put": t, "get": g, "report": ep.last_put_report,
            "timeline": timeline(sim, dec)}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("qos,descriptor_bytes",
                         [(False, None), (True, None), (True, 32768)])
def test_migration_under_decode_stream(tier, qos, descriptor_bytes):
    both(_migration_contention, tier, qos, descriptor_bytes)


def _striped_put(P, tier, restripe_s):
    """A striped PUT (``fabric.striped_routes`` + ``stripe_counts``, the
    cluster's page split) under BULK background traffic, re-striped
    mid-flight when ``restripe_s`` is set."""
    torus = P.Torus((4, 4))
    sim = P.F.make_sim(torus, fidelity=tier, qos=P.F.QosPolicy())
    bg = [sim.inject(0, 1, 2 << 20, cls=P.F.TrafficClass.BULK),
          sim.inject(4, 5, 1 << 20, cls=P.F.TrafficClass.DECODE)]
    page = 65536
    plan = P.F.striped_routes(sim, 0, 5, 32 * page, k=3)
    counts = P.F.stripe_counts(plan, 32)
    stripes = [(P.F.lower_route(torus, r), c * page)
               for (r, _), c in zip(plan, counts) if c > 0]
    ep = P.Endpoint(torus, 0, sim=sim)
    dst = P.Endpoint(torus, 5, sim=sim)
    reg, dreg = ep.register(32 * page), dst.register(32 * page)
    t = ep.put_pages(5, reg, list(range(32)), page_nbytes=page,
                     dst_endpoint=dst, dst_region=dreg, stripes=stripes,
                     restripe_s=restripe_s)
    return {"put": t, "report": ep.last_put_report, "plan": plan,
            "counts": counts, "timeline": timeline(sim, bg)}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("restripe_s", [None, 2e-4])
def test_striped_put_and_midflight_restripe(tier, restripe_s):
    out = both(_striped_put, tier, restripe_s)
    assert out["report"]["stripes"] > 1


def _congestion_routing(P, tier):
    """A bulk transfer hammering the direct link of a 4x4x4 torus: the
    direct probe, ``best_route``, ``candidate_routes`` and
    ``striped_routes``/``stripe_counts`` against it."""
    torus = P.Torus((4, 4, 4))
    nbr = torus.rank((1, 0, 0))
    sim = P.F.make_sim(torus, fidelity=tier, packet_bytes=40960)
    bg = sim.inject(0, nbr, 4 << 20)
    direct = tuple(torus.route(0, nbr))
    t_direct = sim.probe_route(direct, 256 << 10)
    report = dict(sim.last_probe_report or {})
    route, t_best = P.F.best_route(sim, 0, nbr, 256 << 10)
    plan = P.F.striped_routes(sim, 0, nbr, 256 << 10, k=3)
    counts = P.F.stripe_counts(plan, 16)
    cands = P.F.candidate_routes(torus, 0, nbr)
    return {"direct": t_direct, "probe_report": report, "best": (route,
            t_best), "plan": plan, "counts": counts, "cands": cands,
            "timeline": timeline(sim, [bg])}


@pytest.mark.parametrize("tier", TIERS)
def test_congestion_routing_probe_and_stripes(tier):
    both(_congestion_routing, tier)


def _checkpoints(P, tier):
    """``run_until`` checkpoints, a mid-flight ``restripe``, a probe on
    the live timeline and ``prune`` — then the rest of the run."""
    torus = P.Torus((8,))
    sim = P.F.make_sim(torus, fidelity=tier, qos=P.F.QosPolicy())
    B = P.F.TrafficClass.BULK
    fwd, bwd = (0, 1, 2, 3), (0, 7, 6, 5, 4, 3)
    fid = sim.inject(0, 3, 4 << 20, route=fwd, cls=B)
    others = [sim.inject(s, (s + 3) % 8, 1 << 20,
                         cls=P.F.TrafficClass.DECODE, start_s=s * 10e-6)
              for s in range(1, 6)]
    sim.run_until(2e-4)
    unsent = sim.unsent_bytes(fid)
    legs = sim.restripe(fid, [(fwd, 0.6), (bwd, 0.4)])
    t_probe = sim.probe_route(bwd, 1 << 20, cls=B)
    sim.run_until(6e-4)
    pruned = sim.prune()
    sim.run()
    return {"unsent": unsent, "legs": legs, "probe": t_probe,
            "pruned": pruned,
            "finish": [sim.finish_s(f) for f in legs + others],
            "link_stats": sim.link_stats(),
            "class_stats": sim.class_stats()}


@pytest.mark.parametrize("tier", TIERS)
def test_run_until_restripe_probe_prune(tier):
    both(_checkpoints, tier)


KINDS = ("AR", "AG", "RS", "A2A", "HALO", "P2P")


def _schedule(P, kind, dims):
    torus = P.Torus(dims)
    if kind == "P2P":
        return P.F.lower_p2p(torus, 0, torus.size - 1)
    axes = (0,) if kind in ("A2A", "HALO") else tuple(range(len(dims)))
    return P.F.lower(getattr(P.F, kind), torus, axes)


def _inject_schedule(P, tier, kind, granularity):
    dims = (2, 4)
    sched = _schedule(P, kind, dims)
    sim = P.F.make_sim(P.Torus(dims), fidelity=tier, qos=P.F.QosPolicy())
    bg = sim.inject(0, 1, 512 << 10, cls=P.F.TrafficClass.BULK)
    tail = P.F.inject_schedule(sim, sched, 256 << 10, start_s=0.0,
                               granularity=granularity, after=(bg,),
                               cls=P.F.TrafficClass.COLLECTIVE)
    return timeline(sim, [bg] + tail)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("granularity", ["round", "phase"])
def test_inject_schedule_every_kind(tier, kind, granularity):
    both(_inject_schedule, tier, kind, granularity)


def _estimate(P, fidelity, kind, dims):
    sched = _schedule(P, kind, dims)
    out = []
    for nbytes in (4096, 1 << 20):
        out.append(P.F.estimate(sched, nbytes, backend="sim",
                                fidelity=fidelity))
        out.append(P.F.estimate(sched, nbytes, backend="sim",
                                fidelity=fidelity, qos=P.F.QosPolicy(),
                                cls=P.F.TrafficClass.DECODE))
    return out


@pytest.mark.parametrize("fidelity", TIERS)
@pytest.mark.parametrize("kind", KINDS)
def test_cost_estimate_sim_backend(fidelity, kind):
    both(_estimate, fidelity, kind, (2, 2, 2))


def test_cost_estimate_sim_backend_under_faults():
    def run(P):
        torus = P.Torus((4, 4))
        sched = P.F.rewrite(P.F.lower_all_reduce(torus, (0, 1)),
                            P.F.FaultMap.normalized((), {(0, 1)}))
        return [P.F.estimate(sched, 1 << 20, backend="sim",
                             fidelity=f) for f in TIERS]
    both(run)


def _telemetry(P, tier):
    hub = P.F.Telemetry()
    torus = P.Torus((4, 4))
    sim = P.F.make_sim(torus, fidelity=tier, qos=P.F.QosPolicy(),
                       telemetry=hub)
    rnd = random.Random(5)
    fids = [sim.inject(rnd.randrange(8), 8 + rnd.randrange(8),
                       rnd.randint(64 << 10, 1 << 20),
                       cls=rnd.choice(list(P.F.TrafficClass)))
            for _ in range(12)]
    ep = P.Endpoint(torus, 0, sim=sim, telemetry=hub)
    reg = ep.register(8 * 65536)
    ep.put_pages(5, reg, list(range(8)), page_nbytes=65536)
    sim.run()
    hub.collect(sim)
    trace = hub.to_perfetto()
    assert not P.F.validate_perfetto(json.loads(trace))
    return {"perfetto": trace, "counters": hub.counters_snapshot(),
            "cross_check": hub.cross_check(sim),
            "timeline": timeline(sim, fids)}


@pytest.mark.parametrize("tier", TIERS)
def test_telemetry_perfetto_export_equal(tier):
    out = both(_telemetry, tier)
    assert out["cross_check"] == 0.0


class _Slo:
    token_target_s = 0.050
    headroom = 0.8


def _controller(P, tier):
    """A ``QosController`` closing its loop on a live sim: per window
    decode and bulk traffic enter the timeline, a synthetic per-token
    latency series walks the bands, the controller retunes the sim."""
    torus = P.Torus((4,))
    sim = P.F.make_sim(torus, fidelity=tier, qos=P.F.QosPolicy())
    ctl = P.F.QosController(P.F.QosPolicy(), _Slo(),
                            policy=P.F.QosCtlPolicy())
    lat = [0.01, 0.045, 0.046, 0.047, 0.06, 0.02, None, 0.045, 0.01]
    rnd = random.Random(9)
    fids = []
    for w, p in enumerate(lat):
        t0 = sim.now
        fids.append(sim.inject(0, 2, 256 << 10, start_s=t0,
                               cls=P.F.TrafficClass.BULK))
        fids.append(sim.inject(1, 3, 64 << 10, start_s=t0,
                               cls=P.F.TrafficClass.DECODE))
        sim.run()
        samples = [] if p is None else [p * (0.9 + 0.2 * rnd.random())
                                        for _ in range(5)]
        ctl.window(sim, samples)
    return {"history": ctl.history, "boost": ctl.boost,
            "retunes": ctl.n_retunes, "retuned": ctl.retuned(),
            "timeline": timeline(sim, fids)}


@pytest.mark.parametrize("tier", TIERS)
def test_qos_controller_trajectory(tier):
    out = both(_controller, tier)
    assert out["retunes"] >= 1


def test_pinned_config_reader(tmp_path, monkeypatch):
    """A ``best_configs.json`` (the JAX search's artifact) reads the same
    through both packages' readers, and ``QosCtlPolicy.tuned`` with it."""
    cfg = j_autotune.FabricConfig(
        torus_dims=(4, 4), qos_single=False, qos_weights=(2.0, 12.0, 6.0,
                                                          1.5),
        stripe_k=2, route_policy="striped", ctl_gain=1.3)
    path = tmp_path / "best_configs.json"
    j_autotune.save_best_configs({"serving": {"config": cfg.to_jsonable()}},
                                 path=str(path))
    monkeypatch.setenv("BEST_CONFIGS", str(path))

    def read(P):
        c = P.autotune.tuned_config("serving")
        return {"cfg": c, "qos": c.qos(), "json": c.to_jsonable(),
                "rt": P.autotune.FabricConfig.from_jsonable(c.to_jsonable()),
                "knob": P.autotune.tuned_knob("serving", "stripe_k"),
                "missing": P.autotune.tuned_knob("train", "bucket_mb", 4.0),
                "ctl": P.F.QosCtlPolicy.tuned()}
    out = both(read)
    assert out["knob"] == 2 and out["missing"] == 4.0
    monkeypatch.setenv("BEST_CONFIGS", "0")
    assert t_autotune.tuned_config("serving") is None
    assert t_autotune.load_best_configs() == {}


# ---------------------------------------------------------------------------
# the dense rate solver: solver="torch" against "jnp" and "np"
# ---------------------------------------------------------------------------

def _rand_flows(rnd, n_nodes, n):
    flows = []
    for _ in range(n):
        src = rnd.randrange(n_nodes)
        dst = rnd.randrange(n_nodes - 1)
        dst += dst >= src
        flows.append((src, dst, rnd.randint(64 << 10, 2 << 20),
                      rnd.choice(list(TrafficClass_names)),
                      rnd.randint(0, 3) * 50e-6))
    return flows


TrafficClass_names = [c.name for c in t_fabric.TrafficClass]


def _fluid_finishes(P, dims, flows, fidelity="fluid", **kw):
    sim = P.F.make_sim(P.Torus(dims), fidelity=fidelity,
                       qos=P.F.QosPolicy(), **kw)
    fids = [sim.inject(s, d, nb, cls=P.F.TrafficClass[c], start_s=st)
            for s, d, nb, c, st in flows]
    sim.run()
    return np.array([sim.finish_s(f) for f in fids]), sim


@pytest.mark.parametrize("dims,n", [((4, 4), 12), ((2, 2, 4), 40),
                                    ((4, 4, 4), 120)])
def test_torch_solver_matches_jnp_and_np(dims, n):
    """Above 64 active flows the default schedule re-solves lazily, and a
    last-bit difference in the rates can then change the schedule itself
    (``test_lazy_schedule_is_discontinuous_in_the_rates``): the finish
    times are compared with every drain re-solving."""
    flows = _rand_flows(random.Random(n), int(np.prod(dims)), n)
    kw = {"exact_below": 10 ** 9}
    fresh(TORCH)
    t, tsim = _fluid_finishes(TORCH, dims, flows, solver="torch",
                              device="cpu", **kw)
    fresh(TORCH)
    t_np, _ = _fluid_finishes(TORCH, dims, flows, **kw)
    fresh(JAX)
    j_jnp, jsim = _fluid_finishes(JAX, dims, flows, solver="jnp", **kw)
    fresh(JAX)
    j_np, _ = _fluid_finishes(JAX, dims, flows, **kw)
    assert np.array_equal(t_np, j_np)          # the numpy solver: bitwise
    np.testing.assert_allclose(t, j_jnp, rtol=1e-4)
    np.testing.assert_allclose(t, t_np, rtol=5e-4)
    assert tsim.n_solves == jsim.n_solves
    # byte accounting does not depend on the rates: exact per class
    assert norm(tsim.class_stats()) == norm(jsim.class_stats())


def test_lazy_schedule_is_discontinuous_in_the_rates(monkeypatch):
    """A property of the reference schedule, which the port keeps: above
    ``exact_below`` active flows a drain re-solves only once
    ``resolve_frac`` of the set has drained, so the numpy solver's own
    rates scaled by 1 + 1e-7 move some finish times by far more than the
    solvers' 5e-4 bar (1.2 % here; most seeded workloads do not show it).
    The JAX package's jnp solver against its numpy solver shows the same
    on this workload; with every drain re-solving the perturbation stays
    at its own size."""
    dims, n = (8, 8, 8), 400
    rnd = random.Random(n)             # the card test's workload
    flows = []
    for _ in range(n):
        src = rnd.randrange(512)
        dst = rnd.randrange(511)
        dst += dst >= src
        flows.append((src, dst, rnd.randint(64 << 10, 2 << 20),
                      rnd.choice(TrafficClass_names),
                      rnd.randint(0, 4) * 200e-6))
    out = {}
    for exact in (False, True):
        kw = {"exact_below": 10 ** 9} if exact else {}
        fresh(TORCH)
        base, _ = _fluid_finishes(TORCH, dims, flows, **kw)
        rates = t_fluid.FluidSim._rates_np
        monkeypatch.setattr(t_fluid.FluidSim, "_rates_np",
                            lambda self, act: rates(self, act) * (1 + 1e-7))
        fresh(TORCH)
        pert, _ = _fluid_finishes(TORCH, dims, flows, **kw)
        monkeypatch.setattr(t_fluid.FluidSim, "_rates_np", rates)
        out[exact] = float(np.max(np.abs(pert - base) / base))
    fresh(JAX)
    j_np, _ = _fluid_finishes(JAX, dims, flows)
    fresh(JAX)
    j_jnp, _ = _fluid_finishes(JAX, dims, flows, solver="jnp")
    assert out[True] <= 1e-6
    assert out[False] > 5e-4
    assert float(np.max(np.abs(j_jnp - j_np) / j_np)) > 5e-4


def test_torch_solver_follows_jnp_where_the_thresholds_part():
    """The largest solve of ``benchmarks/simscale.py``'s 512-node workload
    (8x8x8, 2000 flows, seed 0; 1827 active flows): the dense waterfill
    saturates a link at 1e-6 of its rate, the numpy solver at 1e-9, and
    there the two allocations part by a third for one flow (a property of
    the reference's jnp solver, ROADMAP §3).  The torch solver follows the
    jnp one (rtol 1e-4).  Both dense solvers read the same active set:
    ``_rates_jnp`` only reads attributes both packages' sims carry."""
    import heapq

    rng = random.Random(0)
    flows = []
    for _ in range(2000):
        src = rng.randrange(512)
        dst = rng.randrange(512)
        while dst == src:
            dst = rng.randrange(512)
        flows.append((src, dst, rng.randint(64 * 1024, 2 * 1024 * 1024),
                      rng.choice(list(t_fabric.TrafficClass)),
                      rng.randint(0, 4) * 200e-6))
    fresh(TORCH)
    sim = t_fabric.make_sim(TTorus((8, 8, 8)), fidelity="fluid",
                            qos=t_fabric.QosPolicy())
    for src, dst, nb, cls, start in flows:
        sim.inject(src, dst, nb, cls=cls, start_s=start)
    grabbed = []
    rates_np = t_fluid.FluidSim._rates_np

    def grab(self, act):
        if len(act) >= 1800 and not grabbed:
            grabbed.append(list(act))
        return rates_np(self, act)

    t_fluid.FluidSim._rates_np = grab
    try:
        while sim._heap and not grabbed:
            sim._step(heapq.heappop(sim._heap))
    finally:
        t_fluid.FluidSim._rates_np = rates_np
    act = grabbed[0]
    want_np = rates_np(sim, act)
    sim.device = "cpu"
    got = t_fluid.FluidSim._rates_torch(sim, act)
    fresh(JAX)
    want_jnp = j_fluid.FluidSim._rates_jnp(sim, act)
    np.testing.assert_allclose(got, want_jnp, rtol=1e-4)
    assert float(np.max(np.abs(want_jnp - want_np) / want_np)) > 0.1


def test_torch_solver_on_the_hybrid_tier():
    flows = _rand_flows(random.Random(3), 16, 24)
    fresh(TORCH)
    t, tsim = _fluid_finishes(TORCH, (4, 4), flows, fidelity="hybrid",
                              solver="torch", device="cpu")
    fresh(JAX)
    j, jsim = _fluid_finishes(JAX, (4, 4), flows, fidelity="hybrid",
                              solver="jnp")
    np.testing.assert_allclose(t, j, rtol=1e-4)
    assert tsim.last_escalation == jsim.last_escalation


def test_torch_solver_matches_the_reference_waterfill_per_solve():
    """One solve of each dense waterfill on the same padded inputs.  The
    JAX package caches its compiled solver by shape alone, with the link
    rate of the first call baked in, so its cache is cleared first."""
    fresh(JAX)
    rnd = np.random.default_rng(0)
    L, Fl, C = 64, 64, 4
    inc = (rnd.random((L, Fl)) < 0.1).astype(np.float32)
    wf = rnd.choice([4096.0, 1024.0, 256.0], Fl).astype(np.float32)
    onehot = np.eye(C, dtype=np.float32)[rnd.integers(0, C, Fl)]
    cap = np.full(Fl, 3.4e38, np.float32)
    cap[:5] = 1e8
    alive = np.ones(Fl, np.float32)
    alive[-7:] = 0.0
    onehot[-7:] = 0.0
    wc = np.array([4.0, 16.0, 8.0, 1.0], np.float32)
    B = 2.2e9
    j_rate, j_resid = j_fluid._jnp_waterfill(inc, wf, onehot, cap, alive,
                                             wc, B, 64)
    t_rate, t_resid = t_fluid._torch_waterfill(inc, wf, onehot, cap, alive,
                                               wc, B, 64, "cpu")
    np.testing.assert_allclose(t_rate, np.asarray(j_rate), rtol=1e-5)
    np.testing.assert_allclose(t_resid, np.asarray(j_resid), rtol=1e-5,
                               atol=B * 1e-6)


def test_torch_solver_needs_a_device():
    with pytest.raises(ValueError, match="solver"):
        t_fluid.FluidSim(TTorus((4,)), solver="jnp")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is then valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_fluid.FluidSim(TTorus((4,)), solver="torch")
    assert t_fluid.FluidSim(TTorus((4,)), solver="torch",
                            device="cpu").device == "cpu"
