"""The port's fabric autotuner (``repro_torch.core.fabric.autotune``).

Every case of ``tests/test_autotune.py`` on the port (the typed
ConfigSpace, the gym-style env contract, seeded search determinism, the
fluid / packet agreement, the ``best_configs.json`` load paths of
``TrainerConfig`` and ``ServingCluster``), then parity with the JAX
package: the same ``random.Random`` seed gives the same sampled, mutated,
crossed and encoded configs, the same ``FabricEnv.score`` floats on both
replays and tiers, the same search trajectories for each agent, the same
finalists and packet re-scores, and ``save_best_configs`` writes the same
bytes.  The simulators under both are bit-identical (``test_torch_sim``),
so every comparison is ``==``.

conftest pins ``BEST_CONFIGS=0``; the artifact tests opt back in through
a tmp file.
"""
import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import fabric as j_fabric  # noqa: E402
from repro.core.fabric import autotune as J  # noqa: E402
from repro_torch.core import fabric as t_fabric  # noqa: E402
from repro_torch.core.fabric import autotune  # noqa: E402
from repro_torch.core.fabric.autotune import (  # noqa: E402
    AGENTS, ConfigSpace, FabricConfig, FabricEnv, GeneticAgent,
    RandomWalkAgent, finalists, rescore, search, serving_replay,
    torus_shapes, training_replay)

N = 16


@pytest.fixture
def space():
    return ConfigSpace(N)


@pytest.fixture(autouse=True)
def _fresh_route_caches():
    """Both packages' route caches empty around every test, so no
    congestion probe reads another test's routes."""
    j_fabric.clear_route_cache()
    t_fabric.clear_route_cache()
    yield
    j_fabric.clear_route_cache()
    t_fabric.clear_route_cache()


# ---------------------------------------------------------------------------
# ConfigSpace: shapes, canonical points, sampling, round-trip, validation
# ---------------------------------------------------------------------------

def test_torus_shapes_canonical():
    shapes = torus_shapes(16)
    assert shapes == ((2, 2, 2, 2), (4, 2, 2), (4, 4), (8, 2), (16,))
    for s in shapes:
        assert int(np.prod(s)) == 16
    assert (8,) in torus_shapes(8)
    with pytest.raises(ValueError):
        torus_shapes(1)


def test_default_is_the_pre_qos_baseline(space):
    d = space.default()
    assert d.torus_dims == (4, 4)          # squarest 2-ish-D mesh
    assert d.qos_single and d.route_policy == "hops" and d.stripe_k == 1
    assert d.qos().single_class
    h = space.hand_tuned()
    assert not h.qos_single and h.route_policy == "striped"
    assert not h.qos().single_class
    space.validate(d)
    space.validate(h)


def test_sample_mutate_crossover_stay_valid(space):
    rng = random.Random(3)
    cfgs = [space.sample(rng) for _ in range(25)]
    for c in cfgs:
        space.validate(c)
        space.validate(space.mutate(c, rng))
    for a, b in zip(cfgs, cfgs[1:]):
        space.validate(space.crossover(a, b, rng))


def test_config_json_round_trip(space):
    rng = random.Random(11)
    for _ in range(10):
        cfg = space.sample(rng)
        again = FabricConfig.from_jsonable(
            json.loads(json.dumps(cfg.to_jsonable())))
        assert again == cfg


def test_encode_shape_and_range(space):
    rng = random.Random(5)
    for cfg in [space.default(), space.hand_tuned(),
                *(space.sample(rng) for _ in range(10))]:
        v = space.encode(cfg)
        assert v.shape == (space.encoded_dim,)
        assert np.all(v >= 0.0) and np.all(v <= 1.0)


def test_validate_rejects_bad_configs(space):
    ok = space.default()
    bad = [
        FabricConfig(torus_dims=(3, 5)),                    # 15 nodes
        FabricConfig(torus_dims=(2, 8)),                    # non-canonical
        FabricConfig(torus_dims=ok.torus_dims, stripe_k=99),
        FabricConfig(torus_dims=ok.torus_dims, route_policy="teleport"),
        FabricConfig(torus_dims=ok.torus_dims, bucket_mb=0.0),
        FabricConfig(torus_dims=ok.torus_dims, qos_weights=(1.0, 2.0)),
        FabricConfig(torus_dims=ok.torus_dims,
                     qos_weights=(1.0, -2.0, 1.0, 1.0)),
    ]
    for cfg in bad:
        with pytest.raises(ValueError):
            space.validate(cfg)


# ---------------------------------------------------------------------------
# env contract
# ---------------------------------------------------------------------------

def test_env_step_reward_contract(space):
    env = FabricEnv(space, serving_replay(N), fidelity="fluid")
    obs0 = env.reset(seed=0)
    assert obs0.shape == (space.encoded_dim + 1,)
    assert np.all(obs0 == 0.0) and env.history == []

    cfg = space.default()
    obs, reward, done, info = env.step(cfg)
    assert obs.shape == (space.encoded_dim + 1,)
    assert done is False
    assert info["config"] == cfg
    rep = info["report"]
    assert reward == -rep.objective_s
    assert rep.objective_s > 0.0 and rep.fidelity == "fluid"
    assert rep.decode_span_s > 0.0 and rep.bulk_span_s > 0.0
    assert rep.makespan_s == max(rep.decode_span_s, rep.bulk_span_s,
                                 rep.train_span_s)
    assert obs[-1] == rep.objective_s * 1e3
    assert env.history == [(cfg, rep)]
    spec = env.spec
    assert rep.objective_s == pytest.approx(
        spec.decode_weight * rep.decode_span_s
        + spec.bulk_weight * rep.bulk_span_s
        + spec.train_weight * rep.train_span_s)


def test_env_rejects_mismatched_spec(space):
    with pytest.raises(ValueError):
        FabricEnv(space, serving_replay(8))


def test_training_replay_prices_bucket_tradeoff(space):
    env = FabricEnv(space, training_replay(N), fidelity="fluid")
    base = space.default()
    small = env.score(FabricConfig(torus_dims=base.torus_dims,
                                   bucket_mb=0.125))
    mono = env.score(FabricConfig(torus_dims=base.torus_dims,
                                  bucket_mb=256.0))
    mid = env.score(base)
    # the interior optimum: both extremes lose to the 4 MB default
    assert mid.objective_s < small.objective_s
    assert mid.objective_s < mono.objective_s
    assert mid.train_span_s > 0.0 and mid.decode_span_s == 0.0


# ---------------------------------------------------------------------------
# search: seeded determinism, agents, finalists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agent_name", sorted(AGENTS))
def test_search_is_deterministic_in_seed(space, agent_name):
    env = FabricEnv(space, serving_replay(N), fidelity="fluid")
    a, b = (search(env, AGENTS[agent_name](), steps=8, seed=42)
            for _ in range(2))
    assert a.best_config == b.best_config
    assert a.best_objective_s == b.best_objective_s        # bitwise
    for ta, tb in zip(a.trajectory, b.trajectory):
        assert ta["config"] == tb["config"]
        assert ta["objective_s"] == tb["objective_s"]


def test_search_improves_on_fifo_default(space):
    env = FabricEnv(space, serving_replay(N), fidelity="fluid")
    default_obj = env.score(space.default()).objective_s
    res = search(env, GeneticAgent(), steps=10, seed=0)
    assert res.best_objective_s < default_obj
    assert res.trajectory[0]["config"] == space.default().to_jsonable()
    bests = [t["best_objective_s"] for t in res.trajectory]
    assert bests == sorted(bests, reverse=True)            # monotone curve


def test_finalists_distinct_and_ranked(space):
    env = FabricEnv(space, serving_replay(N), fidelity="fluid")
    res = search(env, RandomWalkAgent(), steps=6, seed=1)
    final = finalists(res, k=3)
    assert 1 <= len(final) <= 3
    keys = [json.dumps(c.to_jsonable(), sort_keys=True) for c in final]
    assert len(set(keys)) == len(keys)                     # distinct
    assert final[0] == res.best_config                     # best first


def test_fluid_winner_agrees_with_packet_oracle(space):
    """The two-fidelity contract on the winner: fluid objective within
    10% of the packet oracle's for the config the search would ship."""
    env = FabricEnv(space, serving_replay(N), fidelity="fluid")
    res = search(env, GeneticAgent(), steps=8, seed=0)
    fluid = env.score(res.best_config, fidelity="fluid").objective_s
    packet, = rescore(env, [res.best_config], fidelity="packet")
    assert packet.fidelity == "packet"
    assert abs(fluid - packet.objective_s) / packet.objective_s <= 0.10


# ---------------------------------------------------------------------------
# best_configs.json: save/load, trainer + cluster default paths
# ---------------------------------------------------------------------------

def _pin(tmp_path, monkeypatch, cfg: FabricConfig, workloads=("serving",
                                                              "train")):
    path = tmp_path / "best_configs.json"
    monkeypatch.setenv(autotune.BEST_CONFIGS_ENV, str(path))
    autotune.save_best_configs(
        {w: {"config": cfg.to_jsonable()} for w in workloads})
    return path


def test_disabled_and_missing_artifact_fall_back(monkeypatch, tmp_path):
    assert autotune.best_configs_path() is None
    assert autotune.load_best_configs() == {}
    assert autotune.tuned_config("serving") is None
    assert autotune.tuned_knob("train", "bucket_mb", 4.0) == 4.0
    monkeypatch.setenv(autotune.BEST_CONFIGS_ENV,
                       str(tmp_path / "nope.json"))
    assert autotune.load_best_configs() == {}
    assert autotune.tuned_config("train") is None


def test_corrupt_artifact_returns_defaults(monkeypatch, tmp_path):
    p = tmp_path / "best_configs.json"
    p.write_text("{not json")
    monkeypatch.setenv(autotune.BEST_CONFIGS_ENV, str(p))
    assert autotune.load_best_configs() == {}
    assert autotune.tuned_config("serving") is None
    p.write_text(json.dumps({"workloads": {"serving": {"config": {}}}}))
    assert autotune.tuned_config("serving") is None


def test_save_is_deterministic(monkeypatch, tmp_path):
    cfg = ConfigSpace(N).hand_tuned()
    p1 = _pin(tmp_path, monkeypatch, cfg)
    first = p1.read_bytes()
    _pin(tmp_path, monkeypatch, cfg)
    assert p1.read_bytes() == first
    assert autotune.tuned_config("serving") == cfg


def test_save_refuses_when_disabled():
    with pytest.raises(ValueError):
        autotune.save_best_configs({})     # conftest: BEST_CONFIGS=0


def test_trainer_config_loads_pinned_bucket(monkeypatch, tmp_path):
    from repro_torch.runtime.trainer import TrainerConfig
    assert TrainerConfig().bucket_mb == 4.0
    _pin(tmp_path, monkeypatch, FabricConfig(torus_dims=(4, 4),
                                             bucket_mb=12.5))
    assert TrainerConfig().bucket_mb == 12.5
    assert TrainerConfig(bucket_mb=2.0).bucket_mb == 2.0


@pytest.fixture(scope="module")
def dense_model():
    from repro_torch import configs
    from repro_torch.models import api
    cfg = configs.get_reduced("smollm-135m")
    return cfg, api.get_model(cfg).init(torch.Generator().manual_seed(0))


def _cluster(dense_model, **kw):
    from repro_torch.core.topology import Torus
    from repro_torch.serving.cluster import ServingCluster
    cfg, params = dense_model
    return ServingCluster(cfg, params, torus=Torus((4,)), node_ranks=(0, 1),
                          max_batch=2, max_seq=64, page_tokens=8,
                          device="cpu", **kw)


def test_cluster_defaults_without_artifact(dense_model):
    cl = _cluster(dense_model)
    assert cl._tuned is None
    assert cl.sim.qos.single_class        # legacy FIFO link


def test_cluster_loads_pinned_qos_and_route(dense_model, monkeypatch,
                                            tmp_path):
    tuned = FabricConfig(torus_dims=(4,), qos_single=False,
                         qos_weights=(4.0, 16.0, 8.0, 1.0),
                         qos_credit_frac=(0.1, 0.4, 0.3, 0.2),
                         stripe_k=2, route_policy="striped")
    _pin(tmp_path, monkeypatch, tuned)
    cl = _cluster(dense_model)
    assert cl._tuned == tuned
    assert not cl.sim.qos.single_class    # searched multi-class policy
    cl2 = _cluster(dense_model,
                   qos=t_fabric.QosPolicy(single_class=True))
    assert cl2.sim.qos.single_class


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _jax_cfg(cfg: FabricConfig) -> J.FabricConfig:
    return J.FabricConfig.from_jsonable(cfg.to_jsonable())


@pytest.mark.parametrize("n", [8, 12, 16, 64])
def test_torus_shapes_equal_jax(n):
    assert torus_shapes(n) == J.torus_shapes(n)


def test_space_draws_equal_jax_for_one_seed(space):
    """sample, mutate, crossover and encode consume one Random stream the
    same way in both packages."""
    js = J.ConfigSpace(N)
    rt, rj = random.Random(7), random.Random(7)
    assert space.default().to_jsonable() == js.default().to_jsonable()
    assert space.hand_tuned().to_jsonable() == js.hand_tuned().to_jsonable()
    for _ in range(20):
        a, b = space.sample(rt), space.sample(rt)
        ja, jb = js.sample(rj), js.sample(rj)
        assert a.to_jsonable() == ja.to_jsonable()
        assert b.to_jsonable() == jb.to_jsonable()
        m, jm = space.mutate(a, rt), js.mutate(ja, rj)
        assert m.to_jsonable() == jm.to_jsonable()
        c, jc = space.crossover(a, b, rt), js.crossover(ja, jb, rj)
        assert c.to_jsonable() == jc.to_jsonable()
        assert np.array_equal(space.encode(c), js.encode(jc))
    assert rt.random() == rj.random()      # the streams stayed in step


@pytest.mark.parametrize("replay", ["serving", "training"])
@pytest.mark.parametrize("fidelity", ["fluid", "packet"])
def test_score_equals_jax(space, replay, fidelity):
    mk = {"serving": (serving_replay, J.serving_replay),
          "training": (training_replay, J.training_replay)}[replay]
    env = FabricEnv(space, mk[0](N), fidelity=fidelity)
    jenv = J.FabricEnv(J.ConfigSpace(N), mk[1](N), fidelity=fidelity)
    for cfg in (space.default(), space.hand_tuned(),
                FabricConfig(torus_dims=(8, 2), qos_single=False,
                             stripe_k=2, route_policy="congestion",
                             bucket_mb=16.0)):
        t, j = env.score(cfg), jenv.score(_jax_cfg(cfg))
        for k in ("objective_s", "decode_span_s", "bulk_span_s",
                  "train_span_s", "makespan_s"):
            assert getattr(t, k) == getattr(j, k), (cfg, k)


@pytest.mark.parametrize("agent_name", sorted(AGENTS))
def test_search_trajectory_equals_jax(space, agent_name):
    res = search(FabricEnv(space, serving_replay(N)), AGENTS[agent_name](),
                 steps=8, seed=0)
    jres = J.search(J.FabricEnv(J.ConfigSpace(N), J.serving_replay(N)),
                    J.AGENTS[agent_name](), steps=8, seed=0)
    assert [t["config"] for t in res.trajectory] == \
        [t["config"] for t in jres.trajectory]
    assert [t["objective_s"] for t in res.trajectory] == \
        [t["objective_s"] for t in jres.trajectory]
    assert res.best_config.to_jsonable() == jres.best_config.to_jsonable()
    assert res.best_objective_s == jres.best_objective_s


def test_finalists_rescore_and_saved_bytes_equal_jax(space, monkeypatch,
                                                     tmp_path):
    env = FabricEnv(space, serving_replay(N))
    jenv = J.FabricEnv(J.ConfigSpace(N), J.serving_replay(N))
    res = search(env, GeneticAgent(), steps=6, seed=0)
    jres = J.search(jenv, J.GeneticAgent(), steps=6, seed=0)
    final, jfinal = finalists(res, k=3), J.finalists(jres, k=3)
    assert [c.to_jsonable() for c in final] == \
        [c.to_jsonable() for c in jfinal]
    reps = rescore(env, final, fidelity="packet")
    jreps = J.rescore(jenv, jfinal, fidelity="packet")
    assert [r.objective_s for r in reps] == [r.objective_s for r in jreps]
    entries = {"serving": {"config": final[0].to_jsonable(),
                           "packet_objective_s": reps[0].objective_s,
                           "search": {k: v for k, v in res.summary().items()
                                      if k != "wall_s"}}}
    jentries = {"serving": {"config": jfinal[0].to_jsonable(),
                            "packet_objective_s": jreps[0].objective_s,
                            "search": {k: v for k, v in
                                       jres.summary().items()
                                       if k != "wall_s"}}}
    out = autotune.save_best_configs(entries,
                                     path=str(tmp_path / "port.json"))
    jout = J.save_best_configs(jentries, path=str(tmp_path / "jax.json"))
    with open(out, "rb") as f, open(jout, "rb") as g:
        assert f.read() == g.read()
