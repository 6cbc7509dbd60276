"""Fabric design-space autotuner — ArchGym-style agent/environment split
over the fabric's knobs.

The counterpart of the JAX package's ``core/fabric/autotune.py``: a
gym-style environment (``FabricEnv``) prices one candidate configuration
per ``step`` on a replayed workload (``serving_replay``,
``training_replay``) over the port's simulators (``make_sim``: the packet,
fluid and hybrid tiers, bit-identical to the JAX package's), and
interchangeable search agents (seeded random walk, genetic, GP-based
Bayesian optimisation) drive it, after ArchGym (Krishnan et al., ISCA
2023).  The knobs: torus shape, per-class ``QosPolicy`` weights and credit
fractions, the overlap engine's bucket size, the stripe count, the route
policy and the QoS controller's gains.

The inner loop scores every candidate on the **fluid** tier; only the
top-k finalists are re-scored on the **packet** oracle before a winner is
declared:

    space  = ConfigSpace(n_nodes=16)
    env    = FabricEnv(space, serving_replay(16), fidelity="fluid")
    result = search(env, GeneticAgent(), steps=40, seed=0)
    winner = rescore(env, finalists(result), fidelity="packet")

The module is host code.  It draws every random number from the caller's
``random.Random`` and uses numpy exactly where the reference does, so the
same seed gives the JAX package's trajectory, winner and ``objective_s``
floats, bit for bit.

Winning configurations persist as ``best_configs.json`` (per workload:
config, fluid + packet objectives, trajectory summary).  ``TrainerConfig``
(``bucket_mb``), ``ServingCluster(qos="auto")``,
``migrate(route_policy=None)`` and ``QosCtlPolicy.tuned`` load that file by
default — explicit arguments always win, and a missing file silently
keeps the legacy defaults, so the artifact is an overlay, never a
dependency.  Set ``BEST_CONFIGS=<path>`` to point elsewhere or
``BEST_CONFIGS=0`` to disable loading.  Either package reads the other's
file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import fabric
from repro_torch.core.apelink import NetModel
from repro_torch.core.fabric.qos import QosPolicy, TrafficClass
from repro_torch.core.topology import Torus

ROUTE_POLICIES = ("hops", "congestion", "striped")

#: env var naming the best-config artifact ("0"/"" disables loading)
BEST_CONFIGS_ENV = "BEST_CONFIGS"
BEST_CONFIGS_FILE = "best_configs.json"

_CLASSES = tuple(TrafficClass)


# ---------------------------------------------------------------------------
# configuration point + typed search space
# ---------------------------------------------------------------------------

def torus_shapes(n_nodes: int, max_ndims: int = 4) -> tuple[tuple[int, ...], ...]:
    """Candidate torus shapes for ``n_nodes``: every factorization into
    dims >= 2 (sorted descending, up to ``max_ndims`` dims) plus the flat
    ring ``(n,)`` — the discrete geometry axis of the design space."""
    if n_nodes < 2:
        raise ValueError(f"need >= 2 nodes, got {n_nodes}")
    shapes: set[tuple[int, ...]] = {(n_nodes,)}

    def rec(rem: int, maxf: int, acc: tuple[int, ...]) -> None:
        if rem == 1 and len(acc) >= 2:
            shapes.add(acc)
            return
        if len(acc) >= max_ndims:
            return
        f = min(maxf, rem)
        while f >= 2:
            if rem % f == 0:
                rec(rem // f, f, acc + (f,))
            f -= 1

    rec(n_nodes, n_nodes, ())
    return tuple(sorted(shapes))


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """One point of the design space — every knob the search may turn.

    ``qos_weights`` / ``qos_credit_frac`` are in ``TrafficClass`` order
    (CONTROL, DECODE, COLLECTIVE, BULK); ``qos_single=True`` collapses
    them onto the legacy single-FIFO link (the pre-QoS default the
    search must beat).  ``ctl_gain`` / ``ctl_decay`` / ``ctl_floor`` are
    the closed-loop controller's step sizes and relief floor
    (``fabric.QosCtlPolicy`` — the static weights above are its
    *baseline*, these knobs shape how far and how fast it departs from
    them)."""

    torus_dims: tuple[int, ...]
    qos_single: bool = True
    qos_weights: tuple[float, ...] = (4.0, 16.0, 8.0, 1.0)
    qos_credit_frac: tuple[float, ...] = (0.10, 0.40, 0.30, 0.20)
    bucket_mb: float = 4.0
    stripe_k: int = 1
    route_policy: str = "hops"
    ctl_gain: float = 1.6
    ctl_decay: float = 0.6
    ctl_floor: float = 0.25

    def qos(self) -> QosPolicy:
        """The ``QosPolicy`` this config lowers to."""
        if self.qos_single:
            return QosPolicy(single_class=True)
        return QosPolicy(
            weights=dict(zip(_CLASSES, self.qos_weights)),
            credit_frac=dict(zip(_CLASSES, self.qos_credit_frac)))

    def to_jsonable(self) -> dict:
        d = dataclasses.asdict(self)
        d["torus_dims"] = list(self.torus_dims)
        d["qos_weights"] = list(self.qos_weights)
        d["qos_credit_frac"] = list(self.qos_credit_frac)
        return d

    @classmethod
    def from_jsonable(cls, d: Mapping) -> "FabricConfig":
        # the controller knobs came later than the rest: artifacts
        # pinned before them load with the defaults, not a KeyError
        return cls(torus_dims=tuple(int(x) for x in d["torus_dims"]),
                   qos_single=bool(d["qos_single"]),
                   qos_weights=tuple(float(x) for x in d["qos_weights"]),
                   qos_credit_frac=tuple(float(x)
                                         for x in d["qos_credit_frac"]),
                   bucket_mb=float(d["bucket_mb"]),
                   stripe_k=int(d["stripe_k"]),
                   route_policy=str(d["route_policy"]),
                   ctl_gain=float(d.get("ctl_gain", 1.6)),
                   ctl_decay=float(d.get("ctl_decay", 0.6)),
                   ctl_floor=float(d.get("ctl_floor", 0.25)))


class ConfigSpace:
    """The typed design space: sampling, mutation, crossover, a fixed
    vector encoding (for the GP agent and the env observation), and
    validation.  All randomness comes from the caller's ``random.Random``
    so searches are exactly reproducible from their seed."""

    def __init__(self, n_nodes: int, *,
                 bucket_range_mb: tuple[float, float] = (1.0, 256.0),
                 weight_range: tuple[float, float] = (1.0, 32.0),
                 min_credit_frac: float = 0.05,
                 stripe_max: int = 4,
                 ctl_gain_range: tuple[float, float] = (1.1, 3.0)) -> None:
        if bucket_range_mb[0] <= 0 or bucket_range_mb[0] > bucket_range_mb[1]:
            raise ValueError(f"bad bucket range {bucket_range_mb}")
        if stripe_max < 1:
            raise ValueError(f"stripe_max must be >= 1, got {stripe_max}")
        if not 1.0 < ctl_gain_range[0] <= ctl_gain_range[1]:
            raise ValueError(f"bad ctl_gain range {ctl_gain_range}")
        self.n_nodes = n_nodes
        self.shapes = torus_shapes(n_nodes)
        self.bucket_range_mb = (float(bucket_range_mb[0]),
                                float(bucket_range_mb[1]))
        self.weight_range = (float(weight_range[0]), float(weight_range[1]))
        self.min_credit_frac = float(min_credit_frac)
        self.stripe_max = int(stripe_max)
        self.ctl_gain_range = (float(ctl_gain_range[0]),
                               float(ctl_gain_range[1]))

    # -- canonical points -----------------------------------------------------
    def default(self) -> FabricConfig:
        """The hand-picked pre-QoS baseline every benchmark ran before
        the QoS layer: squarest torus, single-FIFO link, dimension-ordered
        routing, no striping, 4 MB buckets.  This is the config the
        ``autotune_gain`` gate compares winners against."""
        return FabricConfig(torus_dims=self._squarest())

    def hand_tuned(self) -> FabricConfig:
        """The hand-tuned operating point (default ``QosPolicy``,
        congestion-probed routes, 3-way striping) — a strong seed for the
        agents' initial populations, and the bar a search should at least
        reach."""
        return FabricConfig(
            torus_dims=self._squarest(), qos_single=False,
            qos_weights=tuple(float(w) for w in
                              QosPolicy().weight_vector()),
            qos_credit_frac=(0.10, 0.40, 0.30, 0.20),
            bucket_mb=4.0, stripe_k=3, route_policy="striped")

    def _squarest(self) -> tuple[int, ...]:
        # the repo's hand-pick convention: a balanced 2-ish-D mesh
        # (PagedLM defaults Torus((4, 4)), contention runs (4, 4, 4))
        return min(self.shapes,
                   key=lambda s: (abs(len(s) - 2), max(s) - min(s)))

    # -- sampling / perturbation ---------------------------------------------
    def sample(self, rng: random.Random) -> FabricConfig:
        lo, hi = self.weight_range
        blo, bhi = self.bucket_range_mb
        glo, ghi = self.ctl_gain_range
        fracs = self._norm_fracs([rng.random() + self.min_credit_frac
                                  for _ in _CLASSES])
        return FabricConfig(
            torus_dims=rng.choice(self.shapes),
            qos_single=rng.random() < 0.2,
            qos_weights=tuple(round(np.exp(rng.uniform(np.log(lo),
                                                       np.log(hi))), 4)
                              for _ in _CLASSES),
            qos_credit_frac=fracs,
            bucket_mb=round(float(np.exp(rng.uniform(np.log(blo),
                                                     np.log(bhi)))), 4),
            stripe_k=rng.randint(1, self.stripe_max),
            route_policy=rng.choice(ROUTE_POLICIES),
            ctl_gain=round(rng.uniform(glo, ghi), 4),
            ctl_decay=round(rng.uniform(0.3, 0.9), 4),
            ctl_floor=round(rng.uniform(0.1, 0.8), 4))

    def mutate(self, cfg: FabricConfig, rng: random.Random,
               scale: float = 0.5) -> FabricConfig:
        """Perturb 1-2 knobs of ``cfg`` (log-normal nudges on continuous
        knobs, neighbour moves on discrete ones)."""
        self.validate(cfg)
        d = cfg.to_jsonable()
        knobs = ["torus_dims", "qos_single", "qos_weights",
                 "qos_credit_frac", "bucket_mb", "stripe_k", "route_policy",
                 "ctl"]
        for knob in rng.sample(knobs, k=rng.randint(1, 2)):
            if knob == "torus_dims":
                d[knob] = list(rng.choice(self.shapes))
            elif knob == "qos_single":
                d[knob] = not d[knob]
            elif knob == "qos_weights":
                i = rng.randrange(len(_CLASSES))
                w = d[knob][i] * float(np.exp(rng.gauss(0.0, scale)))
                d[knob][i] = round(self._clip(w, *self.weight_range), 4)
                d["qos_single"] = False
            elif knob == "qos_credit_frac":
                i = rng.randrange(len(_CLASSES))
                d[knob][i] *= float(np.exp(rng.gauss(0.0, scale)))
                d[knob] = list(self._norm_fracs(d[knob]))
                d["qos_single"] = False
            elif knob == "bucket_mb":
                b = d[knob] * float(np.exp(rng.gauss(0.0, 2 * scale)))
                d[knob] = round(self._clip(b, *self.bucket_range_mb), 4)
            elif knob == "stripe_k":
                d[knob] = self._clip(d[knob] + rng.choice((-1, 1)),
                                     1, self.stripe_max)
            elif knob == "ctl":
                g = d["ctl_gain"] * float(np.exp(rng.gauss(0.0, scale)))
                d["ctl_gain"] = round(self._clip(g, *self.ctl_gain_range), 4)
                d["ctl_decay"] = round(self._clip(
                    d["ctl_decay"] * float(np.exp(rng.gauss(0.0, scale))),
                    0.3, 0.9), 4)
                d["ctl_floor"] = round(self._clip(
                    d["ctl_floor"] * float(np.exp(rng.gauss(0.0, scale))),
                    0.1, 0.8), 4)
            else:
                d[knob] = rng.choice(ROUTE_POLICIES)
        return FabricConfig.from_jsonable(d)

    def crossover(self, a: FabricConfig, b: FabricConfig,
                  rng: random.Random) -> FabricConfig:
        """Uniform per-knob crossover (QoS weights/fractions travel with
        the ``qos_single`` flag so a child never mixes FIFO with one
        parent's weight vector incoherently)."""
        da, db = a.to_jsonable(), b.to_jsonable()
        child = {}
        qos_src = da if rng.random() < 0.5 else db
        for k in ("qos_single", "qos_weights", "qos_credit_frac"):
            child[k] = qos_src[k]
        for k in ("torus_dims", "bucket_mb", "stripe_k", "route_policy"):
            child[k] = (da if rng.random() < 0.5 else db)[k]
        # the controller's three knobs travel together (gain/decay/floor
        # form one damping profile — mixing parents' halves of it breaks
        # the stability the search scored)
        ctl_src = da if rng.random() < 0.5 else db
        for k in ("ctl_gain", "ctl_decay", "ctl_floor"):
            child[k] = ctl_src[k]
        return FabricConfig.from_jsonable(child)

    # -- encoding (GP features / env observation) -----------------------------
    def encode(self, cfg: FabricConfig) -> np.ndarray:
        """Fixed-length [0, 1] feature vector: shape index, FIFO flag,
        log-weights, credit fractions, log-bucket, stripes, route index."""
        lo, hi = np.log(self.weight_range[0]), np.log(self.weight_range[1])
        blo, bhi = (np.log(self.bucket_range_mb[0]),
                    np.log(self.bucket_range_mb[1]))
        feats = [self.shapes.index(cfg.torus_dims) / max(len(self.shapes) - 1,
                                                         1),
                 1.0 if cfg.qos_single else 0.0]
        feats += [(np.log(w) - lo) / max(hi - lo, 1e-12)
                  for w in cfg.qos_weights]
        feats += list(cfg.qos_credit_frac)
        feats.append((np.log(cfg.bucket_mb) - blo) / max(bhi - blo, 1e-12))
        feats.append((cfg.stripe_k - 1) / max(self.stripe_max - 1, 1))
        feats.append(ROUTE_POLICIES.index(cfg.route_policy)
                     / (len(ROUTE_POLICIES) - 1))
        glo, ghi = self.ctl_gain_range
        feats.append((cfg.ctl_gain - glo) / max(ghi - glo, 1e-12))
        feats.append((cfg.ctl_decay - 0.3) / 0.6)
        feats.append((cfg.ctl_floor - 0.1) / 0.7)
        return np.asarray(feats, dtype=np.float64)

    @property
    def encoded_dim(self) -> int:
        return 8 + 2 * len(_CLASSES)

    # -- validation -----------------------------------------------------------
    def validate(self, cfg: FabricConfig) -> None:
        n = 1
        for d in cfg.torus_dims:
            n *= d
        if n != self.n_nodes:
            raise ValueError(f"torus_dims {cfg.torus_dims} has {n} nodes, "
                             f"space wants {self.n_nodes}")
        if cfg.torus_dims not in self.shapes:
            raise ValueError(f"torus_dims {cfg.torus_dims} not a canonical "
                             f"shape of {self.n_nodes} nodes")
        if len(cfg.qos_weights) != len(_CLASSES) \
                or len(cfg.qos_credit_frac) != len(_CLASSES):
            raise ValueError("need one weight + credit fraction per "
                             f"TrafficClass, got {cfg.qos_weights} / "
                             f"{cfg.qos_credit_frac}")
        if any(w <= 0 for w in cfg.qos_weights) \
                or any(f <= 0 for f in cfg.qos_credit_frac):
            raise ValueError("QoS weights and credit fractions must be > 0")
        if not (0 < cfg.bucket_mb):
            raise ValueError(f"bucket_mb must be > 0, got {cfg.bucket_mb}")
        if not 1 <= cfg.stripe_k <= self.stripe_max:
            raise ValueError(f"stripe_k {cfg.stripe_k} outside "
                             f"[1, {self.stripe_max}]")
        if cfg.route_policy not in ROUTE_POLICIES:
            raise ValueError(f"unknown route_policy {cfg.route_policy!r}; "
                             f"expected one of {ROUTE_POLICIES}")
        if not self.ctl_gain_range[0] <= cfg.ctl_gain \
                <= self.ctl_gain_range[1]:
            raise ValueError(f"ctl_gain {cfg.ctl_gain} outside "
                             f"{self.ctl_gain_range}")
        if not 0.0 < cfg.ctl_decay < 1.0:
            raise ValueError(
                f"ctl_decay must be in (0, 1), got {cfg.ctl_decay}")
        if not 0.0 < cfg.ctl_floor <= 1.0:
            raise ValueError(
                f"ctl_floor must be in (0, 1], got {cfg.ctl_floor}")

    def _norm_fracs(self, fracs: Sequence[float]) -> tuple[float, ...]:
        f = np.clip(np.asarray(fracs, dtype=float), self.min_credit_frac,
                    None)
        f = f / f.sum()
        return tuple(round(float(x), 4) for x in f)

    @staticmethod
    def _clip(v, lo, hi):
        return max(lo, min(hi, v))


# ---------------------------------------------------------------------------
# replayed workloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplaySpec:
    """One replayable workload: what traffic hits the fabric, and how the
    per-class completion spans weigh into the scalar objective.  The same
    spec replays identically at any fidelity tier — that is what makes
    the fluid-inner-loop / packet-finalist discipline coherent."""

    name: str
    n_nodes: int
    # serving side: chained decode-step TP all-reduces (DECODE class)
    decode_steps: int = 0
    tp_step_bytes: int = 8 << 20
    # bulk side: (src, dst, nbytes) one-shot PUTs (BULK class), each
    # preceded by a 64 B CONTROL descriptor — routed per config
    bulk: tuple[tuple[int, int, int], ...] = ()
    # trainer side: grad_bytes of fp32 gradients reduce-scattered in
    # config.bucket_mb buckets, bucket i's grads materialising at
    # (i+1)/n of compute_s (the backward-readiness stagger)
    grad_bytes: int = 0
    compute_s: float = 0.0
    # objective = decode_w*decode_span + bulk_w*bulk_span + train_w*train
    decode_weight: float = 1.0
    bulk_weight: float = 0.25
    train_weight: float = 1.0
    packet_bytes: int = 40960   # coarse packets: same grid both tiers


def serving_replay(n_nodes: int = 16, *, decode_steps: int = 4,
                   tp_step_bytes: int = 8 << 20,
                   bulk_bytes: int = 32 << 20) -> ReplaySpec:
    """The gated serving workload: a continuous decode TP stream while
    two bulk KV-migration PUTs cross the fabric — the co-location regime
    of the JAX package's contention and QoS benchmarks, as a search
    target."""
    t = Torus((n_nodes,))
    pairs = ((0, t.size // 2 + t.size // 8), (t.size // 4, t.size - 1))
    return ReplaySpec(name="serving", n_nodes=n_nodes,
                      decode_steps=decode_steps,
                      tp_step_bytes=tp_step_bytes,
                      bulk=tuple((s, d, bulk_bytes) for s, d in pairs))


def training_replay(n_nodes: int = 16, *, grad_bytes: int = 128 << 20,
                    compute_s: float = 15e-3) -> ReplaySpec:
    """The trainer workload: one backward pass's bucketed gradient
    reduce-scatter under the readiness stagger — the carried "sim-driven
    bucket sizing" item as an inner objective (too-small buckets pay
    per-message latency x count, too-big ones serialize behind compute)."""
    return ReplaySpec(name="train", n_nodes=n_nodes, grad_bytes=grad_bytes,
                      compute_s=compute_s)


@dataclasses.dataclass(frozen=True)
class ScoreReport:
    """One configuration priced on one fidelity tier."""

    objective_s: float
    decode_span_s: float
    bulk_span_s: float
    train_span_s: float
    makespan_s: float
    fidelity: str
    wall_s: float

    def to_jsonable(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# the environment
# ---------------------------------------------------------------------------

class FabricEnv:
    """Gym-style environment over ``make_sim`` + one replayed workload.

    ``reset() -> obs``; ``step(config) -> (obs, reward, done, info)`` with
    ``reward = -objective_s`` (negative modelled completion objective —
    decode-span-dominated for serving replays, makespan for training
    replays).  ``done`` is always False: the step budget belongs to the
    driver (``search``), not the env.  ``score`` is the pure pricing
    function ``step`` wraps; pass ``fidelity="packet"`` there to re-score
    a finalist on the oracle.

    Route resolution (``route_policy="congestion"|"striped"``) always
    probes a *fluid* replica of the workload, whatever fidelity then
    prices the resulting timeline — the probe tier is part of the
    configuration under test (it is what a production router on a big
    torus would run), and it keeps the flow set identical across tiers so
    the finalist re-score measures modelling error, not routing drift.
    """

    def __init__(self, space: ConfigSpace, spec: ReplaySpec, *,
                 fidelity: str = "fluid", net: NetModel | None = None)\
            -> None:
        if spec.n_nodes != space.n_nodes:
            raise ValueError(f"spec wants {spec.n_nodes} nodes, space has "
                             f"{space.n_nodes}")
        self.space = space
        self.spec = spec
        self.fidelity = fidelity
        self.net = net or NetModel()
        self.history: list[tuple[FabricConfig, ScoreReport]] = []
        self._last_obs = np.zeros(space.encoded_dim + 1)

    # -- gym surface ----------------------------------------------------------
    def reset(self, seed: int | None = None) -> np.ndarray:
        del seed   # the env itself is deterministic; agents own the rng
        self.history = []
        self._last_obs = np.zeros(self.space.encoded_dim + 1)
        return self._last_obs

    def step(self, config: FabricConfig)\
            -> tuple[np.ndarray, float, bool, dict]:
        report = self.score(config)
        self.history.append((config, report))
        obs = np.concatenate([self.space.encode(config),
                              [report.objective_s * 1e3]])
        self._last_obs = obs
        return obs, -report.objective_s, False, {"report": report,
                                                 "config": config}

    # -- pricing --------------------------------------------------------------
    def score(self, config: FabricConfig,
              fidelity: str | None = None) -> ScoreReport:
        self.space.validate(config)
        fidelity = fidelity or self.fidelity
        t0 = time.perf_counter()
        plans = self._resolve_bulk_routes(config)
        sim = self._make_sim(config, fidelity)
        decode, bulk, train = self._inject(sim, config, plans)
        sim.run()

        def span(fids):
            return max((sim.finish_s(f) for f in fids), default=0.0)

        d, b, tr = span(decode), span(bulk), span(train)
        obj = (self.spec.decode_weight * d + self.spec.bulk_weight * b
               + self.spec.train_weight * tr)
        return ScoreReport(objective_s=obj, decode_span_s=d, bulk_span_s=b,
                           train_span_s=tr, makespan_s=max(d, b, tr),
                           fidelity=fidelity,
                           wall_s=time.perf_counter() - t0)

    # -- workload replay ------------------------------------------------------
    def _make_sim(self, config: FabricConfig, fidelity: str):
        return fabric.make_sim(Torus(config.torus_dims), self.net,
                               fidelity=fidelity, qos=config.qos(),
                               packet_bytes=self.spec.packet_bytes)

    def _resolve_bulk_routes(self, config: FabricConfig) -> list[list]:
        """Per-bulk-transfer ``[(route | None, frac), ...]`` stripe plans,
        probed against a fluid replica carrying the decode stream and the
        previously-routed bulk flows."""
        if not self.spec.bulk:
            return []
        if config.route_policy == "hops":
            return [[(None, 1.0)] for _ in self.spec.bulk]
        probe = self._make_sim(config, "fluid")
        self._inject_decode(probe, Torus(config.torus_dims))
        plans: list[list] = []
        for src, dst, nbytes in self.spec.bulk:
            if config.route_policy == "congestion":
                route, _ = fabric.best_route(probe, src, dst, nbytes,
                                             cls=TrafficClass.BULK)
                plan = [(route, 1.0)]
            else:
                plan = [(r, f) for r, f in fabric.striped_routes(
                    probe, src, dst, nbytes, k=config.stripe_k,
                    cls=TrafficClass.BULK) if f > 0]
            plans.append(plan)
            for route, frac in plan:   # later probes see earlier bulk
                probe.inject(src, dst, frac * nbytes, route=route,
                             cls=TrafficClass.BULK)
        return plans

    def _inject_decode(self, sim, torus: Torus) -> list[int]:
        fids: list[int] = []
        if not self.spec.decode_steps:
            return fids
        tp = fabric.lower(fabric.AR, torus, tuple(range(torus.ndims)))
        tail: list[int] = []
        for _ in range(self.spec.decode_steps):
            tail = fabric.inject_schedule(
                sim, tp, self.spec.tp_step_bytes, start_s=0.0,
                after=tuple(tail), granularity="phase",
                cls=TrafficClass.DECODE)
            fids.extend(tail)
        return fids

    def _inject(self, sim, config: FabricConfig, plans: list[list])\
            -> tuple[list[int], list[int], list[int]]:
        torus = Torus(config.torus_dims)
        decode = self._inject_decode(sim, torus)
        bulk: list[int] = []
        for (src, dst, nbytes), plan in zip(self.spec.bulk, plans):
            sim.inject(src, dst, 64, cls=TrafficClass.CONTROL)
            for route, frac in plan:
                bulk.append(sim.inject(src, dst, frac * nbytes, route=route,
                                       cls=TrafficClass.BULK))
        train: list[int] = []
        if self.spec.grad_bytes:
            rs = fabric.lower(fabric.RS, torus, tuple(range(torus.ndims)))
            bucket = max(int(config.bucket_mb * (1 << 20)), 1)
            n = -(-self.spec.grad_bytes // bucket)
            tail: list[int] = []
            for i in range(n):
                nb = min(bucket, self.spec.grad_bytes - i * bucket)
                ready = (i + 1) * self.spec.compute_s / n
                tail = fabric.inject_schedule(
                    sim, rs, nb, start_s=ready, after=tuple(tail),
                    granularity="phase", cls=TrafficClass.COLLECTIVE)
                train.extend(tail)
        return decode, bulk, train


# ---------------------------------------------------------------------------
# search agents
# ---------------------------------------------------------------------------

class SearchAgent:
    """ask/tell agent base: ``reset(space, rng)`` binds the (seeded)
    stream, ``ask()`` proposes a config, ``tell(config, reward)`` reports
    its reward (bigger = better; the env's is ``-objective_s``)."""

    name = "agent"

    def reset(self, space: ConfigSpace, rng: random.Random) -> None:
        self.space = space
        self.rng = rng
        self.best: FabricConfig | None = None
        self.best_reward = -np.inf
        self._n = 0

    def ask(self) -> FabricConfig:
        raise NotImplementedError

    def tell(self, config: FabricConfig, reward: float) -> None:
        self._n += 1
        if reward > self.best_reward:
            self.best_reward = reward
            self.best = config

    def _seeds(self) -> list[FabricConfig]:
        """Every agent warm-starts from the two canonical points: the
        pre-QoS default and the hand-tuned operating point."""
        return [self.space.default(), self.space.hand_tuned()]


class RandomWalkAgent(SearchAgent):
    """Seeded greedy random walk: mutate the incumbent best, with an
    ``eps`` chance of a fresh uniform sample (restart pressure)."""

    name = "random_walk"

    def __init__(self, eps: float = 0.25) -> None:
        self.eps = eps

    def ask(self) -> FabricConfig:
        seeds = self._seeds()
        if self._n < len(seeds):
            return seeds[self._n]
        if self.best is None or self.rng.random() < self.eps:
            return self.space.sample(self.rng)
        return self.space.mutate(self.best, self.rng)


class GeneticAgent(SearchAgent):
    """Steady-state GA: tournament parent selection over the telled
    population, crossover + mutation children, truncation survival."""

    name = "genetic"

    def __init__(self, pop_size: int = 8, tournament: int = 3,
                 crossover_p: float = 0.6) -> None:
        self.pop_size = pop_size
        self.tournament = tournament
        self.crossover_p = crossover_p

    def reset(self, space: ConfigSpace, rng: random.Random) -> None:
        super().reset(space, rng)
        self.pop: list[tuple[float, FabricConfig]] = []

    def ask(self) -> FabricConfig:
        seeds = self._seeds()
        if self._n < len(seeds):
            return seeds[self._n]
        if len(self.pop) < self.pop_size:
            return self.space.sample(self.rng)
        if self.rng.random() < self.crossover_p:
            a = self._select()
            b = self._select()
            child = self.space.crossover(a, b, self.rng)
            return self.space.mutate(child, self.rng)
        return self.space.mutate(self._select(), self.rng)

    def tell(self, config: FabricConfig, reward: float) -> None:
        super().tell(config, reward)
        self.pop.append((reward, config))
        if len(self.pop) > self.pop_size:
            self.pop.sort(key=lambda p: -p[0])
            del self.pop[self.pop_size:]

    def _select(self) -> FabricConfig:
        picks = [self.pop[self.rng.randrange(len(self.pop))]
                 for _ in range(min(self.tournament, len(self.pop)))]
        return max(picks, key=lambda p: p[0])[1]


class GpBoAgent(SearchAgent):
    """Plain-NumPy Gaussian-process Bayesian optimisation: RBF kernel on
    the space encoding, expected improvement maximised over a sampled
    candidate pool (half fresh samples, half mutations of the best telled
    configs) — the "simple BO loop" ArchGym fields beside GA/RL."""

    name = "gp_bo"

    def __init__(self, warmup: int = 6, pool: int = 96,
                 length_scale: float = 0.5, noise: float = 1e-6) -> None:
        self.warmup = warmup
        self.pool = pool
        self.length_scale = length_scale
        self.noise = noise

    def reset(self, space: ConfigSpace, rng: random.Random) -> None:
        super().reset(space, rng)
        self.X: list[np.ndarray] = []
        self.y: list[float] = []
        self.telled: list[tuple[float, FabricConfig]] = []

    def ask(self) -> FabricConfig:
        seeds = self._seeds()
        if self._n < len(seeds):
            return seeds[self._n]
        if len(self.y) < self.warmup:
            return self.space.sample(self.rng)
        cands = [self.space.sample(self.rng) for _ in range(self.pool // 2)]
        top = sorted(self.telled, key=lambda p: -p[0])[:4]
        for _ in range(self.pool - len(cands)):
            _, base = top[self.rng.randrange(len(top))]
            cands.append(self.space.mutate(base, self.rng))
        ei = self._expected_improvement(
            np.stack([self.space.encode(c) for c in cands]))
        return cands[int(np.argmax(ei))]

    def tell(self, config: FabricConfig, reward: float) -> None:
        super().tell(config, reward)
        self.X.append(self.space.encode(config))
        self.y.append(reward)
        self.telled.append((reward, config))

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        sq = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * sq / self.length_scale ** 2)

    def _expected_improvement(self, Xc: np.ndarray) -> np.ndarray:
        X = np.stack(self.X)
        y = np.asarray(self.y)
        mu0, sd0 = y.mean(), max(y.std(), 1e-12)
        z = (y - mu0) / sd0
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        alpha = np.linalg.solve(K, z)
        Ks = self._kernel(Xc, X)
        mu = Ks @ alpha
        v = np.linalg.solve(K, Ks.T)
        var = np.clip(1.0 - np.einsum("ij,ji->i", Ks, v), 1e-12, None)
        sd = np.sqrt(var)
        best = z.max()
        imp = mu - best
        zz = imp / sd
        # N(0,1) pdf/cdf without scipy
        pdf = np.exp(-0.5 * zz ** 2) / np.sqrt(2 * np.pi)
        cdf = 0.5 * (1.0 + _erf(zz / np.sqrt(2.0)))
        return imp * cdf + sd * pdf


def _erf(x: np.ndarray) -> np.ndarray:
    """Vectorized erf (Abramowitz-Stegun 7.1.26, |err| < 1.5e-7) — keeps
    the GP loop scipy-free."""
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * np.exp(-x * x))


AGENTS = {"random_walk": RandomWalkAgent, "genetic": GeneticAgent,
          "gp_bo": GpBoAgent}


# ---------------------------------------------------------------------------
# search driver + packet-oracle finalist re-score
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchResult:
    workload: str
    agent: str
    seed: int
    steps: int
    trajectory: list[dict]        # per step: objective, best-so-far, config
    best_config: FabricConfig
    best_objective_s: float
    wall_s: float

    def summary(self) -> dict:
        """The compact trajectory record ``best_configs.json`` carries —
        enough to reconstruct the search curve, not the whole history."""
        return {"agent": self.agent, "seed": self.seed, "steps": self.steps,
                "best_objective_ms": self.best_objective_s * 1e3,
                "wall_s": round(self.wall_s, 3),
                "best_objective_ms_per_step": [
                    round(t["best_objective_s"] * 1e3, 6)
                    for t in self.trajectory]}


def search(env: FabricEnv, agent: SearchAgent, *, steps: int,
           seed: int = 0) -> SearchResult:
    """Run ``agent`` against ``env`` for ``steps`` evaluations.  Fully
    deterministic in ``seed``: the agent's only entropy source is the
    ``random.Random(seed)`` stream, and the env is a pure function of the
    config — same seed, bitwise-same trajectory and winner."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    t0 = time.perf_counter()
    agent.reset(env.space, random.Random(seed))
    env.reset(seed)
    trajectory: list[dict] = []
    best_cfg, best_obj = None, np.inf
    for i in range(steps):
        cfg = agent.ask()
        _, reward, _, info = env.step(cfg)
        agent.tell(cfg, reward)
        obj = info["report"].objective_s
        if obj < best_obj:
            best_obj, best_cfg = obj, cfg
        trajectory.append({"step": i, "objective_s": obj,
                           "best_objective_s": best_obj,
                           "config": cfg.to_jsonable()})
    return SearchResult(workload=env.spec.name, agent=agent.name, seed=seed,
                        steps=steps, trajectory=trajectory,
                        best_config=best_cfg, best_objective_s=best_obj,
                        wall_s=time.perf_counter() - t0)


def finalists(results: SearchResult | Sequence[SearchResult],
              k: int = 3) -> list[FabricConfig]:
    """The ``k`` best *distinct* configs across one or more searches'
    trajectories, by fluid objective — the candidates worth the packet
    oracle's time."""
    if isinstance(results, SearchResult):
        results = [results]
    seen: dict[str, tuple[float, FabricConfig]] = {}
    for res in results:
        for t in res.trajectory:
            cfg = FabricConfig.from_jsonable(t["config"])
            key = json.dumps(cfg.to_jsonable(), sort_keys=True)
            if key not in seen or t["objective_s"] < seen[key][0]:
                seen[key] = (t["objective_s"], cfg)
    ranked = sorted(seen.values(), key=lambda p: p[0])
    return [cfg for _, cfg in ranked[:k]]


def rescore(env: FabricEnv, configs: Sequence[FabricConfig], *,
            fidelity: str = "packet") -> list[ScoreReport]:
    """Price ``configs`` on ``fidelity`` (default: the packet oracle) —
    the verification half of the fluid-inner-loop discipline."""
    return [env.score(c, fidelity=fidelity) for c in configs]


# ---------------------------------------------------------------------------
# best_configs.json — the pinned artifact trainer/cluster load by default
# ---------------------------------------------------------------------------

def best_configs_path(path: str | None = None) -> str | None:
    """Resolve the artifact path: explicit arg > ``$BEST_CONFIGS`` (the
    values ``""``/``"0"`` disable loading entirely) > ``./best_configs.json``
    in the current working directory."""
    if path is not None:
        return path
    env = os.environ.get(BEST_CONFIGS_ENV)
    if env is not None:
        return env if env not in ("", "0") else None
    return os.path.join(os.getcwd(), BEST_CONFIGS_FILE)


def save_best_configs(entries: Mapping[str, Mapping], *,
                      path: str | None = None) -> str:
    """Write the artifact.  ``entries`` maps workload name -> a jsonable
    record whose ``"config"`` key is a ``FabricConfig.to_jsonable`` dict
    (the loader ignores everything else, so searches are free to attach
    scores and trajectory summaries).  Deterministic output: sorted keys,
    no timestamps — the same search seed writes the same bytes."""
    out = best_configs_path(path)
    if out is None:
        raise ValueError("best-config saving disabled "
                         f"(${BEST_CONFIGS_ENV} is {os.environ.get(BEST_CONFIGS_ENV)!r})")
    payload = {"version": 1, "workloads": dict(entries)}
    with open(out, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


def load_best_configs(path: str | None = None) -> dict:
    """Read the artifact; a missing, disabled, or unparsable file returns
    ``{}`` (the legacy-defaults escape hatch must never crash a consumer
    that merely *might* have tuned configs)."""
    p = best_configs_path(path)
    if p is None or not os.path.exists(p):
        return {}
    try:
        with open(p) as f:
            data = json.load(f)
        return dict(data.get("workloads", {}))
    except (json.JSONDecodeError, OSError, AttributeError):
        return {}


def tuned_config(workload: str, path: str | None = None)\
        -> FabricConfig | None:
    """The pinned winning ``FabricConfig`` for ``workload``, or ``None``
    when no artifact (or no such workload entry) exists."""
    entry = load_best_configs(path).get(workload)
    if not entry or "config" not in entry:
        return None
    try:
        return FabricConfig.from_jsonable(entry["config"])
    except (KeyError, TypeError, ValueError):
        return None


def tuned_knob(workload: str, knob: str, default=None,
               path: str | None = None):
    """One knob of the pinned config (e.g. ``("train", "bucket_mb")``),
    falling back to ``default`` when nothing is pinned."""
    cfg = tuned_config(workload, path)
    if cfg is None:
        return default
    return getattr(cfg, knob, default)
