"""The fabric autotuner's pinned-config reader.

The JAX package's ``fabric/autotune.py`` searches the fabric's design
space (torus shape, per-class ``QosPolicy`` weights and credit
fractions, bucket size, stripe count, route policy, the QoS
controller's gains) on the fluid tier, re-scores finalists on the packet
oracle, and pins the winners as ``best_configs.json``.  This module
carries the half that consumers need: ``FabricConfig`` and the reader
that ``ServingCluster(qos="auto")``, ``migrate(route_policy=None)`` and
``QosCtlPolicy.tuned`` call.  An explicit argument always wins, and a
missing file keeps the legacy defaults.  Set ``BEST_CONFIGS=<path>`` to
point elsewhere or ``BEST_CONFIGS=0`` to disable loading.

The search itself (``ConfigSpace``, ``FabricEnv``, the agents, ``search``
/ ``finalists`` / ``rescore`` and ``save_best_configs``) is not ported
yet (ROADMAP §1, item 10); an artifact written by the JAX package's
search reads the same here.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping

from repro_torch.core.fabric.qos import QosPolicy, TrafficClass

#: env var naming the best-config artifact ("0"/"" disables loading)
BEST_CONFIGS_ENV = "BEST_CONFIGS"
BEST_CONFIGS_FILE = "best_configs.json"

_CLASSES = tuple(TrafficClass)


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
        # controller knobs arrived a PR later than the rest: artifacts
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


# ---------------------------------------------------------------------------
# best_configs.json — the pinned artifact the cluster loads by default
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
