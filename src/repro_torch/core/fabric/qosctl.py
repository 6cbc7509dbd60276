"""Closed-loop QoS controller — the SLO feedback loop over ``QosPolicy``.

The autotuner picks one static weight vector per workload; under the
overload traces that vector is wrong twice over.  While decode's p99 is
comfortably inside the SLO the fabric still gives DECODE its full 27:1
arbitration share, starving the BULK migrations that would *relieve* the
hotspot; and once the p99 has breached, decode is queue-bound — no
arbitration weight can buy tokens a saturated replica isn't producing,
yet the static policy keeps paying for one.  APEnet+'s §2.1 host
interface exposes per-class prefetchable command queues precisely so
priorities can change *while work is in flight* (arXiv:1311.1741); the
follow-up TX-path work (arXiv:2201.01088) makes the same argument for
congestion-reactive injection.  This module is that reactivity at the
fabric-policy level: once per replay window the controller reads the
measured per-token p99 and the per-class byte deltas
(``FabricSim.class_stats(since=...)``) and retunes the live policy
through ``sim.set_qos`` — a damped multiplicative rule bounded by
per-class floors.

Control law (``QosController.window``), acting on a single scalar
``boost`` — the DECODE weight multiplier over the static baseline:

* **safe** (p99 < target * headroom): decode has latency headroom to
  give back — decay ``boost`` toward the relief ``floor`` so BULK
  drains faster (``boost *= decay``, clamped at ``floor``).
* **at-risk** (target * headroom <= p99 < target): the pre-breach band
  the proactive rebalancer also acts in — multiplicative increase
  (``boost *= gain``, capped at ``max_boost``), but only when the
  window actually moved DECODE bytes: a replica that is compute- or
  queue-bound gains nothing from more arbitration share.
* **breached** (p99 >= target): boosting cannot help — release toward
  the ``floor`` so migrations get the bandwidth to drain the hotspot.

The controller is **latched quiescent**: until the first at-risk or
breached window it never calls ``set_qos`` at all, so a no-overload
replay with the controller attached is *bitwise identical* to one
without it (the quiescence gate in ``benchmarks/qosctl.py``).  Credit
fractions mirror the weight move with a damped exponent
(``boost ** credit_gain``) so a boosted class also gets buffer landing
room, floored at ``min_credit_frac`` per class — ``partition_credits``
renormalizes, so fractions are relative shares.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.fabric.qos import QosPolicy, TrafficClass


@dataclasses.dataclass(frozen=True)
class QosCtlPolicy:
    """The controller's gains and floors (the autotuner's search knobs).

    ``gain``/``decay`` are the per-window multiplicative step sizes of
    the boost (up in the at-risk band, down otherwise); ``max_boost`` /
    ``floor`` bound it above and below as multiples of the baseline
    DECODE weight; ``credit_gain`` damps how much of the weight move the
    credit partition mirrors; ``min_credit_frac`` is the per-class
    credit floor no retune may cross."""

    gain: float = 1.6          # at-risk multiplicative increase
    decay: float = 0.6         # safe/breached release multiplier
    max_boost: float = 4.0     # cap, x baseline DECODE weight
    floor: float = 0.25        # relief floor, x baseline DECODE weight
    credit_gain: float = 0.5   # credit shift = boost ** credit_gain
    min_credit_frac: float = 0.05

    def __post_init__(self) -> None:
        if self.gain <= 1.0:
            raise ValueError(f"gain must be > 1, got {self.gain}")
        if not 0.0 < self.decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {self.decay}")
        if self.max_boost < 1.0:
            raise ValueError(
                f"max_boost must be >= 1, got {self.max_boost}")
        if not 0.0 < self.floor <= 1.0:
            raise ValueError(f"floor must be in (0, 1], got {self.floor}")
        if not 0.0 <= self.credit_gain <= 1.0:
            raise ValueError(
                f"credit_gain must be in [0, 1], got {self.credit_gain}")
        if not 0.0 < self.min_credit_frac < 0.25:
            raise ValueError("min_credit_frac must be in (0, 0.25), "
                             f"got {self.min_credit_frac}")

    @classmethod
    def tuned(cls, workload: str = "serving") -> "QosCtlPolicy":
        """The pinned ``best_configs.json`` gains for ``workload`` when an
        artifact is loadable (same explicit-arg-wins / ``BEST_CONFIGS=0``
        escape hatch as every other tuned knob), else the defaults."""
        from repro_torch.core.fabric import autotune
        cfg = autotune.tuned_config(workload)
        if cfg is None:
            return cls()
        return cls(gain=cfg.ctl_gain, decay=cfg.ctl_decay,
                   floor=cfg.ctl_floor)


class QosController:
    """One control loop bound to a live sim's ``set_qos`` actuator.

    Construct with the *static* baseline policy (what the autotuner
    pinned) and the serving ``SloPolicy`` whose ``token_target_s`` /
    ``headroom`` define the bands; call :meth:`window` once per replay
    window with the per-token latency samples that window produced.
    ``policy=None`` loads :meth:`QosCtlPolicy.tuned`.
    """

    def __init__(self, base: QosPolicy, slo, *,
                 policy: QosCtlPolicy | None = None,
                 telemetry: "object | None" = None) -> None:
        if base.single_class:
            raise ValueError("closed-loop QoS needs a multi-class baseline "
                             "(single_class has no DECODE channel to boost)")
        self.base = base
        self.slo = slo
        self.policy = policy if policy is not None else QosCtlPolicy.tuned()
        self.boost = 1.0           # current DECODE multiplier
        self.engaged = False       # latched on first at-risk/breached window
        self.n_retunes = 0         # set_qos calls actually issued
        self._applied = 1.0        # boost the sim currently runs
        self._last_stats: dict | None = None
        self.history: list[tuple[str, float | None, float]] = []
        # optional Telemetry hub: one controller-track event per window
        # plus window/retune counters.  Pure reporting — None changes
        # nothing about the control law or its timeline.
        self.telemetry = telemetry

    # -- control step ---------------------------------------------------------
    def window(self, sim, tpt_samples) -> bool:
        """One control step; returns True when the actuator fired.

        ``tpt_samples`` are the per-token decode latencies of the
        requests that *finished inside this window* — the controller
        steers on the measured tail, not a prediction.  ``sim`` is any
        fabric tier exposing ``class_stats`` / ``set_qos``.
        """
        pol = self.policy
        stats = sim.class_stats()
        delta = (sim.class_stats(since=self._last_stats)
                 if self._last_stats is not None else dict(stats))
        self._last_stats = stats
        samples = [float(x) for x in tpt_samples]
        p99 = (float(np.percentile(np.asarray(samples, np.float64), 99))
               if samples else None)
        target = float(self.slo.token_target_s)
        edge = target * float(self.slo.headroom)
        if p99 is None:
            band = "idle"
        elif p99 >= target:
            band = "breached"
        elif p99 >= edge:
            band = "at-risk"
        else:
            band = "safe"
        new_boost = self.boost
        if band in ("at-risk", "breached"):
            self.engaged = True
        if band == "at-risk":
            if delta.get(TrafficClass.DECODE, 0.0) > 0.0:
                new_boost = min(self.boost * pol.gain, pol.max_boost)
            # at-risk but no DECODE bytes moved: the replica is compute/
            # queue-bound, arbitration share is not the lever — hold.
        elif self.engaged and band in ("breached", "safe"):
            new_boost = max(self.boost * pol.decay, pol.floor)
        self.history.append((band, p99, new_boost))
        self.boost = new_boost
        tel = self.telemetry
        if tel is not None:
            tel.add("qosctl.windows")
            tel.event(("controller",), band, float(sim.now),
                      p99_ms=-1.0 if p99 is None else p99 * 1e3,
                      boost=new_boost)
        if not self.engaged or abs(new_boost - self._applied) <= 1e-12:
            return False
        sim.set_qos(self.retuned())
        self._applied = new_boost
        self.n_retunes += 1
        if tel is not None:
            tel.add("qosctl.retunes")
            tel.event(("controller",), "retune", float(sim.now),
                      boost=new_boost)
        return True

    # -- policy lowering ------------------------------------------------------
    def retuned(self) -> QosPolicy:
        """The ``QosPolicy`` the current boost lowers to.

        Weights: baseline with DECODE scaled by ``boost``.  Credit
        fractions: DECODE's share scaled by ``boost ** credit_gain``,
        every class floored at ``min_credit_frac`` (fractions are
        relative — ``partition_credits`` renormalizes)."""
        pol = self.policy
        w = dict(self.base.weights)
        w[TrafficClass.DECODE] = w[TrafficClass.DECODE] * self.boost
        f = dict(self.base.credit_frac)
        f[TrafficClass.DECODE] = (f[TrafficClass.DECODE]
                                  * self.boost ** pol.credit_gain)
        total = sum(f.values())
        f = {c: max(v, pol.min_credit_frac * total)
             for c, v in f.items()}
        return QosPolicy(weights=w, credit_frac=f)

    def describe(self) -> str:
        last = self.history[-1] if self.history else ("idle", None, 1.0)
        p99 = "n/a" if last[1] is None else f"{last[1] * 1e3:.2f} ms"
        return (f"QosController(boost={self.boost:.3f}, "
                f"engaged={self.engaged}, retunes={self.n_retunes}, "
                f"last window: {last[0]}, p99 {p99})")
