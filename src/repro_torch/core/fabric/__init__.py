"""``repro_torch.core.fabric`` — the collective fabric layer (host side).

    lower(collective, Torus, axes)  ->  CollectiveSchedule
        cost.*      predicted completion time (apelink.NetModel pricing;
                    ``backend="analytic"`` closed-form or ``"sim"``)
        fault.*     schedule rewritten around a LO|FA|MO fault map
        sim.*       event-driven link-level timeline (``FabricSim``):
                    per-link-direction FIFOs + credit flow control; the
                    shared clock RDMA endpoints and the serving cluster
                    inject concurrent flows into, so traffic contends
        qos.*       traffic classes and their arbitration policy
        fluid.*     the flow-level tier (``FluidSim``, ``HybridSim``)
                    behind ``make_sim(..., fidelity=)``; its rate solver
                    runs on numpy or, with ``solver="torch"``, on the card
        telemetry.* counters, spans and the Perfetto export; the
                    process hub of the hot path's wall-clock spans
        qosctl.*    the closed-loop QoS controller
        autotune.*  the design-space search (``FabricEnv``, the agents,
                    ``search`` / ``rescore``) and ``best_configs.json``
        execute.*   the schedule as ``torch.distributed`` point-to-point
                    rounds over a ``Mesh`` (fused dual-DMA rounds)

Ports of the JAX package's modules of the same names; their timelines
are bit-identical to the reference, the executor's sums equal the
JAX executor's, and the autotuner's searches follow the reference's
trajectories bit for bit.
"""
from repro_torch.core.fabric.cost import (BACKENDS, CostEstimate,
                                          OverlapEstimate,
                                          algorithmic_bandwidth, estimate,
                                          estimate_overlapped,
                                          hostif_descriptors, message_time)
from repro_torch.core.fabric.fluid import (FIDELITIES, FluidSim, HybridSim,
                                           make_sim)
from repro_torch.core.fabric.execute import (execute, execute_all_gather,
                                             execute_all_reduce,
                                             execute_all_to_all,
                                             execute_halo_exchange,
                                             execute_reduce_scatter,
                                             make_bucket_grad_hook,
                                             ring_slot)
from repro_torch.core.fabric.fault import (UnroutableError,
                                           fault_map_from_lofamo, rewrite)
from repro_torch.core.fabric.lower import (axis_fault_penalty, live_ring,
                                           lower, lower_all_gather,
                                           lower_all_reduce, lower_all_to_all,
                                           lower_halo_exchange, lower_p2p,
                                           lower_reduce_scatter, lower_route,
                                           plan_buckets)
from repro_torch.core.fabric.qos import (DEFAULT_CREDIT_FRAC, DEFAULT_WEIGHTS,
                                         SINGLE_CLASS, QosPolicy,
                                         TrafficClass)
from repro_torch.core.fabric.qosctl import QosController, QosCtlPolicy
from repro_torch.core.fabric.schedule import (A2A, AG, AR, HALO, P2P, RS,
                                              Bucket, BucketPlan,
                                              CollectiveSchedule, FaultMap,
                                              Phase, Step, Transfer)
from repro_torch.core.fabric.sim import (FabricSim, FlowResult, best_route,
                                         candidate_routes, clear_route_cache,
                                         inject_schedule, simulate_schedule,
                                         stripe_counts, striped_routes)
from repro_torch.core.fabric.telemetry import (Telemetry, canon_key,
                                               ordered_link_items,
                                               process_hub,
                                               validate_perfetto)
# autotune references this package lazily (``from repro_torch.core import
# fabric``), so it must come after every name it may resolve at call time
from repro_torch.core.fabric.autotune import (AGENTS, ConfigSpace,
                                              FabricConfig, FabricEnv,
                                              GeneticAgent, GpBoAgent,
                                              RandomWalkAgent, ReplaySpec,
                                              ScoreReport, SearchResult,
                                              finalists, load_best_configs,
                                              rescore, save_best_configs,
                                              search, serving_replay,
                                              torus_shapes, training_replay,
                                              tuned_config, tuned_knob)

__all__ = [
    "A2A", "AG", "AR", "HALO", "P2P", "RS",
    "Bucket", "BucketPlan", "CollectiveSchedule", "FaultMap", "Phase",
    "Step", "Transfer",
    "execute", "execute_all_gather", "execute_all_reduce",
    "execute_all_to_all", "execute_halo_exchange", "execute_reduce_scatter",
    "make_bucket_grad_hook", "ring_slot",
    "BACKENDS", "CostEstimate", "OverlapEstimate", "algorithmic_bandwidth",
    "estimate", "estimate_overlapped", "hostif_descriptors", "message_time",
    "UnroutableError", "fault_map_from_lofamo", "rewrite",
    "axis_fault_penalty", "live_ring", "lower", "lower_all_gather",
    "lower_all_reduce", "lower_all_to_all", "lower_halo_exchange",
    "lower_p2p", "lower_reduce_scatter", "lower_route", "plan_buckets",
    "FabricSim", "FlowResult", "best_route", "candidate_routes",
    "clear_route_cache", "inject_schedule", "simulate_schedule",
    "stripe_counts", "striped_routes",
    "FIDELITIES", "FluidSim", "HybridSim", "make_sim",
    "Telemetry", "canon_key", "ordered_link_items", "process_hub",
    "validate_perfetto",
    "DEFAULT_CREDIT_FRAC", "DEFAULT_WEIGHTS", "SINGLE_CLASS", "QosPolicy",
    "QosController", "QosCtlPolicy", "TrafficClass",
    "AGENTS", "ConfigSpace", "FabricConfig", "FabricEnv", "GeneticAgent",
    "GpBoAgent", "RandomWalkAgent", "ReplaySpec", "ScoreReport",
    "SearchResult", "finalists", "load_best_configs", "rescore",
    "save_best_configs", "search", "serving_replay", "torus_shapes",
    "training_replay", "tuned_config", "tuned_knob",
]
