"""``repro_torch.core.fabric`` — the collective fabric layer (host side).

    lower(collective, Torus, axes)  ->  CollectiveSchedule
        cost.*      predicted completion time (apelink.NetModel pricing,
                    ``backend="analytic"``)
        fault.*     schedule rewritten around a LO|FA|MO fault map
        qos.*       traffic classes and their arbitration policy

Copies of the JAX package's modules of the same names.  The executor
(``execute``), the simulators (``sim``, ``fluid``), telemetry, the QoS
controller and the autotuner are not ported yet; ``estimate(...,
backend="sim")`` raises until they are.
"""
from repro_torch.core.fabric.cost import (BACKENDS, CostEstimate,
                                          OverlapEstimate,
                                          algorithmic_bandwidth, estimate,
                                          estimate_overlapped,
                                          hostif_descriptors, message_time)
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
from repro_torch.core.fabric.schedule import (A2A, AG, AR, HALO, P2P, RS,
                                              Bucket, BucketPlan,
                                              CollectiveSchedule, FaultMap,
                                              Phase, Step, Transfer)

__all__ = [
    "A2A", "AG", "AR", "HALO", "P2P", "RS",
    "Bucket", "BucketPlan", "CollectiveSchedule", "FaultMap", "Phase",
    "Step", "Transfer",
    "BACKENDS", "CostEstimate", "OverlapEstimate", "algorithmic_bandwidth",
    "estimate", "estimate_overlapped", "hostif_descriptors", "message_time",
    "UnroutableError", "fault_map_from_lofamo", "rewrite",
    "axis_fault_penalty", "live_ring", "lower", "lower_all_gather",
    "lower_all_reduce", "lower_all_to_all", "lower_halo_exchange",
    "lower_p2p", "lower_reduce_scatter", "lower_route", "plan_buckets",
    "DEFAULT_CREDIT_FRAC", "DEFAULT_WEIGHTS", "SINGLE_CLASS", "QosPolicy",
    "TrafficClass",
]
