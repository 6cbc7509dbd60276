"""Host-side fabric model of the PyTorch port vs the JAX package.

Schedules, cost estimates, fault rewrites, bucket plans, TLB and RDMA
endpoint costs are deterministic host code in both packages, so they must
agree exactly: equal schedules (compared by their dataclass reprs, which
name no module) and bit-identical floats.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import apelink as japelink  # noqa: E402
from repro.core import fabric as jfab  # noqa: E402
from repro.core import rdma as jrdma  # noqa: E402
from repro.core import tlb as jtlb  # noqa: E402
from repro.core.topology import Torus as JTorus  # noqa: E402
from repro_torch.core import apelink as tapelink  # noqa: E402
from repro_torch.core import fabric as tfab  # noqa: E402
from repro_torch.core import rdma as trdma  # noqa: E402
from repro_torch.core import tlb as ttlb  # noqa: E402
from repro_torch.core.topology import Torus as TTorus  # noqa: E402

torch.set_num_threads(1)

TORI = [((8,), ("x",)), ((4, 4), ("x", "y")), ((4, 2, 4), ("x", "y", "z")),
        ((3, 5), ("x", "y"))]


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("dims,axes", TORI)
def test_all_reduce_schedule_and_cost_identical(dims, axes, bidirectional):
    js = jfab.lower_all_reduce(JTorus(dims), axes,
                               bidirectional=bidirectional)
    ts = tfab.lower_all_reduce(TTorus(dims), axes,
                               bidirectional=bidirectional)
    assert repr(ts) == repr(js)
    for nbytes in (0, 4096, 7 * 896 * 2, 1 << 22):
        je = jfab.estimate(js, nbytes, japelink.NetModel())
        te = tfab.estimate(ts, nbytes, tapelink.NetModel())
        assert te.total_s == je.total_s
        assert te.phase_s == je.phase_s
        assert (te.rounds, te.bytes_per_rank, te.max_hops) == \
            (je.rounds, je.bytes_per_rank, je.max_hops)


@pytest.mark.parametrize("lower", ["lower_reduce_scatter",
                                   "lower_all_gather"])
@pytest.mark.parametrize("dims,axes", TORI[1:3])
def test_rs_ag_schedules_identical(lower, dims, axes):
    js = getattr(jfab, lower)(JTorus(dims), axes)
    ts = getattr(tfab, lower)(TTorus(dims), axes)
    assert repr(ts) == repr(js)


@pytest.mark.parametrize("dims,pairs", [((8,), [(0, 5), (3, 3)]),
                                        ((4, 4), [(0, 15), (5, 10)]),
                                        ((4, 2, 4), [(0, 31), (7, 20)])])
def test_p2p_schedules_and_costs_identical(dims, pairs):
    for src, dst in pairs:
        js = jfab.lower_p2p(JTorus(dims), src, dst)
        ts = tfab.lower_p2p(TTorus(dims), src, dst)
        assert repr(ts) == repr(js)
        assert tfab.estimate(ts, 1 << 16).total_s == \
            jfab.estimate(js, 1 << 16).total_s


@pytest.mark.parametrize("nodes,links", [((), [(0, 1)]), ((5,), []),
                                         ((2,), [(4, 8), (9, 10)])])
def test_fault_rewrite_identical(nodes, links):
    dims, axes = (4, 4), ("x", "y")
    jf = jfab.FaultMap.normalized(nodes, links)
    tf = tfab.FaultMap.normalized(nodes, links)
    js = jfab.rewrite(jfab.lower_all_reduce(JTorus(dims), axes), jf)
    ts = tfab.rewrite(tfab.lower_all_reduce(TTorus(dims), axes), tf)
    assert repr(ts) == repr(js)
    assert tfab.estimate(ts, 1 << 20).total_s == \
        jfab.estimate(js, 1 << 20).total_s
    jp = jfab.rewrite(jfab.lower_p2p(JTorus(dims), 0, 10), jf)
    tp = tfab.rewrite(tfab.lower_p2p(TTorus(dims), 0, 10), tf)
    assert repr(tp) == repr(jp)


def test_partitioned_fabric_is_unroutable_in_both():
    links = [(0, 1), (0, 3), (0, 4), (0, 12)]          # isolate rank 0
    with pytest.raises(jfab.UnroutableError):
        jfab.lower_p2p(JTorus((4, 4)), 0, 5,
                       faults=jfab.FaultMap.normalized((), links))
    with pytest.raises(tfab.UnroutableError):
        tfab.lower_p2p(TTorus((4, 4)), 0, 5,
                       faults=tfab.FaultMap.normalized((), links))


def test_sim_backend_waits_for_the_simulator_slice():
    """The simulator slice has landed (the sim backend raised before it):
    ``backend="sim"`` now prices the schedule on the port's own
    simulators, equal to the JAX package's on every tier."""
    js = jfab.lower_all_reduce(JTorus((4, 4)), ("x", "y"))
    ts = tfab.lower_all_reduce(TTorus((4, 4)), ("x", "y"))
    for fidelity in ("packet", "fluid", "hybrid"):
        jfab.clear_route_cache()
        tfab.clear_route_cache()
        je = jfab.estimate(js, 1024, backend="sim", fidelity=fidelity)
        te = tfab.estimate(ts, 1024, backend="sim", fidelity=fidelity)
        assert repr(te) == repr(je)
        assert te.total_s > 0.0


def test_bucket_plans_identical():
    """The port sizes leaves with torch's pytree; dict keys must still be
    walked in JAX's (sorted) order."""
    tree = {"w": np.zeros((64, 32)), "b": np.zeros((32,)),
            "layers": [{"z": np.zeros((8, 8)), "a": np.zeros((128,))},
                       {"z": np.zeros((16,)), "a": np.zeros((4, 4))}]}
    for bucket in (256, 1024, 8192):
        for reverse in (True, False):
            jp = jfab.plan_buckets(tree, bucket, reverse=reverse)
            tp = tfab.plan_buckets(tree, bucket, reverse=reverse)
            assert repr(tp) == repr(jp)
    assert repr(tfab.plan_buckets([3, 100, 7], 64)) == \
        repr(jfab.plan_buckets([3, 100, 7], 64))


def test_tlb_translation_costs_identical():
    rng = np.random.default_rng(0)
    jt, tt = jtlb.Tlb(entries=64), ttlb.Tlb(entries=64)
    for vaddr in rng.integers(0, 1 << 26, size=2000):
        assert tt.translate(int(vaddr)) == jt.translate(int(vaddr))
    assert (tt.stats.hits, tt.stats.misses) == (jt.stats.hits,
                                                jt.stats.misses)


def test_rdma_endpoint_costs_identical():
    je = jrdma.RdmaEndpoint(JTorus((4, 4)), rank=5)
    te = trdma.RdmaEndpoint(TTorus((4, 4)), rank=5)
    for nbytes in (0, 100, 1 << 16, 3 * (1 << 20) + 7):
        jr, tr = je.register(nbytes), te.register(nbytes)
        assert (tr.handle, tr.vaddr, tr.nbytes) == \
            (jr.handle, jr.vaddr, jr.nbytes)
        assert te.translate_region(tr) == je.translate_region(jr)
        assert te.translate_region(tr) == je.translate_region(jr)  # hot
        assert te.transfer_time(nbytes) == je.transfer_time(nbytes)
        assert te.transfer_time(nbytes, engines=1) == \
            je.transfer_time(nbytes, engines=1)
        assert te.put_time(10, nbytes, tr) == je.put_time(10, nbytes, jr)
    assert te.queue_depth == je.queue_depth
    te.deregister(tr)
    with pytest.raises(KeyError):
        te.translate_region(tr)
