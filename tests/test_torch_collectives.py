"""The port's collective executor, collectives and device RDMA primitives on
8 gloo ranks vs the JAX package's executor (8 forced host devices) and the
numpy oracle.

One module fixture runs ``tests/torch_dist_checks.py``: the JAX reference
in one subprocess, the port's 8 ranks in 8 more (a ``file://`` store in a
temporary directory, so xdist workers never share a port), all side by
side; the tests compare what they wrote.  Inputs come from numpy seeds.
Against JAX the Gaussian inputs are held to rtol 1e-6 (the port sums in
the schedule's order, as JAX does); against the numpy oracle the
integer-valued inputs are, whose sums are exact in fp32 in any order.
"""
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as tdc  # noqa: E402

RTOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("collectives"))
    tdc.launch("collectives", out, timeout=300)
    ranks = [dict(np.load(os.path.join(out, f"rank{r}_collectives.npz")))
             for r in range(8)]
    rounds = [json.load(open(os.path.join(out, f"rank{r}_rounds.json")))
              for r in range(8)]
    jax = dict(np.load(os.path.join(out, "jax_collectives.npz")))
    return ranks, rounds, jax


def port(runs, key, shape=None):
    """Every rank's output of ``key``, stacked in mesh (= rank) order and
    laid out as the mesh when ``shape`` is given."""
    out = np.stack([r[key] for r in runs[0]])
    return out if shape is None else out.reshape(shape + out.shape[1:])


def close(got, want, **kw):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, **kw)


@pytest.mark.parametrize("bidi", [1, 0])
@pytest.mark.parametrize("tag", list(tdc.MESHES))
def test_all_reduce_matches_jax_and_oracle(runs, tag, bidi):
    shape, _ = tdc.MESHES[tag]
    lead = tuple(range(len(shape)))
    close(port(runs, f"g/{tag}/ar/{bidi}", shape), runs[2][f"{tag}/ar/{bidi}"])
    x = tdc.inputs(tag)["i_ar"]
    close(port(runs, f"i/{tag}/ar/{bidi}", shape),
          np.broadcast_to(x.sum(lead), x.shape))
    # the per-rank wrapper runs the same schedule
    np.testing.assert_array_equal(port(runs, f"g/{tag}/ar_wrap/{bidi}"),
                                  port(runs, f"g/{tag}/ar/{bidi}"))


@pytest.mark.parametrize("tag", list(tdc.MESHES))
def test_rs_ag_round_trip(runs, tag):
    shape, _ = tdc.MESHES[tag]
    close(port(runs, f"g/{tag}/rsag", shape), runs[2][f"{tag}/rsag"])
    x = tdc.inputs(tag)["i_rsag"]
    close(port(runs, f"i/{tag}/rsag", shape),
          np.broadcast_to(x.sum(tuple(range(len(shape)))), x.shape))


@pytest.mark.parametrize("tag", list(tdc.MESHES))
def test_tree_all_reduce_is_the_mean(runs, tag):
    shape, _ = tdc.MESHES[tag]
    x = tdc.inputs(tag)["i_ar"]
    lead = tuple(range(len(shape)))
    close(port(runs, f"i/{tag}/tree", shape),
          np.broadcast_to(x.sum(lead) / np.float32(8), x.shape))


def test_reduce_scatter_slot_owns_contiguous_chunk(runs):
    close(port(runs, "g/1d/own"), runs[2]["1d/own"])
    x = tdc.inputs("1d")["i_own"]
    close(port(runs, "i/1d/own"), x.sum(0).reshape(8, 8))


def test_all_to_all_is_the_transpose(runs):
    close(port(runs, "g/1d/a2a"), runs[2]["1d/a2a"])
    x = tdc.inputs("1d")["i_a2a"]
    np.testing.assert_array_equal(port(runs, "i/1d/a2a"),
                                  x.transpose(1, 0, 2))


def test_halo_exchange_gets_both_neighbours(runs):
    close(port(runs, "g/1d/halo"), runs[2]["1d/halo"])
    x = tdc.inputs("1d")["i_halo"]
    out = port(runs, "i/1d/halo")
    for r in range(8):
        np.testing.assert_array_equal(out[r, 0], x[(r - 1) % 8][-2:])
        np.testing.assert_array_equal(out[r, 1], x[(r + 1) % 8][:2])


def test_detoured_dead_link_changes_nothing(runs):
    np.testing.assert_array_equal(port(runs, "g/1d/detour"),
                                  port(runs, "g/1d/clean"))
    close(port(runs, "g/1d/detour"), runs[2]["1d/detour"])
    assert int(runs[2]["detour_max_hops"]) == 7


def test_dead_node_shrinks_the_ring_to_live_contributions(runs):
    live = [r for r in range(8) if r != tdc.DEAD_NODE]
    x = tdc.inputs("1d")["i_fault"]
    out = port(runs, "i/1d/shrunk")
    for r in live:
        close(out[r], x[live].sum(0))
    close(port(runs, "g/1d/shrunk")[live], runs[2]["1d/shrunk"][live])


def test_shrunk_ring_mean_divides_by_the_live_count(runs):
    live = [r for r in range(8) if r != tdc.DEAD_NODE]
    x = tdc.inputs("1d")["i_fault"]
    out = port(runs, "i/1d/shrunk_mean")
    for r in live:
        close(out[r], x[live].sum(0) / np.float32(7))
    close(port(runs, "g/1d/shrunk_mean")[live],
          runs[2]["1d/shrunk_mean"][live])


@pytest.mark.parametrize("step", tdc.SHIFTS)
def test_put_shift_is_a_roll(runs, step):
    x = tdc.inputs("1d")["i_shift"]
    np.testing.assert_array_equal(port(runs, f"i/1d/shift/{step}"),
                                  np.roll(x, step, axis=0))
    np.testing.assert_array_equal(port(runs, f"g/1d/shift/{step}"),
                                  runs[2][f"1d/shift/{step}"])


def test_put_coords_is_a_dimension_ordered_roll(runs):
    shape, _ = tdc.MESHES["3d"]
    x = tdc.inputs("3d")["g_ar"]
    got = port(runs, "g/3d/coords", shape)
    np.testing.assert_array_equal(got, np.roll(x, (1, -1), axis=(0, 2)))
    np.testing.assert_array_equal(got, runs[2]["3d/coords"])


def test_send_recv_writes_only_the_addressed_ranks(runs):
    x = tdc.inputs("1d")["i_shift"]
    want = np.zeros_like(x)
    for s, d in [(0, 5), (5, 0), (2, 3)]:
        want[d] = x[s]
    np.testing.assert_array_equal(port(runs, "i/1d/send_recv"), want)


@pytest.mark.parametrize("bidi", ["1", "0"])
def test_each_step_is_one_batch_with_both_directions(runs, bidi):
    """Dual DMA: a bidirectional round sends to and receives from both
    ring neighbours in one ``batch_isend_irecv``; a one-way round only
    forward."""
    for r, rounds in enumerate(runs[1]):
        got = rounds[bidi]
        assert got["steps"] == 7
        assert len(got["batches"]) == got["steps"]
        nxt, prev = (r + 1) % 8, (r - 1) % 8
        want = ([["irecv", prev], ["isend", nxt]] if bidi == "0" else
                sorted([["irecv", prev], ["irecv", nxt], ["isend", nxt],
                        ["isend", prev]]))
        assert all(sorted(b) == sorted(want) for b in got["batches"]), got


@pytest.mark.parametrize("tag", ["1d", "2d"])
def test_bucket_hook_equals_sequential_reduce_scatter_bitwise(runs, tag):
    for i in range(len(tdc.BUCKET_SHAPES)):
        np.testing.assert_array_equal(port(runs, f"g/{tag}/bucket/{i}"),
                                      port(runs, f"g/{tag}/bucket_seq/{i}"))
