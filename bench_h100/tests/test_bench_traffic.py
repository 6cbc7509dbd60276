"""The traffic generator: lengths taken at the midpoints of equal slices
of the mix's distribution, so that every block of every seed sends the
same lengths, in an order and with tokens the seed draws; the in-flight
requests' answers staggered."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import SEED
from benchkit import manifest
from benchkit.traffic import Requests, length


def _lengths(t, seed, ks):
    r = Requests(t, seed, 100)
    return np.array([r.lengths(k) for k in ks])


@pytest.mark.parametrize("cell", ["deepseek7b-decode-chat",
                                  "olmoe-prefill-code"])
def test_lengths_follow_the_mixs_medians_and_clips(cell):
    t = manifest.cell(cell).traffic
    n = t["clients"]
    L = _lengths(t, SEED, range(n, n * 41))
    for col, key in ((0, "prompt"), (1, "output")):
        lo, hi = t[f"{key}_tokens"]
        median = t[f"{key}_lognormal"][0]
        assert lo <= L[:, col].min() and L[:, col].max() <= hi
        assert abs(np.median(L[:, col]) - median) <= 0.03 * median + 1
        assert np.percentile(L[:, col], 95) > 2 * median   # a heavy tail


SEEDS = [SEED, SEED + 1, 7, 2**40 + 3]


@pytest.mark.parametrize("cell", ["deepseek7b-decode-chat",
                                  "olmoe-prefill-code"])
def test_every_block_of_every_seed_sends_one_multiset_of_lengths(cell):
    """Each slice drawn at its midpoint: the blocks after the first (whose
    answers are cut to stagger) hold the same prompt and answer lengths,
    whatever the seed; the first block the same prompts."""
    t = manifest.cell(cell).traffic
    n = t["clients"]
    want = None
    for seed in SEEDS:
        L = _lengths(t, seed, range(n * 12)).reshape(12, n, 2)
        blocks = np.sort(L, axis=1)
        want = blocks[1] if want is None else want
        assert (blocks[1:] == want).all()
        assert (blocks[0, :, 0] == want[:, 0]).all()


def test_seeds_send_one_mix_in_another_order():
    t = manifest.cell("deepseek7b-decode-chat").traffic
    n = t["clients"]
    a = _lengths(t, SEED, range(n, n * 9))
    b = _lengths(t, SEED + 1, range(n, n * 9))
    assert (a != b).any(axis=1).mean() > 0.9            # another order
    assert (a == _lengths(t, SEED, range(n, n * 9))).all()
    assert (np.sort(a, 0) == np.sort(b, 0)).all()        # the same lengths
    # prompts and answers ordered each on their own
    assert (np.argsort(a[:n, 0], kind="stable")
            != np.argsort(a[:n, 1], kind="stable")).any()
    # every block holds one draw from each slice of the distribution, at
    # the slice's midpoint
    q = np.sort(np.array([Requests(t, s, 100)._quantiles(3)[1]
                          for s in (SEED, SEED + 1)]), axis=1)
    assert (q == (np.arange(n) + 0.5) / n).all()
    # the same lengths in other tokens
    ra, rb = Requests(t, SEED, 50000), Requests(t, SEED + 1, 50000)
    for k in range(n, n + 8):
        pa, pb = ra(k)[1], rb(k)[1]
        m = min(len(pa), len(pb))
        assert (pa[:m] != pb[:m]).mean() > 0.9


def test_in_flight_answers_are_staggered():
    t = dict(clients=4, prompt_tokens=[16, 48], output_tokens=[40, 40])
    assert [a for _, a in _lengths(t, SEED, range(6))] == [10, 20, 30, 40,
                                                           40, 40]


def test_uniform_without_a_distribution():
    assert length(0.0, [16, 48]) == 16
    assert length(0.999999, [16, 48]) == 48
    assert length(0.5, [1, 100000], [1500, 0.6]) == 1500
