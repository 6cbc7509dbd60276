"""The traffic generator: lengths drawn from the seed out of the mix's
distribution, stratified so that every stretch of the stream holds the
same mix, the in-flight requests' answers staggered."""
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


def test_seeds_draw_other_lengths_in_another_order_of_one_mix():
    t = manifest.cell("deepseek7b-decode-chat").traffic
    n = t["clients"]
    a = _lengths(t, SEED, range(n, n * 9))
    b = _lengths(t, SEED + 1, range(n, n * 9))
    assert (a != b).any(axis=1).mean() > 0.9
    assert (a == _lengths(t, SEED, range(n, n * 9))).all()
    # every block holds one draw from each slice of the distribution
    q = np.sort(np.array([Requests(t, s, 100)._quantiles(3)[1]
                          for s in (SEED, SEED + 1)]), axis=1)
    assert (np.floor(q * n) == np.arange(n)).all()
    assert abs(np.mean(a, 0) / np.mean(b, 0) - 1).max() < 0.05


def test_in_flight_answers_are_staggered():
    t = dict(clients=4, prompt_tokens=[16, 48], output_tokens=[40, 40])
    assert [a for _, a in _lengths(t, SEED, range(6))] == [10, 20, 30, 40,
                                                           40, 40]


def test_uniform_without_a_distribution():
    assert length(0.0, [16, 48]) == 16
    assert length(0.999999, [16, 48]) == 48
    assert length(0.5, [1, 100000], [1500, 0.6]) == 1500
