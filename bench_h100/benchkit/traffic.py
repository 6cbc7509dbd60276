"""The general traffic generator: a traffic file's parameters and a seed
give the inputs of a run.

Serving: an endless stream of requests, each a prompt length, an answer
length and the prompt's tokens, all drawn from the seed.  A length is
drawn from the mix's distribution: ``prompt_lognormal`` / ``output_lognormal``
([median, sigma], the heavy tails that real traffic has) or, without one,
uniform; either way clipped to ``prompt_tokens`` / ``output_tokens``
([least, most]).  The draw is stratified: the stream is cut into blocks of as
many requests as there are clients, and each block takes one quantile
from each of as many equal slices of the distribution, at the slice's
midpoint, in an order that the seed and the block set, prompts and
answers each on their own.  So every block of every seed sends the same
lengths, the tail among them, in another order, with other token ids:
the seed changes the order of the work and not its amount.  The first
``clients`` requests, those in flight when the run starts, are cut to a
share of their answer spread evenly over (0, 1], so that completions are
staggered from the first step as they are in a loop that has run for a
while.

Training: each step's rows, uniform token ids drawn from the seed and the
step, labels the next token (-1 past the end).
"""
from __future__ import annotations

from statistics import NormalDist

import numpy as np

_NORMAL = NormalDist()


def length(q: float, span, lognormal=None) -> int:
    """The length at quantile ``q`` of a mix's distribution, clipped to
    ``span`` ([least, most])."""
    lo, hi = span
    if lognormal is None:
        x = lo + q * (hi + 1 - lo)
    else:
        median, sigma = lognormal
        x = median * np.exp(sigma * _NORMAL.inv_cdf(min(max(q, 1e-12),
                                                        1 - 1e-12)))
    return int(min(max(np.floor(x), lo), hi))


class Requests:
    """The seed's stream of serving requests: ``next()`` gives (index,
    prompt tokens, answer length)."""

    def __init__(self, traffic: dict, seed: int, vocab: int) -> None:
        self.t = traffic
        self.block = traffic["clients"]
        self.seed, self.vocab = int(seed), vocab
        self.clients = traffic["clients"]
        self.k = 0
        self._at = (None, None)

    def _quantiles(self, b: int):
        """Block ``b``'s (prompt, answer) quantiles, one a slice."""
        if self._at[0] != b:
            n = self.block
            rng = np.random.default_rng([self.seed, 4, b])
            q = [(rng.permutation(n) + 0.5) / n for _ in range(2)]
            self._at = (b, q)
        return self._at[1]

    def lengths(self, k: int) -> tuple[int, int]:
        """Request ``k``'s (prompt, answer) lengths."""
        b, j = divmod(k, self.block)
        qp, qa = self._quantiles(b)
        t = self.t
        p = length(qp[j], t["prompt_tokens"], t.get("prompt_lognormal"))
        a = length(qa[j], t["output_tokens"], t.get("output_lognormal"))
        if k < self.clients:
            a = max(1, int(np.ceil(a * (k + 1) / self.clients)))
        return p, a

    def __call__(self, k: int) -> tuple[int, np.ndarray, int]:
        """Request ``k`` of the stream."""
        p, a = self.lengths(k)
        rng = np.random.default_rng([self.seed, 1, k])
        return k, rng.integers(0, self.vocab, size=p).astype(np.int32), a

    def next(self) -> tuple[int, np.ndarray, int]:
        self.k += 1
        return self(self.k - 1)


class Rows:
    """Training rows, one batch a step, in the program's ``next_batch``
    form (numpy ``tokens`` and ``labels``)."""

    def __init__(self, traffic: dict, seed: int, vocab: int) -> None:
        self.batch, self.seq = traffic["batch"], traffic["seq_len"]
        self.seed, self.vocab = int(seed), vocab
        self.step = 0

    def rows(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng([self.seed, 2, step])
        tok = rng.integers(0, self.vocab, size=(self.batch, self.seq)
                           ).astype(np.int32)
        lab = np.concatenate([tok[:, 1:], np.full((self.batch, 1), -1,
                                                  np.int32)], 1)
        return tok, lab

    def next_batch(self) -> dict:
        tok, lab = self.rows(self.step)
        self.step += 1
        return {"tokens": tok, "labels": lab}
