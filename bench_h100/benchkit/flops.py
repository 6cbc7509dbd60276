"""Useful model FLOPs, summed over a configuration's layers.

A product of an (m, k) by a (k, n) matrix is 2 m k n operations.  A token
through the model passes every matrix it uses once: each layer's (its
layout's ``layer_matmul_params``: an MoE layer counts its top-k experts
and its router) and the head where a token is predicted; the embedding is
a lookup.  Attention adds each layer's ``attention_pair_flops`` a (query,
key) pair the causal mask leaves.  Training is three times the forward
(the backward twice it); recomputation is not useful work and is not
counted.  Work an implementation does beyond this (a dense dispatch over
every expert, padding) shows as lost utilisation.

Every function takes the configuration's layout (``layouts/<layout>.py``)
and its model sizes ``m``; the counts are whole numbers, exact in a float.
"""
from __future__ import annotations


def token_params(layout, m: dict) -> int:
    """Weights one token multiplies through in all the layers."""
    return sum(layout.layer_matmul_params(m, i)
               for i in range(m["num_hidden_layers"]))


def attention_flops(layout, m: dict, pairs: int) -> float:
    """Forward attention over ``pairs`` (query, key) pairs, all layers."""
    return float(pairs * sum(layout.attention_pair_flops(m, i)
                             for i in range(m["num_hidden_layers"])))


def prefill(layout, m: dict, n: int) -> float:
    """A prompt of n tokens: every token through the layers, the last one
    through the head, causal attention."""
    return (2.0 * n * token_params(layout, m)
            + 2.0 * layout.head_params(m)
            + attention_flops(layout, m, n * (n + 1) // 2))


def decode(layout, m: dict, contexts) -> float:
    """One decode step: a token for each context length in ``contexts``
    (keys it attends, itself included)."""
    per = 2.0 * (token_params(layout, m) + layout.head_params(m))
    return per * len(contexts) + attention_flops(layout, m,
                                                 int(sum(contexts)))


def train_step(layout, m: dict, batch: int, seq: int) -> float:
    """Forward and backward of ``batch`` rows of ``seq`` tokens, every
    token predicted."""
    fwd = (2.0 * batch * seq * (token_params(layout, m)
                                + layout.head_params(m))
           + attention_flops(layout, m, batch * seq * (seq + 1) // 2))
    return 3.0 * fwd
