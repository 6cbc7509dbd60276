"""Useful model FLOPs, counted from a configuration file.

A product of an (m, k) by a (k, n) matrix is 2 m k n operations.  A token
through the model passes every matrix it uses once: the attention's four,
the feed-forward's three (an MoE layer: its top-k experts' and the
router's), and the head where a token is predicted; the embedding is a
lookup.  Attention adds 4 H hd operations a (query, key) pair the causal
mask leaves (QK^T and PV).  Training is three times the forward (the
backward twice it); recomputation is not useful work and is not counted.
Work an implementation does beyond this (a dense dispatch over every
expert, padding) shows as lost utilisation.
"""
from __future__ import annotations


def dims(m: dict) -> dict:
    d, H = m["hidden_size"], m["num_attention_heads"]
    hd = m.get("head_dim") or d // H
    return dict(L=m["num_hidden_layers"], d=d, H=H,
                Hkv=m["num_key_value_heads"], hd=hd,
                f=m["intermediate_size"], V=m["vocab_size"],
                E=m.get("num_experts", 0), K=m.get("num_experts_per_tok", 0))


def layer_matmul_params(m: dict) -> int:
    """Weights one token multiplies through in one layer."""
    g = dims(m)
    attn = g["d"] * (g["H"] + 2 * g["Hkv"]) * g["hd"] + g["H"] * g["hd"] * g["d"]
    ffn = 3 * g["d"] * g["f"]
    if g["E"]:
        return attn + g["K"] * ffn + g["d"] * g["E"]
    return attn + ffn


def head_params(m: dict) -> int:
    return m["hidden_size"] * m["vocab_size"]


def attention_flops(m: dict, pairs: int) -> float:
    """Forward attention over ``pairs`` (query, key) pairs, all layers."""
    g = dims(m)
    return 4.0 * g["H"] * g["hd"] * pairs * g["L"]


def prefill(m: dict, n: int) -> float:
    """A prompt of n tokens: every token through the layers, the last one
    through the head, causal attention."""
    L = m["num_hidden_layers"]
    return (2.0 * n * L * layer_matmul_params(m) + 2.0 * head_params(m)
            + attention_flops(m, n * (n + 1) // 2))


def decode(m: dict, contexts) -> float:
    """One decode step: a token for each context length in ``contexts``
    (keys it attends, itself included)."""
    L = m["num_hidden_layers"]
    per = 2.0 * (L * layer_matmul_params(m) + head_params(m))
    return per * len(contexts) + attention_flops(m, int(sum(contexts)))


def train_step(m: dict, batch: int, seq: int) -> float:
    """Forward and backward of ``batch`` rows of ``seq`` tokens, every
    token predicted."""
    L = m["num_hidden_layers"]
    fwd = (2.0 * batch * seq * (L * layer_matmul_params(m) + head_params(m))
           + attention_flops(m, batch * seq * (seq + 1) // 2))
    return 3.0 * fwd
