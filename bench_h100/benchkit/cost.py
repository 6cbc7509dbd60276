"""The work of the hand-written kernels K1, K2 and K2-bwd, frozen.

A copy of the program's counts (``repro_torch.kernels.cost`` as of the
benchmark's first version): each function takes a call's shapes and gives
``(flops, bytes)``, every input read once and every output written once,
the data-dependent part (K1's resident keys) from the call's own lengths.
The benchmark's tests hold them equal to the program's at the cells'
shapes; the program may change its copy, this one stays.  ``PEAK_FLOPS``
and ``PEAK_BYTES_S`` are one H100 SXM's published dense bf16 rate and HBM3
bandwidth (at its 700 W limit).
"""
from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the chip could take, and which peak sets it."""
    f, b = flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S
    return (f, "operations") if f >= b else (b, "bytes")


def attn_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """The (query, key) pairs an attention's mask leaves; causal keys are
    right-aligned: query i sees keys 0 .. i + Skv - Sq."""
    if not causal:
        return Sq * Skv
    return sum(max(0, min(Skv, i + 1 + Skv - Sq)) for i in range(Sq))


def paged_attention(B: int, H: int, Hkv: int, D: int, page: int,
                    max_pages: int, seq_lens, itemsize: int):
    """K1: (flops, bytes, resident tokens) for q (B, H, D) against pages of
    ``page`` tokens through a ``max_pages``-wide table: the resident K/V
    rows, q in and out, the table entries in use and the lengths; 4 H D
    operations a resident key."""
    keys = [min(int(s), max_pages * page) for s in seq_lens]
    n_tok = sum(keys)
    nbytes = (2 * n_tok * Hkv * D * itemsize + 2 * B * H * D * itemsize
              + sum(-(-s // page) for s in keys) * 4 + B * 4)
    flops = 4.0 * n_tok * H * D
    return flops, nbytes, n_tok


def flash_attention(B: int, H: int, Hkv: int, Sq: int, Skv: int, D: int,
                    causal: bool, itemsize: int, *, lse: bool = False):
    """K2: (flops, bytes): QK^T and PV over the pairs the mask leaves; q,
    k, v read and the output written once; with ``lse`` its fp32 LSE
    written too."""
    nbytes = (2 * B * H * Sq * D + 2 * B * Hkv * Skv * D) * itemsize \
        + (4 * B * H * Sq if lse else 0)
    flops = 4.0 * B * H * D * attn_pairs(Sq, Skv, causal)
    return flops, nbytes


def flash_attention_bwd(B: int, H: int, Hkv: int, Sq: int, Skv: int, D: int,
                        causal: bool, itemsize: int):
    """K2-bwd: (flops, bytes): five products over the pairs the mask
    leaves (S, dP, dV, dK, dQ); q, k, v, out, dout and the fp32 LSE read
    once, dq, dk, dv written once."""
    flops = 5 * 2.0 * B * H * D * attn_pairs(Sq, Skv, causal)
    nbytes = (4 * B * H * Sq * D + 4 * B * Hkv * Skv * D) * itemsize \
        + 4 * B * H * Sq
    return flops, nbytes
