"""The work of each hand-written kernel: one count, read everywhere.

One function a kernel and backward, taking the call's shapes and giving
``(flops, bytes)``: the operations the function needs and the bytes it
must move, each input read once and each output written once.  Where the
work depends on the data (K1's resident keys) the caller passes what this
call's data needs.  ``chip_smoke.py`` turns these into each kernel's
``bound_ms``; the kernels' wrappers, and ``kernels/ops.py``'s meta route,
report them to the active analysis (``launch/op_analysis.py``), since a
kernel is one launch that a dispatch mode cannot see into.

``launched(name, fn, *args)`` hands one launch's cost, ``fn(*args)``, to
every registered sink (``add_sink``); with none registered it computes
nothing, and a caller whose cost needs data from the card checks
``active()`` first, so a launch outside an analysis reads nothing back.
"""
from __future__ import annotations

_SINKS: list = []


def add_sink(sink) -> None:
    """Register ``sink(name, flops, nbytes)`` for every kernel launch."""
    _SINKS.append(sink)


def remove_sink(sink) -> None:
    _SINKS.remove(sink)


def active() -> bool:
    return bool(_SINKS)


def launched(name: str, fn, *args, **kwargs) -> None:
    """One launch of kernel ``name``, whose cost ``fn(*args, **kwargs)``
    gives (its first two values: flops, bytes), reported to every sink;
    with none registered nothing is computed."""
    if _SINKS:
        flops, nbytes = fn(*args, **kwargs)[:2]
        for sink in list(_SINKS):
            sink(name, flops, nbytes)


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
    k, v read and the output written once; with ``lse`` (K2's serving
    route that returns it) its fp32 LSE written too (training's LSE is
    K2-bwd's input and counted there)."""
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


def mamba2_scan(B: int, S: int, H: int, dh: int, ds: int, itemsize: int, *,
                state_in: bool = False, state_out: bool = True):
    """K3: (flops, bytes) in the state-passing form: x in and y out, B and
    C in, fp32 dt, A and D, and the fp32 state in and out as asked."""
    nbytes = (2 * B * S * H * dh + 2 * B * S * ds) * itemsize \
        + B * S * H * 4 + 2 * H * 4 \
        + (int(state_in) + int(state_out)) * B * H * ds * dh * 4
    flops = B * S * H * (5.0 * ds * dh + 2 * dh)
    return flops, nbytes


def rwkv6_scan(B: int, S: int, H: int, dh: int, itemsize: int, *,
               state_in: bool = False, state_out: bool = True):
    """K4: (flops, bytes): r, k, v, w in and y out, the fp32 bonus u, the
    fp32 state in and out as asked; 5 dh^2 operations a step and head."""
    nbytes = 5 * B * S * H * dh * itemsize + H * dh * 4 \
        + (int(state_in) + int(state_out)) * B * H * dh * dh * 4
    flops = B * S * H * 5.0 * dh * dh
    return flops, nbytes


def rwkv6_scan_split(B: int, H: int, dk: int, dv: int, itemsize: int, *,
                     state_in: bool = True):
    """K4's split-key route, one decode step on dk of the dv keys of every
    head: (flops, bytes): r, k, w (dk) and v (dv) in, the fp32 part of the
    readout (dv) out, the slice's fp32 bonus, its fp32 state rows in (as
    asked) and out; 5 dk dv operations a head."""
    nbytes = B * H * (3 * dk + dv) * itemsize + B * H * dv * 4 \
        + H * dk * 4 + (int(state_in) + 1) * B * H * dk * dv * 4
    flops = B * H * 5.0 * dk * dv
    return flops, nbytes


def scan_bwd(B: int, S: int, H: int, dh: int, itemsize: int,
             n_vec_in: int, n_vec_out: int, extra_bytes: int):
    """A scan's gradient: (flops, bytes): ``n_vec_in`` (B, S, H, dh)
    inputs read and ``n_vec_out`` written once, plus ``extra_bytes``; 14
    dh^2 operations a step and head (the state's forward recurrence and
    the gradient's: three products and three updates of a dh x dh state,
    less what they share)."""
    nbytes = (n_vec_in + n_vec_out) * B * S * H * dh * itemsize + extra_bytes
    flops = 14.0 * dh * dh * B * S * H
    return flops, nbytes


def mamba2_scan_bwd(B: int, S: int, H: int, dh: int, ds: int,
                    itemsize: int):
    """K3-bwd: x, dy in and dx out; B, C in and dB, dC out; fp32 dt in
    and ddt out; A, D in and dA, dD out."""
    extra = 4 * B * S * ds * itemsize + 2 * B * S * H * 4 + 4 * H * 4
    return scan_bwd(B, S, H, dh, itemsize, 2, 1, extra)


def rwkv6_scan_bwd(B: int, S: int, H: int, dh: int, itemsize: int):
    """K4-bwd: r, k, v, w, dy in and dr, dk, dv, dw out; fp32 u in and du
    out."""
    return scan_bwd(B, S, H, dh, itemsize, 5, 4, 2 * H * dh * 4)
