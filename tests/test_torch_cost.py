"""One count of each kernel's work: ``repro_torch/kernels/cost.py``.

``chip_smoke.py`` reads every kernel's bound from ``kernels/cost.py``,
as the meta route and the analyzer do.  The formulas it carried before
(copied below as they stood) and the functions it calls now must give
the same numbers, to the last digit, at the shapes its phases 2, 2c, 9a
and 11a bound.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402

# ----------------------------------------------------------------------------
# the formulas as chip_smoke.py carried them
# ----------------------------------------------------------------------------


def old_attn_pairs(Sq, Skv, causal):
    if not causal:
        return Sq * Skv
    return sum(max(0, min(Skv, i + 1 + Skv - Sq)) for i in range(Sq))


def old_k1_bound(q, kp, pt, sl):
    B, H, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    keys = [min(int(s), pt.shape[1] * page) for s in sl.tolist()]
    n_tok = sum(keys)
    isz = q.element_size()
    nbytes = (2 * n_tok * Hkv * D * isz + 2 * q.numel() * isz
              + sum(-(-s // page) for s in keys) * 4 + B * 4)
    flops = 4.0 * n_tok * H * D
    return n_tok, nbytes, flops, cs.bound(nbytes, flops, q.dtype)


def old_k2_bound(q, k):
    B, H, S, D = q.shape
    visible = S * (S + 1) / 2
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4.0 * B * H * D * visible
    return cs.bound(nbytes, flops, q.dtype)


def old_shape_bound(q, k, causal):
    B, H, Sq, D = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4.0 * B * H * D * old_attn_pairs(Sq, k.shape[2], causal)
    return nbytes, flops, cs.bound(nbytes, flops, q.dtype)


def old_k2_bwd_bound(q, k, causal):
    B, H, Sq, D = q.shape
    flops = 5 * 2.0 * B * H * D * old_attn_pairs(Sq, k.shape[2], causal)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + 4 * B * H * Sq
    return (*cs.bound(nbytes, flops, torch.bfloat16), nbytes, flops)


def old_k3(x, Bm, dt):
    B, S, H, dh = x.shape
    ds = Bm.shape[-1]
    isz = x.element_size()
    nbytes = (2 * x.numel() + 2 * Bm.numel()) * isz + dt.numel() * 4 \
        + 2 * H * 4 + B * H * ds * dh * 4
    flops = B * S * H * (5.0 * ds * dh + 2 * dh)
    return cs.bound(nbytes, flops, x.dtype)


def old_k4(r, s_in):
    B, S, H, dh = r.shape
    nbytes = 5 * r.numel() * r.element_size() + H * dh * 4 \
        + (1 + s_in) * B * H * dh * dh * 4
    flops = B * S * H * 5.0 * dh * dh
    return nbytes, flops, cs.bound(nbytes, flops, r.dtype)


def old_scan_bwd_bound(x, n_vec_in, n_vec_out, extra_bytes, dtype):
    nbytes = (n_vec_in + n_vec_out) * x.numel() * x.element_size() \
        + extra_bytes
    B, S, H, dh = x.shape
    flops = 14.0 * dh * dh * B * S * H
    return (*cs.bound(nbytes, flops, dtype), nbytes, flops)


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


bf, f32 = torch.bfloat16, torch.float32
# (B, H, Hkv, D, page, max_pages or None, seq_lens, dtype): phase 2's main,
# engine, long, olmoe and olmoe-engine cases, and 2c's reduced engine
K1_CASES = [
    (16, 14, 2, 64, 16, None,
     [1, 17, 2048, 1000, 16, 33, 5, 900, 1500, 7, 64, 65, 2047, 300, 12, 8],
     bf),
    (8, 14, 2, 64, 16, 67, [128, 1056, 500, 700, 999, 130, 1000, 640], bf),
    (1, 14, 2, 64, 16, None, [16384], bf),
    (16, 16, 16, 128, 16, None, [1, 17, 2048, 1000, 16, 33], bf),
    (8, 16, 16, 128, 16, 67, [128, 1056, 500, 700, 999, 130, 1000, 640], bf),
    (4, 4, 2, 16, 16, 6, [0, 50, 95, 7], f32),
]
# (B, H, Hkv, Sq, Skv, D, causal, dtype): phase 2's K2 shapes (the timed
# prefill, whisper's, qwen2's training and S = 1024, zamba2's, olmoe's),
# 9a's K2-bwd shapes and 2c's reduced training shape
ATTN_CASES = [
    (1, 14, 2, 2048, 2048, 64, True, bf),
    (8, 20, 20, 1500, 1500, 64, False, bf),
    (8, 20, 20, 224, 224, 64, True, bf),
    (8, 20, 20, 224, 1500, 64, False, bf),
    (8, 20, 20, 1, 1500, 64, False, bf),
    (8, 14, 2, 1024, 1024, 64, True, bf),
    (1, 14, 2, 1024, 1024, 64, True, bf),
    (4, 32, 32, 1024, 1024, 64, True, bf),
    (1, 16, 16, 1024, 1024, 128, True, bf),
    (4, 16, 16, 1024, 1024, 128, True, bf),
    (2, 20, 20, 448, 1500, 64, False, bf),
    (4, 4, 2, 128, 128, 16, True, f32),
]


@pytest.mark.parametrize("case", K1_CASES)
def test_k1_bound_unchanged(case):
    B, H, Hkv, D, page, max_pages, lens, dtype = case
    if max_pages is None:
        max_pages = max(-(-s // page) for s in lens) + 1
    q = meta(B, H, D, dtype=dtype)
    kp = meta(B * max_pages + 7, page, Hkv, D, dtype=dtype)
    pt = meta(B, max_pages, dtype=torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32)
    assert cs.k1_bound(q, kp, pt, sl) == old_k1_bound(q, kp, pt, sl)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_bounds_unchanged(case):
    B, H, Hkv, Sq, Skv, D, causal, dtype = case
    q, k = meta(B, H, Sq, D, dtype=dtype), meta(B, Hkv, Skv, D, dtype=dtype)
    assert cs.attn_pairs(Sq, Skv, causal) == old_attn_pairs(Sq, Skv, causal)
    flops, nbytes = cost.flash_attention(B, H, Hkv, Sq, Skv, D, causal,
                                         q.element_size())
    assert (nbytes, flops, cs.bound(nbytes, flops, q.dtype)) == \
        old_shape_bound(q, k, causal)
    if causal and Sq == Skv:
        assert cs.bound(nbytes, flops, q.dtype) == old_k2_bound(q, k)
    assert cs.k2_bwd_bound(q, k, causal) == old_k2_bwd_bound(q, k, causal)


@pytest.mark.parametrize("B,S,H,dh,ds,dtype", [
    (4, 1024, 64, 64, 64, bf), (2, 300, 8, 64, 64, f32),
    (2, 70, 16, 8, 8, f32)])
def test_mamba2_bounds_unchanged(B, S, H, dh, ds, dtype):
    x, Bm = meta(B, S, H, dh, dtype=dtype), meta(B, S, ds, dtype=dtype)
    dt = meta(B, S, H, dtype=f32)
    flops, nbytes = cost.mamba2_scan(B, S, H, dh, ds, x.element_size())
    assert cs.bound(nbytes, flops, x.dtype) == old_k3(x, Bm, dt)
    # 11a: x, dy in and dx out; B, C in and dB, dC out; dt in and ddt out
    extra = 4 * B * S * ds * x.element_size() + 2 * B * S * H * 4 \
        + 4 * H * 4
    assert cs.scan_bwd_bound(x, 2, 1, extra, dtype) == \
        old_scan_bwd_bound(x, 2, 1, extra, dtype)
    assert cost.mamba2_scan_bwd(B, S, H, dh, ds, x.element_size()) == \
        tuple(old_scan_bwd_bound(x, 2, 1, extra, dtype)[3:1:-1])


@pytest.mark.parametrize("B,S,H,dh,dtype", [
    (4, 1024, 32, 64, bf), (4, 1, 32, 64, bf), (4, 1, 32, 64, f32),
    (2, 70, 4, 16, f32)])
def test_rwkv6_bounds_unchanged(B, S, H, dh, dtype):
    r = meta(B, S, H, dh, dtype=dtype)
    for s_in in (False, True):
        flops, nbytes = cost.rwkv6_scan(B, S, H, dh, r.element_size(),
                                        state_in=s_in)
        assert (nbytes, flops, cs.bound(nbytes, flops, dtype)) == \
            old_k4(r, s_in)
    extra = 2 * H * dh * 4
    assert cs.scan_bwd_bound(r, 5, 4, extra, dtype) == \
        old_scan_bwd_bound(r, 5, 4, extra, dtype)
    assert cost.rwkv6_scan_bwd(B, S, H, dh, r.element_size()) == \
        tuple(old_scan_bwd_bound(r, 5, 4, extra, dtype)[3:1:-1])


def test_report_reaches_every_sink_and_only_when_listening():
    seen = []
    calls = []

    def fn(*a):
        calls.append(a)
        return 3.0, 5
    cost.launched("k", fn, 1)
    assert calls == []                    # nobody listens: nothing computed
    sink = lambda *a: seen.append(a)      # noqa: E731
    cost.add_sink(sink)
    try:
        assert cost.active()
        cost.launched("k", fn, 1)
    finally:
        cost.remove_sink(sink)
    assert seen == [("k", 3.0, 5)] and not cost.active()
    assert np.isclose(cost.attn_pairs(4, 6, True), 4 * 6 - 6)
