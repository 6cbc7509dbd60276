"""The two numerical arguments behind the K1 and K2 designs, on the CPU.

The CUDA kernels run only on the card; these tests pin, with test-local
models of their arithmetic (not code of the main path), the two claims
their designs rest on:

* K1 (split-K paged decode): per-partition partials (m, l, acc) combined
  by log-sum-exp, in two levels as the kernel does (lane groups and warps
  inside a block, then partitions in the combine kernel), give
  ``ref.paged_attention`` at fp32 1e-6, over random partitionings with
  empty partitions, ``seq_len`` 0 and ``seq_len`` clamped to the table,
  and the JAX oracle ``repro.kernels.ref.paged_attention`` on rows that
  see a key.
* K2 (tensor-core flash attention) under ``compute_dtype=fp32`` with bf16
  inputs: splitting the unnormalised probabilities into hi = bf16(p) and
  lo = bf16(p - hi), two bf16 products, stays within chip_smoke's bf16
  tolerance of ``ref.mha_attention``; rounding p once to bf16 does not on
  outputs near 0.  That is why the fp32 path pays for two products.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)

# chip_smoke.py's bf16 bar: two bf16 ulps relative plus 2.5e-4 absolute
BF16_REL, BF16_ABS = 2.0 ** -6, 2.5e-4


# ----------------------------------------------------------------------------
# K1: log-sum-exp combine of partition partials
# ----------------------------------------------------------------------------

def partial(logits, v):
    """(m, l, acc) of one piece: logits (H, n), v (n, D)."""
    if logits.shape[-1] == 0:
        H = logits.shape[0]
        return (torch.full((H,), float("-inf")), torch.zeros(H),
                torch.zeros(H, v.shape[-1]))
    m = logits.amax(-1)
    p = torch.exp(logits - m[:, None])
    return m, p.sum(-1), p @ v


def merge(parts):
    """Log-sum-exp merge of (m, l, acc) pieces; pieces with l = 0 add
    nothing (their acc is never read, as in the combine kernel)."""
    ms = torch.stack([m for m, _, _ in parts])            # (n, H)
    ls = torch.stack([l for _, l, _ in parts])
    accs = torch.stack([a for _, _, a in parts])           # (n, H, D)
    live = ls > 0
    mx = torch.where(live, ms, torch.full_like(ms, float("-inf"))).amax(0)
    w = torch.where(live, torch.exp(ms - torch.where(
        torch.isfinite(mx), mx, torch.zeros_like(mx))), torch.zeros_like(ms))
    accs = torch.where(live[..., None], accs, torch.zeros_like(accs))
    return mx, (ls * w).sum(0), (accs * w[..., None]).sum(0)


def cuts(rng, n, pieces):
    """Random cut points of [0, n): sorted, repeats make empty pieces."""
    inner = np.sort(rng.integers(0, n + 1, size=pieces - 1))
    return [0, *inner.tolist(), n]


def split_k_model(q, kp, vp, pt, sl, rng, *, n_parts, n_sub):
    """K1's arithmetic: n_parts partitions of the table's positions (the
    key count clamped to the table), each cut into n_sub pieces merged
    first (lane groups, warps), then the partitions merged; 0 where no
    key."""
    B, H, D = q.shape
    _, page, Hkv, _ = kp.shape
    group = H // Hkv
    n_pos = pt.shape[1] * page
    out = torch.zeros(B, H, D)
    for b in range(B):
        n_keys = min(int(sl[b]), n_pos)
        pos = torch.arange(n_keys)
        phys = pt[b].long()[pos // page]
        for hk in range(Hkv):
            k = kp[phys, pos % page, hk].float()               # (n_keys, D)
            v = vp[phys, pos % page, hk].float()
            qh = q[b, hk * group:(hk + 1) * group].float() * D ** -0.5
            logits = qh @ k.T                                  # (group, n)
            c = cuts(rng, n_pos, n_parts)
            parts = []
            for a, e in zip(c[:-1], c[1:]):
                a, e = min(a, n_keys), min(e, n_keys)
                s = [a + x for x in cuts(rng, e - a, n_sub)]
                parts.append(merge([partial(logits[:, x:y], v[x:y])
                                    for x, y in zip(s[:-1], s[1:])]))
            _, l, acc = merge(parts)
            out[b, hk * group:(hk + 1) * group] = torch.where(
                l[:, None] > 0, acc / torch.where(l > 0, l, 1.0)[:, None],
                torch.zeros_like(acc))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_split_k_log_sum_exp_combine_equals_paged_attention(seed):
    rng = np.random.default_rng(seed)
    B, H, Hkv, D, page, max_pages = 6, 6, 2, 16, 4, 9
    seq_lens = np.array([0, 1, 5, 17, 36, 50])   # 50 > 36: clamped
    P = B * max_pages + 3
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(P, page, Hkv, D))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(P, page, Hkv, D))
                          .astype(np.float32))
    pt = torch.from_numpy(rng.permutation(P)[:B * max_pages]
                          .reshape(B, max_pages).astype(np.int32))
    sl = torch.from_numpy(seq_lens.astype(np.int32))
    got = split_k_model(q, kp, vp, pt, sl, rng,
                        n_parts=int(rng.integers(2, 8)), n_sub=4)
    want = tref.paged_attention(q, kp, vp, pt, sl)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert not got[0].any(), "seq_len 0 gives 0"
    jwant = np.asarray(jref.paged_attention(
        jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(pt.numpy()),
        jnp.asarray(sl.numpy())))
    rows = seq_lens > 0                 # the JAX oracle gives NaN on row 0
    np.testing.assert_allclose(got.numpy()[rows], jwant[rows], rtol=1e-6,
                               atol=1e-6)


# ----------------------------------------------------------------------------
# K2: P split into bf16 hi + lo under compute_dtype=fp32
# ----------------------------------------------------------------------------

def pv_model(q, k, v, *, split: bool):
    """K2's arithmetic for bf16 inputs under compute_dtype=fp32, non-causal:
    exact bf16 products into fp32 logits, unnormalised p = exp(s - max),
    P V with P as bf16 operands (hi, plus lo when ``split``), divided by
    the fp32 row sum, rounded to bf16."""
    D = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * D ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    o = torch.einsum("bhqk,bhkd->bhqd", hi, v.float())
    if split:
        lo = (p - hi).bfloat16().float()
        o = o + torch.einsum("bhqk,bhkd->bhqd", lo, v.float())
    return (o / p.sum(-1, keepdim=True)).bfloat16()


def err_over_tol(got, want):
    w = want.float()
    return ((got.float() - w).abs() / (BF16_REL * w.abs() + BF16_ABS)).amax()


def near_zero_inputs(rows, n_keys, seed):
    """Each row (a head of its own): two keys dominate with v = +1 and -1,
    logits 0 and -delta, so the output (1 - e^-delta) / (1 + e^-delta) is
    near 0 while sum_j p_j |v_j| / l is 1; e^-delta lies anywhere between
    two bf16 values, so rounding it once errs by up to 2^-9."""
    rng = np.random.default_rng(seed)
    D = 64
    q = np.zeros((1, rows, 1, D), np.float32)
    q[..., 0] = 1.0
    k = np.zeros((1, rows, n_keys, D), np.float32)
    k[..., 2:, 0] = -200.0                 # logit -25: p ~ 1e-11
    k[..., 1, 0] = -8.0 * rng.uniform(0.002, 0.03, size=rows)
    v = rng.normal(size=(1, rows, n_keys, D)).astype(np.float32)
    v[..., 0, :], v[..., 1, :] = 1.0, -1.0
    return tuple(torch.from_numpy(a).bfloat16() for a in (q, k, v))


def test_p_split_hi_lo_holds_fp32_compute_where_one_rounding_fails():
    q, k, v = near_zero_inputs(rows=256, n_keys=40, seed=0)
    want = tref.mha_attention(q, k, v, causal=False,
                              compute_dtype=torch.float32)
    assert float(want.float().abs().max()) < 0.02, "outputs near 0"
    assert err_over_tol(pv_model(q, k, v, split=True), want) <= 1.0
    assert err_over_tol(pv_model(q, k, v, split=False), want) > 1.0


@pytest.mark.parametrize("n_keys", [1, 63, 200])
def test_p_split_hi_lo_holds_fp32_compute_on_random_inputs(n_keys):
    rng = np.random.default_rng(n_keys)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 4, s, 64))
                                .astype(np.float32)).bfloat16()
               for s in (16, n_keys, n_keys))
    want = tref.mha_attention(q, k, v, causal=False,
                              compute_dtype=torch.float32)
    assert err_over_tol(pv_model(q, k, v, split=True), want) <= 1.0
