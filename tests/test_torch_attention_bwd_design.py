"""The arithmetic behind K2-bwd (``csrc/flash_attention_bwd.cu``), on the
CPU.

The kernel runs only on the card; these tests pin, with a test-local model
of its loops (not code of the main path), the claims its design rests on:

* the forward's per-row log-sum-exp (LSE) lets the backward recompute the
  probabilities, P = exp(S - LSE), without the softmax's max and sum;
* D_i = rowsum(dO * O) equals rowsum(dP * P), the softmax backward's
  row term, so dS = P * (dP - D_i) needs no second pass over the keys;
* one block per (64-key tile, KV head) that loops over the GQA group's
  query heads and the query tiles that can see its keys, accumulating dK
  and dV, plus one block per (64-query tile, head) for dQ, give the
  gradient of ``ref.mha_attention`` — the group's sum taken in-block, no
  atomics;
* on the tensor-core route (bf16, D = 64 or 128) P and dS enter their
  products rounded once to bf16, which stays inside the bf16 bar;
* at D = 128 that route holds a tile as two 64-column halves (TMA's
  128-byte swizzle caps a box at 64 bf16 columns): the products that
  reduce over D sum the halves' partial products in order, and those whose
  N is D (dV, dK, dQ) run one product a half into that half's own
  accumulators; the model takes them so and keeps the bars;
* that route's dK/dV block deals its (query head, query tile) pairs to its
  consumer warpgroups in turn (pair i to warpgroup i % split), each with
  its own accumulators, and sums those in a fixed order at the end: the
  dealing is even (per-warpgroup counts differ by at most one), every pair
  is dealt once, and the sum is the gradient; its key tiles are issued
  heaviest first; its dQ blocks hold 128 query rows, 64 a warpgroup, each
  half walking the key tiles up to its own diagonal;
* a row that sees no key (causal, Sq > Skv) has LSE = +inf: P = 0, and
  the row adds nothing to dK, dV and gets dQ = 0 — the zero output's
  gradient, as ``jax.vjp`` of the JAX reference gives it too (whose
  forward returns NaN on those rows, ROADMAP §3).

The model's gradients are held to autograd through the port's
``ref.mha_attention`` (and, where the JAX reference is defined, to
``jax.vjp`` of ``repro.kernels.ref.mha_attention``) at fp32 1e-5 of the
largest gradient, and under ``compute_dtype=bf16`` to the bf16 bar 6e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)
TILE = 64


def rnd(x: torch.Tensor, on: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if on else x


def lse_model(q, k, causal, scale, bf16):
    """The forward's LSE: natural log of sum exp(scaled logits), +inf for
    a row that sees no key."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qs = rnd(q.float() * scale, bf16)
    kf = rnd(k.float(), bf16).repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    s = s.masked_fill(~visible(Sq, Skv, causal), float("-inf"))
    lse = torch.logsumexp(s, -1)
    return torch.where(torch.isfinite(lse), lse,
                       torch.full_like(lse, float("inf")))


def visible(Sq, Skv, causal):
    qi = torch.arange(Sq)[:, None] + (Skv - Sq)
    ki = torch.arange(Skv)[None, :]
    return ki <= qi if causal else torch.ones(Sq, Skv, dtype=torch.bool)


def over_d(a, b, half):
    """a @ b.T, reducing over D; with ``half`` columns a half, the halves'
    partial products added in order (the D = 128 route's k-slices)."""
    if half is None:
        return a @ b.T
    out = torch.zeros(a.shape[0], b.shape[0])
    for c in range(0, a.shape[1], half):
        out = out + a[:, c:c + half] @ b[:, c:c + half].T
    return out


def by_halves(a, b, half):
    """a @ b, whose N is D; with ``half`` columns a half, one product a
    half (the D = 128 route's dV, dK and dQ)."""
    if half is None:
        return a @ b
    return torch.cat([a @ b[:, c:c + half]
                      for c in range(0, b.shape[1], half)], 1)


def tile_scores(qs, do, kf, vf, lse, di, q0, k0, Sq, Skv, causal, bf16,
                half=None):
    """P and dS of one (query tile, key tile): the kernel's `scores`."""
    s = over_d(qs, kf, half)
    dp = rnd(over_d(do, vf, half), bf16)
    rows = torch.arange(q0, q0 + qs.shape[0])
    keys = torch.arange(k0, k0 + kf.shape[0])
    ok = (rows[:, None] < Sq) & (keys[None, :] < Skv)
    if causal:
        ok &= keys[None, :] <= rows[:, None] + (Skv - Sq)
    p = torch.where(ok, torch.exp(s - lse[:, None]), torch.zeros_like(s))
    return p, p * (dp - di[:, None])


def pad_rows(x, r0, n):
    """Rows r0 .. r0 + TILE of x, zeros past n."""
    out = torch.zeros((TILE,) + x.shape[1:], dtype=x.dtype)
    m = max(0, min(TILE, n - r0))
    out[:m] = x[r0:r0 + m]
    return out


def n_pairs(Sq, Skv, k0, group, causal):
    """(query head, query tile) pairs that see the key tile at k0, in the
    kernel's head-major order, and the first query tile."""
    n_qt = -(-Sq // TILE)
    qt0 = min(n_qt, max(0, k0 - (Skv - Sq)) // TILE) if causal else 0
    return group * (n_qt - qt0), qt0


def bwd_model(q, k, v, out, dout, lse, *, causal, scale, bf16,
              tensor_cores=False, split=1, dq_rows=TILE, half=None):
    """The kernel's three passes, tile by tile, in fp32.  ``tensor_cores``
    models the bf16 route: P and dS enter their products rounded once to
    bf16.  ``split`` consumer warpgroups share a key tile, pair i going to
    warpgroup i % split, each with whole-width accumulators, and their sums
    are added in warpgroup order; ``dq_rows`` query rows make a dQ block;
    ``half`` columns a tile half (64 at D = 128: ``over_d``,
    ``by_halves``)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    offs = Skv - Sq
    di = (dout.float() * out.float()).sum(-1)             # pass 1
    dq = torch.zeros(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    inf = torch.tensor(float("inf"))
    for b in range(B):
        for hkv in range(Hkv):                            # pass 2
            for k0 in range(0, Skv, TILE):
                kf = pad_rows(rnd(k[b, hkv].float(), bf16), k0, Skv)
                vf = pad_rows(rnd(v[b, hkv].float(), bf16), k0, Skv)
                acc_k = torch.zeros(split, TILE, D)
                acc_v = torch.zeros(split, TILE, D)
                n_items, qt0 = n_pairs(Sq, Skv, k0, group, causal)
                nq = n_items // group
                for i in range(n_items):
                    h = hkv * group + i // nq
                    q0 = (qt0 + i % nq) * TILE
                    qs = pad_rows(rnd(q[b, h].float() * scale, bf16), q0, Sq)
                    do = pad_rows(dout[b, h].float(), q0, Sq)
                    ls = torch.where(torch.arange(q0, q0 + TILE) < Sq,
                                     pad_rows(lse[b, h], q0, Sq), inf)
                    d_i = pad_rows(di[b, h], q0, Sq)
                    p, ds = tile_scores(qs, do, kf, vf, ls, d_i, q0, k0, Sq,
                                        Skv, causal, bf16, half)
                    acc_v[i % split] += by_halves(
                        rnd(p, bf16 or tensor_cores).T, do, half)
                    acc_k[i % split] += by_halves(
                        rnd(ds, tensor_cores).T, qs, half)
                gk, gv = acc_k[0], acc_v[0]
                for w in range(1, split):       # the fixed-order sum
                    gk, gv = gk + acc_k[w], gv + acc_v[w]
                n = min(TILE, Skv - k0)
                dk[b, hkv, k0:k0 + n] = rnd(gk, bf16)[:n]
                dv[b, hkv, k0:k0 + n] = rnd(gv, bf16)[:n]
        for h in range(H):                                # pass 3
            hkv = h // group
            q0s = [q0 for qb in range(0, Sq, dq_rows)
                   for q0 in range(qb, min(qb + dq_rows, Sq), TILE)]
            for q0 in q0s:      # each 64-row half to its own diagonal
                qs = pad_rows(rnd(q[b, h].float() * scale, bf16), q0, Sq)
                do = pad_rows(dout[b, h].float(), q0, Sq)
                ls = torch.where(torch.arange(q0, q0 + TILE) < Sq,
                                 pad_rows(lse[b, h], q0, Sq), inf)
                d_i = pad_rows(di[b, h], q0, Sq)
                acc = torch.zeros(TILE, D)
                last = min(q0 + TILE, Sq) - 1 + offs if causal else Skv - 1
                for k0 in range(0, min(Skv, last + 1) if last >= 0 else 0,
                                TILE):
                    kf = pad_rows(rnd(k[b, hkv].float(), bf16), k0, Skv)
                    vf = pad_rows(rnd(v[b, hkv].float(), bf16), k0, Skv)
                    _, ds = tile_scores(qs, do, kf, vf, ls, d_i, q0, k0, Sq,
                                        Skv, causal, bf16, half)
                    acc += by_halves(rnd(ds, tensor_cores), kf, half)
                n = min(TILE, Sq - q0)
                dq[b, h, q0:q0 + n] = (rnd(acc, bf16) * scale)[:n]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def case(seed, B, H, Hkv, Sq, Skv, D, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    return (mk(B, H, Sq, D), mk(B, Hkv, Skv, D), mk(B, Hkv, Skv, D),
            mk(B, H, Sq, D))


def autograd(q, k, v, dout, causal, cdt):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = tref.mha_attention(q, k, v, causal=causal, compute_dtype=cdt)
    out.backward(dout)
    return out.detach(), (q.grad, k.grad, v.grad)


def held(got, want, bar):
    for g, w in zip(got, want):
        w = w.float()
        err = float((g.float() - w).abs().max())
        assert err <= bar * float(w.abs().max()), (err, float(w.abs().max()))


CASES = {
    "causal GQA 7:1 ragged S=100": (2, 14, 2, 100, 100, 64, True),
    "causal right-aligned Sq=70 Skv=150": (1, 4, 2, 70, 150, 64, True),
    "non-causal D=128 Sq=77 Skv=130": (1, 8, 1, 77, 130, 128, False),
    "causal MHA two tiles S=128": (1, 2, 2, 128, 128, 64, True),
    # the D = 128 route's main paths: olmoe / deepseek / moonshot (MHA),
    # starcoder2 (GQA 12:1), and its edges
    "causal MHA D=128 ragged S=100": (1, 2, 2, 100, 100, 128, True),
    "causal GQA 12:1 D=128 S=70": (1, 12, 1, 70, 70, 128, True),
    "causal right-aligned D=128 Sq=70 Skv=150": (1, 4, 2, 70, 150, 128,
                                                 True),
    "causal empty rows D=128 Sq=150 Skv=60": (1, 2, 2, 150, 60, 128, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_lse_recompute_gives_the_probabilities(name):
    B, H, Hkv, Sq, Skv, D, causal = CASES[name]
    q, k, v, _ = case(0, B, H, Hkv, Sq, Skv, D)
    scale = D ** -0.5
    lse = lse_model(q, k, causal, scale, False)
    kf = k.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, kf)
    mask = visible(Sq, Skv, causal)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    want = tref._softmax_rows(s, mask)
    torch.testing.assert_close(p, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_di_term_is_the_softmax_row_term(name):
    """rowsum(dO * O) = rowsum(dP * P) with dP = dO V^T."""
    B, H, Hkv, Sq, Skv, D, causal = CASES[name]
    q, k, v, dout = case(1, B, H, Hkv, Sq, Skv, D)
    scale = D ** -0.5
    out = tref.mha_attention(q, k, v, causal=causal)
    kf = k.repeat_interleave(H // Hkv, dim=1)
    vf = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, kf)
    p = tref._softmax_rows(s, visible(Sq, Skv, causal))
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, vf)
    torch.testing.assert_close((dout * out).sum(-1), (dp * p).sum(-1),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_tiled_backward_equals_autograd_fp32(name):
    B, H, Hkv, Sq, Skv, D, causal = CASES[name]
    q, k, v, dout = case(2, B, H, Hkv, Sq, Skv, D)
    out, want = autograd(q, k, v, dout, causal, torch.float32)
    lse = lse_model(q, k, causal, D ** -0.5, False)
    got = bwd_model(q, k, v, out, dout, lse, causal=causal, scale=D ** -0.5,
                    bf16=False)
    held(got, want, 1e-5)


@pytest.mark.parametrize("tc", [False, True], ids=["fma", "tensor_cores"])
@pytest.mark.parametrize("name", ["causal GQA 7:1 ragged S=100",
                                  "non-causal D=128 Sq=77 Skv=130"])
@pytest.mark.parametrize("cdt", ["fp32", "bf16"])
def test_tiled_backward_bf16_inputs_within_the_bf16_bar(name, cdt, tc):
    """bf16 inputs: the FMA route's exact products, and the tensor-core
    route's P and dS rounded once to bf16, both hold the bf16 bar."""
    B, H, Hkv, Sq, Skv, D, causal = CASES[name]
    q, k, v, dout = case(3, B, H, Hkv, Sq, Skv, D, torch.bfloat16)
    bf16 = cdt == "bf16"
    c = torch.bfloat16 if bf16 else torch.float32
    out, want = autograd(q, k, v, dout, causal, c)
    lse = lse_model(q, k, causal, D ** -0.5, bf16)
    got = bwd_model(q, k, v, out, dout, lse, causal=causal, scale=D ** -0.5,
                    bf16=bf16, tensor_cores=tc)
    held(got, want, 6e-2)


def test_group_sum_in_block_equals_per_head_gradients():
    """dK of a KV head is the sum over its query group of what each query
    head alone contributes: the in-block loop over the group."""
    B, H, Hkv, Sq, Skv, D, causal = CASES["causal GQA 7:1 ragged S=100"]
    q, k, v, dout = case(4, B, H, Hkv, Sq, Skv, D)
    out, (_, dk, dv) = autograd(q, k, v, dout, causal, torch.float32)
    group = H // Hkv
    per = torch.zeros(B, H, Skv, D)
    kr = k.repeat_interleave(group, 1).clone().requires_grad_(True)
    vr = v.repeat_interleave(group, 1).clone().requires_grad_(True)
    tref.mha_attention(q, kr, vr, causal=causal).backward(dout)
    per = kr.grad.reshape(B, Hkv, group, Skv, D).sum(2)
    torch.testing.assert_close(per, dk, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        vr.grad.reshape(B, Hkv, group, Skv, D).sum(2), dv, rtol=1e-5,
        atol=1e-5)


def test_rows_that_see_no_key_get_zero_gradients():
    """Causal Sq = 150 > Skv = 60: the first 90 rows see no key.  The
    model, like autograd through the port's reference, gives them dq = 0
    and finite dk, dv; so does jax.vjp of JAX's reference, whose forward
    output on those rows is NaN."""
    q, k, v, dout = case(5, 1, 4, 2, 150, 60, 64)
    out, want = autograd(q, k, v, dout, True, torch.float32)
    lse = lse_model(q, k, True, 64 ** -0.5, False)
    assert bool(torch.isinf(lse[..., :90]).all())
    got = bwd_model(q, k, v, out, dout, lse, causal=True, scale=64 ** -0.5,
                    bf16=False)
    assert not any(bool(torch.isnan(g).any()) for g in got)
    assert bool((got[0][..., :90, :] == 0).all())
    held(got, want, 1e-5)
    jout, vjp = jax.vjp(lambda a: jref.mha_attention(
        a, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), causal=True),
        jnp.asarray(q.numpy()))
    assert bool(np.isnan(np.asarray(jout)[..., :90, :]).all())
    (jdq,) = vjp(jnp.asarray(dout.numpy()))
    np.testing.assert_array_equal(np.asarray(jdq)[..., :90, :], 0.0)


@pytest.mark.parametrize("causal", [True, False])
def test_tiled_backward_equals_jax_vjp(causal):
    B, H, Hkv, Sq, Skv, D = 1, 6, 2, 90, 90, 64
    q, k, v, dout = case(6, B, H, Hkv, Sq, Skv, D)
    out = tref.mha_attention(q, k, v, causal=causal)
    lse = lse_model(q, k, causal, D ** -0.5, False)
    got = bwd_model(q, k, v, out, dout, lse, causal=causal, scale=D ** -0.5,
                    bf16=False)
    _, vjp = jax.vjp(lambda a, b, c: jref.mha_attention(a, b, c,
                                                        causal=causal),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = [torch.from_numpy(np.array(g))
            for g in vjp(jnp.asarray(dout.numpy()))]
    held(got, want, 1e-5)


SPLIT_SHAPES = {  # Sq, Skv, group, causal
    "qwen2 training S=1024": (1024, 1024, 7, True),
    "qwen2 prefill S=2048": (2048, 2048, 7, True),
    "ragged S=1000": (1000, 1000, 7, True),
    "S=65": (65, 65, 7, True),
    "MHA S=127": (127, 127, 1, True),
    "empty rows Sq=300 Skv=100": (300, 100, 1, True),
    "right-aligned Sq=70 Skv=150": (70, 150, 2, True),
    "non-causal Sq=77 Skv=200": (77, 200, 8, False),
    # D = 128: olmoe-1b-7b's training (MHA), starcoder2-3b's (GQA 12:1)
    "olmoe training S=1024": (1024, 1024, 1, True),
    "starcoder2 training S=1024": (1024, 1024, 12, True),
}


@pytest.mark.parametrize("split", [2, 3])
@pytest.mark.parametrize("name", list(SPLIT_SHAPES))
def test_pairs_are_dealt_evenly_and_once(name, split):
    """Every (head, query tile) pair that sees a key tile goes to exactly
    one warpgroup, and the warpgroups' counts differ by at most one."""
    Sq, Skv, group, causal = SPLIT_SHAPES[name]
    for k0 in range(0, Skv, TILE):
        n_items, qt0 = n_pairs(Sq, Skv, k0, group, causal)
        dealt = [list(range(w, n_items, split)) for w in range(split)]
        assert sorted(i for d in dealt for i in d) == list(range(n_items))
        counts = [len(d) for d in dealt]
        assert max(counts) - min(counts) <= 1
        # the query tiles dealt are those with a row that sees key k0
        if causal:
            assert all(k0 > r + Skv - Sq for r in range(qt0 * TILE))
            assert n_items == 0 or k0 <= min(Sq, (qt0 + 1) * TILE) - 1 \
                + Skv - Sq


@pytest.mark.parametrize("name", list(SPLIT_SHAPES))
def test_key_tiles_are_issued_heaviest_first(name):
    """blockIdx.z is the key tile: its pair count never grows with it, so
    the heaviest blocks start first."""
    Sq, Skv, group, causal = SPLIT_SHAPES[name]
    work = [n_pairs(Sq, Skv, k0, group, causal)[0]
            for k0 in range(0, Skv, TILE)]
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("split,dq_rows", [(2, 128), (3, 128), (2, 64)])
@pytest.mark.parametrize("name", list(CASES))
def test_split_backward_equals_autograd_fp32(name, split, dq_rows):
    """The warpgroups' partial sums, added in a fixed order, and the
    128-row dQ blocks give the gradient in fp32."""
    B, H, Hkv, Sq, Skv, D, causal = CASES[name]
    q, k, v, dout = case(7, B, H, Hkv, Sq, Skv, D)
    out, want = autograd(q, k, v, dout, causal, torch.float32)
    lse = lse_model(q, k, causal, D ** -0.5, False)
    got = bwd_model(q, k, v, out, dout, lse, causal=causal, scale=D ** -0.5,
                    bf16=False, split=split, dq_rows=dq_rows)
    held(got, want, 1e-5)


@pytest.mark.parametrize("name", ["causal GQA 7:1 ragged S=100",
                                  "causal right-aligned Sq=70 Skv=150",
                                  "causal MHA two tiles S=128",
                                  "causal MHA D=128 ragged S=100",
                                  "causal GQA 12:1 D=128 S=70",
                                  "causal right-aligned D=128 Sq=70 Skv=150",
                                  "causal empty rows D=128 Sq=150 Skv=60"])
@pytest.mark.parametrize("cdt", ["fp32", "bf16"])
def test_split_tensor_core_backward_within_the_bf16_bar(name, cdt):
    """The wgmma route's arithmetic: bf16 inputs, P and dS rounded once to
    bf16, two warpgroups a key tile, 128-row dQ blocks; at D = 128 each tile
    in two 64-column halves."""
    B, H, Hkv, Sq, Skv, D, causal = CASES[name]
    q, k, v, dout = case(8, B, H, Hkv, Sq, Skv, D, torch.bfloat16)
    bf16 = cdt == "bf16"
    c = torch.bfloat16 if bf16 else torch.float32
    out, want = autograd(q, k, v, dout, causal, c)
    lse = lse_model(q, k, causal, D ** -0.5, bf16)
    got = bwd_model(q, k, v, out, dout, lse, causal=causal, scale=D ** -0.5,
                    bf16=bf16, tensor_cores=True, split=2, dq_rows=128,
                    half=64 if D == 128 else None)
    held(got, want, 6e-2)
    if causal and Sq > Skv:          # rows that see no key: zero gradient
        assert bool((got[0][..., :Sq - Skv, :] == 0).all())



D128_CASES = [n for n in CASES if CASES[n][5] == 128]


@pytest.mark.parametrize("name", D128_CASES)
def test_halves_backward_equals_autograd_fp32(name):
    """The D = 128 route's structure in fp32: each tile in two 64-column
    halves, the reductions over D half by half in order, one product a half
    where N is D, pairs dealt to two warpgroups with whole-width sums added
    in a fixed order, 128-row dQ blocks: the gradient to 1e-5."""
    B, H, Hkv, Sq, Skv, D, causal = CASES[name]
    q, k, v, dout = case(9, B, H, Hkv, Sq, Skv, D)
    out, want = autograd(q, k, v, dout, causal, torch.float32)
    lse = lse_model(q, k, causal, D ** -0.5, False)
    got = bwd_model(q, k, v, out, dout, lse, causal=causal, scale=D ** -0.5,
                    bf16=False, split=2, dq_rows=128, half=64)
    held(got, want, 1e-5)


@pytest.mark.parametrize("cdt", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["causal MHA D=128 ragged S=100",
                                  "causal GQA 12:1 D=128 S=70",
                                  "causal right-aligned D=128 Sq=70 Skv=150",
                                  "non-causal D=128 Sq=77 Skv=130"])
def test_halves_backward_equals_jax_vjp(name, cdt):
    """The D = 128 route's arithmetic against ``jax.vjp`` of the JAX
    reference: fp32 inputs at 1e-5 (the structure alone), bf16 inputs under
    compute_dtype=bf16 with P and dS rounded once at the bf16 bar."""
    B, H, Hkv, Sq, Skv, D, causal = CASES[name]
    bf16 = cdt == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v, dout = case(10, B, H, Hkv, Sq, Skv, D, dtype)
    out = tref.mha_attention(q, k, v, causal=causal, compute_dtype=dtype)
    lse = lse_model(q, k, causal, D ** -0.5, bf16)
    got = bwd_model(q, k, v, out, dout, lse, causal=causal, scale=D ** -0.5,
                    bf16=bf16, tensor_cores=bf16, split=2, dq_rows=128,
                    half=64)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)  # noqa: E731
    _, vjp = jax.vjp(lambda a, b, c: jref.mha_attention(
        a, b, c, causal=causal, compute_dtype=jdt), j(q), j(k), j(v))
    want = [torch.from_numpy(np.array(g.astype(jnp.float32)))
            for g in vjp(j(dout))]
    held(got, want, 6e-2 if bf16 else 1e-5)


@pytest.mark.parametrize("name", list(SPLIT_SHAPES))
def test_straddle_mask_as_two_comparisons(name):
    """The dK/dV kernel masks only tiles that straddle the diagonal or a
    tail (per warp of 16 keys), and there as two comparisons an element:
    column 2 t4 + cc (cc = 8 j8 + e) of key key0 + 8 h is kept iff cc <
    qrem and dc[h] <= cc, with qrem = Sq - q0 - 2 t4 and dc[h] = +inf past
    Skv, key - offs - 2 t4 - q0 causal, -inf otherwise.  Both equal the
    direct mask (key < Skv, row < Sq, causal key <= row + offs) at every
    (key tile, query tile) pair the kernel visits."""
    Sq, Skv, _, causal = SPLIT_SHAPES[name]
    offs = Skv - Sq
    big = np.iinfo(np.int64).max
    t4 = np.arange(4)[None, :, None, None]          # (key, t4, j8, e)
    cc = (8 * np.arange(8)[:, None] + np.arange(2)[None, :])[None, None]
    for k0 in range(0, Skv, TILE):
        _, qt0 = n_pairs(Sq, Skv, k0, 1, causal)
        for q0 in range(qt0 * TILE, Sq, TILE):
            key = (k0 + np.arange(TILE))[:, None, None, None]
            row = q0 + cc + 2 * t4
            direct = (key < Skv) & (row < Sq)
            if causal:
                direct &= key <= row + offs
            dc = np.where(key >= Skv, big,
                          key - offs - 2 * t4 - q0 if causal else -big)
            assert np.array_equal(direct, (cc < Sq - q0 - 2 * t4) & (dc <= cc))
            for w in range(4):                      # a warp's 16 keys
                key_w = k0 + 16 * w
                straddles = (k0 + TILE > Skv or q0 + TILE > Sq
                             or (causal and key_w + 15 > q0 + offs))
                assert straddles or direct[16 * w:16 * w + 16].all()
