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
* on the tensor-core route (bf16, D = 64) P and dS enter their products
  rounded once to bf16, which stays inside the bf16 bar;
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


def tile_scores(qs, do, kf, vf, lse, di, q0, k0, Sq, Skv, causal, bf16):
    """P and dS of one (query tile, key tile): the kernel's `scores`."""
    s = qs @ kf.T
    dp = rnd(do @ vf.T, bf16)
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


def bwd_model(q, k, v, out, dout, lse, *, causal, scale, bf16,
              tensor_cores=False):
    """The kernel's three passes, tile by tile, in fp32.  ``tensor_cores``
    models the bf16 D = 64 route: P and dS enter their products rounded
    once to bf16."""
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
                acc_k = torch.zeros(TILE, D)
                acc_v = torch.zeros(TILE, D)
                qt0 = max(0, k0 - offs) // TILE if causal else 0
                for h in range(hkv * group, (hkv + 1) * group):
                    for q0 in range(qt0 * TILE, Sq, TILE):
                        qs = pad_rows(rnd(q[b, h].float() * scale, bf16),
                                      q0, Sq)
                        do = pad_rows(dout[b, h].float(), q0, Sq)
                        ls = torch.where(torch.arange(q0, q0 + TILE) < Sq,
                                         pad_rows(lse[b, h], q0, Sq), inf)
                        d_i = pad_rows(di[b, h], q0, Sq)
                        p, ds = tile_scores(qs, do, kf, vf, ls, d_i, q0, k0,
                                            Sq, Skv, causal, bf16)
                        acc_v += rnd(p, bf16 or tensor_cores).T @ do
                        acc_k += rnd(ds, tensor_cores).T @ qs
                n = min(TILE, Skv - k0)
                dk[b, hkv, k0:k0 + n] = rnd(acc_k, bf16)[:n]
                dv[b, hkv, k0:k0 + n] = rnd(acc_v, bf16)[:n]
        for h in range(H):                                # pass 3
            hkv = h // group
            for q0 in range(0, Sq, TILE):
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
                                        Skv, causal, bf16)
                    acc += rnd(ds, tensor_cores) @ kf
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
