"""Recurrent scans of the PyTorch port vs the JAX package.

The port's plain versions (``repro_torch.kernels.ref``: the sequential
oracles and the chunked forms of ``mamba2_scan`` and ``rwkv6_scan``) are
held against ``repro.kernels.ref`` on the same numpy inputs, with and
without initial state, with the final state, on ragged lengths and S = 1;
and against the Pallas kernels in interpret mode on block-divisible shapes
without state, as ``tests/test_kernels.py`` runs them.

Tolerances: the bars of ``tests/test_kernels.py``, fp32 3e-4 and bf16
6e-2 where the output is rounded to bf16.  Where the chunked RWKV6 form
meets the sequential oracle the bar is 2e-3, the one the JAX tests give
that pair: the chunked form recovers each decay product as
exp(sum of log w), which loses a few more digits than multiplying the w's.

The CUDA kernels K3 and K4 run only on the card: see
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba2_scan import \
    mamba2_scan as pallas_mamba2  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.weights import to_torch  # noqa: E402

torch.set_num_threads(1)

TOL = {"f32": dict(rtol=3e-4, atol=3e-4), "bf16": dict(rtol=6e-2, atol=6e-2)}
CHUNKED_RWKV = dict(rtol=2e-3, atol=2e-3)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def pair(a, dt="f32"):
    """The same values as a JAX array and a torch tensor (bit-identical)."""
    j = jnp.asarray(np.asarray(a, np.float32), JDT[dt])
    return j, to_torch(np.asarray(j))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def mamba_inputs(seed, *, B=2, S=37, H=3, dh=8, ds=4, dt="f32",
                 strong=False):
    """(jax args, torch args, (jax h0, torch h0)) of one Mamba2 scan."""
    rng = np.random.default_rng(seed)
    if strong:     # large A*dt: upper-triangle exponents >> 0
        dtv = np.abs(rng.normal(size=(B, S, H))) * 2.0 + 0.5
        A = -np.linspace(1, 16, H)
    else:
        dtv = np.abs(rng.normal(size=(B, S, H))) * 0.1 + 0.01
        A = -np.abs(rng.normal(size=(H,))) - 0.1
    vals = [(rng.normal(size=(B, S, H, dh)), dt), (dtv, dt), (A, "f32"),
            (rng.normal(size=(B, S, ds)), dt), (rng.normal(size=(B, S, ds)), dt),
            (rng.normal(size=(H,)), "f32")]
    ps = [pair(a, d) for a, d in vals]
    h0 = pair(rng.normal(size=(B, H, ds, dh)))
    return [p[0] for p in ps], [p[1] for p in ps], h0


def rwkv_inputs(seed, *, B=2, S=37, H=3, dh=8, dt="f32", decay=(0.5, -1.5)):
    rng = np.random.default_rng(seed)
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, dh)) * decay[0] + decay[1]))
    vals = [(rng.normal(size=(B, S, H, dh)), dt) for _ in range(3)]
    vals += [(w, dt), (rng.normal(size=(H, dh)) * 0.1, "f32")]
    ps = [pair(a, d) for a, d in vals]
    s0 = pair(rng.normal(size=(B, H, dh, dh)))
    return [p[0] for p in ps], [p[1] for p in ps], s0


# ----------------------------------------------------------------------------
# Mamba2 SSD
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("S", [1, 37, 64])
def test_mamba2_oracle_matches_jax(S, state, dt):
    ja, ta, (jh, th) = mamba_inputs(S, S=S, dt=dt)
    jy, jhf = jref.mamba2_scan(*ja, h0=jh if state else None,
                               return_state=True)
    ty, thf = tref.mamba2_scan(*ta, h0=th if state else None,
                               return_state=True)
    assert ty.dtype == ta[0].dtype and thf.dtype == torch.float32
    close(ty, jy, TOL[dt])
    close(thf, jhf, TOL["f32"])


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("S", [1, 53, 128])
def test_mamba2_chunked_matches_jax(S, state, chunk):
    ja, ta, (jh, th) = mamba_inputs(100 + S, S=S)
    jy, jhf = jref.mamba2_scan_chunked(*ja, h0=jh if state else None,
                                       return_state=True, chunk=chunk)
    ty, thf = tref.mamba2_scan_chunked(*ta, h0=th if state else None,
                                       return_state=True, chunk=chunk)
    close(ty, jy, TOL["f32"])
    close(thf, jhf, TOL["f32"])


@pytest.mark.parametrize("chunk", [8, 16, 64, 128])
def test_mamba2_chunked_matches_oracle_at_any_chunk(chunk):
    """The chunked closed form does not depend on the chunk size."""
    _, ta, (_, th) = mamba_inputs(7, S=100)
    y0, h0 = tref.mamba2_scan(*ta, h0=th, return_state=True)
    y1, h1 = tref.mamba2_scan_chunked(*ta, h0=th, return_state=True,
                                      chunk=chunk)
    close(y1, y0.numpy(), TOL["f32"])
    close(h1, h0.numpy(), TOL["f32"])


def test_mamba2_chunked_strong_decay_stays_finite():
    """The exponent is masked before exp: the upper triangle's large
    positive exponents must not become inf * 0 = NaN."""
    ja, ta, _ = mamba_inputs(3, B=2, S=40, H=4, dh=8, ds=8, strong=True)
    y = tref.mamba2_scan_chunked(*ta, chunk=16)
    assert torch.isfinite(y).all()
    close(y, tref.mamba2_scan(*ta).numpy(), dict(rtol=1e-3, atol=1e-3))
    close(y, jref.mamba2_scan_chunked(*ja, chunk=16), TOL["f32"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,dh,ds,chunk", [(2, 128, 3, 32, 16, 32),
                                               (1, 64, 2, 16, 8, 64)])
def test_mamba2_plain_matches_pallas_interpret(B, S, H, dh, ds, chunk, dt):
    ja, ta, _ = mamba_inputs(S + dh, B=B, S=S, H=H, dh=dh, ds=ds, dt=dt)
    want = pallas_mamba2(*ja, chunk=chunk, interpret=True)
    got = ops.mamba2_scan(*ta)
    assert got.dtype == ta[0].dtype
    close(got, want, TOL[dt])


# ----------------------------------------------------------------------------
# RWKV6 wkv
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("S", [1, 37, 64])
def test_rwkv6_oracle_matches_jax(S, state, dt):
    ja, ta, (js, ts) = rwkv_inputs(S, S=S, dt=dt)
    jy, jsf = jref.rwkv6_scan(*ja, s0=js if state else None,
                              return_state=True)
    ty, tsf = tref.rwkv6_scan(*ta, s0=ts if state else None,
                              return_state=True)
    assert ty.dtype == ta[0].dtype and tsf.dtype == torch.float32
    close(ty, jy, TOL[dt])
    close(tsf, jsf, TOL["f32"])


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("S", [1, 53, 128])
def test_rwkv6_chunked_matches_jax(S, state, chunk):
    ja, ta, (js, ts) = rwkv_inputs(200 + S, S=S)
    jy, jsf = jref.rwkv6_scan_chunked(*ja, s0=js if state else None,
                                      return_state=True, chunk=chunk)
    ty, tsf = tref.rwkv6_scan_chunked(*ta, s0=ts if state else None,
                                      return_state=True, chunk=chunk)
    close(ty, jy, TOL["f32"])
    close(tsf, jsf, TOL["f32"])


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_rwkv6_chunked_matches_oracle_at_any_chunk(chunk):
    _, ta, (_, ts) = rwkv_inputs(9, S=90)
    y0, s0 = tref.rwkv6_scan(*ta, s0=ts, return_state=True)
    y1, s1 = tref.rwkv6_scan_chunked(*ta, s0=ts, return_state=True,
                                     chunk=chunk)
    close(y1, y0.numpy(), CHUNKED_RWKV)
    close(s1, s0.numpy(), CHUNKED_RWKV)


def test_rwkv6_chunked_strong_decay_stays_finite():
    """w underflowing to 0 (decay ~ e^-400) and denormal w: the floor
    before log keeps log(0) = -inf out of the exclusive cumulative sum."""
    ja, ta, _ = rwkv_inputs(11, S=53, decay=(2.0, 1.0))
    r, k, v, w, u = ta
    assert (w == 0).any()
    w = w.clone()
    w[0, :3] = 1e-40                     # denormal in fp32
    y = tref.rwkv6_scan_chunked(r, k, v, w, u, chunk=16)
    assert torch.isfinite(y).all()
    close(y, tref.rwkv6_scan(r, k, v, w, u).numpy(),
          dict(rtol=5e-3, atol=5e-3))
    close(tref.rwkv6_scan_chunked(*ta, chunk=16),
          jref.rwkv6_scan_chunked(*ja, chunk=16), TOL["f32"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,dh,chunk", [(2, 128, 2, 16, 64),
                                            (1, 32, 3, 8, 32)])
def test_rwkv6_plain_matches_pallas_interpret(B, S, H, dh, chunk, dt):
    ja, ta, _ = rwkv_inputs(S + dh, B=B, S=S, H=H, dh=dh, dt=dt)
    want = pallas_rwkv6(*ja, chunk=chunk, interpret=True)
    got = ops.rwkv6_scan(*ta)
    assert got.dtype == ta[0].dtype
    tol = TOL[dt] if dt == "bf16" else CHUNKED_RWKV  # chunked vs sequential
    close(got, want, tol)


# ----------------------------------------------------------------------------
# dispatch on the CPU
# ----------------------------------------------------------------------------

def test_ops_scans_take_the_chunked_plain_versions_on_cpu():
    _, ta, (_, th) = mamba_inputs(21, S=70)
    got = ops.mamba2_scan(*ta, h0=th, return_state=True)
    want = tref.mamba2_scan_chunked(*ta, h0=th, return_state=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    _, ta, (_, ts) = rwkv_inputs(22, S=70)
    got = ops.rwkv6_scan(*ta, s0=ts, return_state=True)
    want = tref.rwkv6_scan_chunked(*ta, s0=ts, return_state=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("scan", ["mamba2", "rwkv6"])
def test_ops_scans_split_into_two_calls_match_one(scan):
    """State out of the first part, in to the second: the same output and
    final state as one call over the whole sequence (prefill, then more)."""
    cut = 41
    if scan == "mamba2":
        _, (x, dt, A, Bm, Cm, D), (_, h0) = mamba_inputs(23, S=90)
        run = lambda sl, h: ops.mamba2_scan(x[:, sl], dt[:, sl], A, Bm[:, sl],
                                            Cm[:, sl], D, h0=h,
                                            return_state=True)
        tol = TOL["f32"]
    else:
        _, (r, k, v, w, u), (_, h0) = rwkv_inputs(24, S=90)
        run = lambda sl, s: ops.rwkv6_scan(r[:, sl], k[:, sl], v[:, sl],
                                           w[:, sl], u, s0=s,
                                           return_state=True)
        tol = CHUNKED_RWKV    # the chunk boundaries move with the cut
    y, h = run(slice(None), h0)
    y1, h1 = run(slice(0, cut), h0)
    y2, h2 = run(slice(cut, None), h1)
    close(torch.cat([y1, y2], 1), y.numpy(), tol)
    close(h2, h.numpy(), tol)


def test_ops_scans_refuse_other_devices():
    """The CPU, the card and meta (the dry run's route) have routes; any
    other device raises (stand-ins carrying only ``.device``: this build
    of PyTorch makes tensors on no other device)."""
    other = types.SimpleNamespace(device=torch.device("mps"))
    _, ta, _ = rwkv_inputs(25, S=4)
    with pytest.raises(ValueError, match="no implementation"):
        ops.rwkv6_scan(other, *ta[1:])
    _, ta, _ = mamba_inputs(26, S=4)
    with pytest.raises(ValueError, match="no implementation"):
        ops.mamba2_scan(other, *ta[1:])
