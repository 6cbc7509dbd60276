"""The numerical arguments behind the K3 and K4 designs, on the CPU.

The CUDA kernels run only on the card; these tests pin, with test-local
models of their arithmetic (not code of the main path), the claims their
designs rest on:

* K4 (``rwkv6_scan_mma_kernel``, chunks of 64 steps, sub-chunks of 16): the
  intra-chunk scores factored through a reference step, both factors <= 1
  (off-diagonal sub-chunk pairs through the last step of the earlier
  sub-chunk, the lower-left 8 x 8 quadrant of a diagonal block through the
  step before it), the 8 x 8 diagonal blocks by running products of w, the
  inter-chunk term and the state update, equal the sequential oracles of
  both packages and ``repro_torch.kernels.ref.rwkv6_scan_chunked`` on
  strong decays, w = 0, denormal w, ragged S and a state in.  A single
  reference at the chunk's start overflows fp32 on the same inputs.
* The rounding of the tensor-core operands: an fp32 operand goes in as
  bf16 hi + lo, three products where both sides are fp32 (K4's factored
  scores and r'' S_in), two where one side is exact bf16 (K4's A V and
  state update; K3's C h, att X and state update).  At the timed shapes'
  statistics (S = 1024, two heads) that holds chip_smoke's bars; one
  bf16 rounding of any one of those operands does not.
* K4's decode kernel (S = 1): the state split into column groups equals
  the oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)

# chip_smoke.py's scan bars: outputs 2^-6 |want| + 2^-12 max|want|,
# final states 1e-4 |want| + 1e-4 max|want|
OUT_REL, OUT_ABS = 2.0 ** -6, 2.0 ** -12
STATE_REL, STATE_ABS = 1e-4, 1e-4
L, SUB = 64, 16            # the kernels' chunk and K4's sub-chunk
SPLIT_K4 = dict(scores="ab", rs="ab", av="a", state="a")
SPLIT_K3 = dict(ch="b", ax="a", state="a")


# ----------------------------------------------------------------------------
# test-local models of the kernels' arithmetic (one batch row and head)
# ----------------------------------------------------------------------------

def rnd(x):
    return x.to(torch.bfloat16).to(x.dtype)


def trunc(x):
    """fp32 x cut to its bf16 part (the low 16 bits cleared): the kernels'
    hi, one bit-mask and no conversion; x - trunc(x) is exact."""
    return (x.float().view(torch.int32) & -65536).view(torch.float32)


def mm(a, b, mode):
    """a @ b as the kernels' tensor-core products: bf16 operands, fp32
    sums.  mode: "exact" (float64 throughout), "one" (each side rounded
    once to nearest), "a" / "b" (that side as hi + lo, hi = trunc(x), lo =
    bf16(x - hi): two products), "ab" (both sides split: hi hi + hi lo +
    lo hi).  An exact bf16 side passes through trunc unchanged."""
    if mode == "exact":
        return a.double() @ b.double()
    a, b = a.float(), b.float()
    if mode == "one":
        return rnd(a) @ rnd(b)
    ah, bh = trunc(a), trunc(b)
    al, bl = rnd(a - ah), rnd(b - bh)
    return {"a": lambda: ah @ bh + al @ bh,
            "b": lambda: ah @ bh + ah @ bl,
            "ab": lambda: ah @ bh + ah @ bl + al @ bh}[mode]()


def k4_model(r, k, v, w, u, s0, modes, *, dtype=torch.float32,
             reference="sub"):
    """K4's chunk arithmetic for one head: r, k, v, w (S, dh); u (dh,); s0
    (dh, dh) or None -> y (S, dh), final state.  ``reference="start"``
    factors every score through the chunk's start instead."""
    r, k, v, w, u = (t.to(dtype) for t in (r, k, v, w, u))
    S, dh = r.shape
    st = (torch.zeros(dh, dh, dtype=dtype) if s0 is None
          else s0.to(dtype).clone())
    ys = []
    for c0 in range(0, S, L):
        n = min(L, S - c0)

        def pad(t, val):
            return torch.cat([t[c0:c0 + n],
                              torch.full((L - n, dh), val, dtype=dtype)])

        rc, kc, vc, wc = pad(r, 0.), pad(k, 0.), pad(v, 0.), pad(w, 1.)
        lw = torch.log2(torch.clamp_min(wc, 1e-30))
        cumE = torch.cat([torch.zeros(1, dh, dtype=dtype),
                          torch.cumsum(lw, 0)])        # cumE[t + 1] = cum_t

        def factored(rows, cols, q):
            """scores of rows x cols through the reference cumE row q."""
            ref = cumE[q] if reference == "sub" else cumE[0]
            rp = rc[rows] * torch.exp2(cumE[rows] - ref)
            kp = kc[cols] * torch.exp2(ref - cumE[cols.start + 1:
                                                  cols.stop + 1])
            return mm(rp, kp.T, modes["scores"]).to(dtype)

        A = torch.zeros(L, L, dtype=dtype)
        for a in range(L // SUB):
            t0 = SUB * a
            for b in range(a):
                A[t0:t0 + SUB, SUB * b:SUB * b + SUB] = factored(
                    slice(t0, t0 + SUB), slice(SUB * b, SUB * b + SUB),
                    SUB * b + SUB)
            A[t0 + 8:t0 + SUB, t0:t0 + 8] = factored(
                slice(t0 + 8, t0 + SUB), slice(t0, t0 + 8), t0 + 8)
            for blk in (t0, t0 + 8):       # exact: running products of w
                for t in range(blk, blk + 8):
                    A[t, t] = (rc[t] * u * kc[t]).sum()
                    f = rc[t].clone()
                    for j in range(t - 1, blk - 1, -1):
                        A[t, j] = (f * kc[j]).sum()
                        f = f * wc[j]
        y = mm(A, vc, modes["av"]).to(dtype) \
            + mm(rc * torch.exp2(cumE[:L]), st, modes["rs"]).to(dtype)
        kl = kc * torch.exp2(cumE[L] - cumE[1:])
        st = torch.exp2(cumE[L])[:, None] * st \
            + mm(kl.T, vc, modes["state"]).to(dtype)
        ys.append(y[:n])
    return torch.cat(ys), st


def k3_model(x, dt, a, Bm, Cm, d, h0, modes):
    """K3's chunk arithmetic for one head: x (S, dh); dt (S,); a, d
    scalars; Bm, Cm (S, ds); h0 (ds, dh) or None."""
    S, dh = x.shape
    ds = Bm.shape[1]
    x, Bm, Cm = x.float(), Bm.float(), Cm.float()
    h = torch.zeros(ds, dh) if h0 is None else h0.float().clone()
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    ys = []
    for c0 in range(0, S, L):
        n = min(L, S - c0)

        def pad(t):
            return torch.cat([t[c0:c0 + n],
                              t.new_zeros((L - n,) + t.shape[1:])])

        xc, dtc, bc, cc = pad(x), pad(dt.float()), pad(Bm), pad(Cm)
        s = torch.cumsum(a * dtc, 0)
        G = mm(cc, bc.T, modes.get("g", "one"))  # both sides exact bf16
        ex = torch.where(tri, s[:, None] - s[None, :],
                         torch.tensor(-float("inf")))
        att = G * torch.exp(ex) * dtc[None, :]
        y = mm(cc, h, modes["ch"]) * torch.exp(s)[:, None] \
            + mm(att, xc, modes["ax"]) + d * xc
        wd = torch.exp(s[-1] - s) * dtc
        h = torch.exp(s[-1]) * h + mm((bc * wd[:, None]).T, xc,
                                      modes["state"])
        ys.append(y[:n])
    return torch.cat(ys), h


def ratio(got, want, rel, ab):
    """max |got - want| / (rel |want| + ab max|want|): <= 1 holds the bar."""
    w = want.float()
    return float(((got.float() - w).abs()
                  / (rel * w.abs() + ab * float(w.abs().max()))).max())


# ----------------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------------

def rwkv_inputs(seed, S, H=2, *, decay="slow", state=True):
    """r, k, v, w (1, S, H, 64), u (H, 64), s0 (1, H, 64, 64) as numpy
    float32 (bf16-representable where the kernel takes bf16)."""
    rng = np.random.default_rng(seed)
    bf = lambda a: rnd(torch.from_numpy(a.astype(np.float32))).numpy()
    r, k, v = (bf(rng.normal(size=(1, S, H, 64))) for _ in range(3))
    if decay == "slow":          # rwkv6's w0 ~ -3: chip_smoke's rwkv_case
        w = np.exp(-np.exp(-3.0 + 0.5 * rng.normal(size=(1, S, H, 64))))
    else:                        # strong, with w = 0 and denormal w
        w = np.exp(-np.exp(2.0 * rng.normal(size=(1, S, H, 64)) + 1.0))
        w[:, 5:9] = 0.0
        w[:, 40:44] = 1e-39
        w[:, 70:72, :, :32] = 1e-42
    w = bf(w)
    u = (0.1 * rng.normal(size=(H, 64))).astype(np.float32)
    s0 = (rng.normal(size=(1, H, 64, 64)).astype(np.float32)
          if state else None)
    return r, k, v, w, u, s0


def k4_heads(inputs, modes, **kw):
    r, k, v, w, u, s0 = (None if a is None else torch.from_numpy(a)
                         for a in inputs)
    ys, sts = [], []
    for h in range(r.shape[2]):
        y, st = k4_model(r[0, :, h], k[0, :, h], v[0, :, h], w[0, :, h],
                         u[h], None if s0 is None else s0[0, h], modes,
                         **kw)
        ys.append(y)
        sts.append(st)
    return torch.stack(ys, 1)[None], torch.stack(sts)[None]


def torch_args(inputs, dtype=torch.float32):
    r, k, v, w, u, s0 = inputs
    t = lambda a: torch.from_numpy(a).to(dtype)
    return (t(r), t(k), t(v), t(w), torch.from_numpy(u),
            None if s0 is None else torch.from_numpy(s0))


# ----------------------------------------------------------------------------
# K4: the factored form
# ----------------------------------------------------------------------------

K4_CASES = {
    "slow decay, S=150, state in": (1, 150, "slow", True),
    "strong decay with w=0 and denormal w, S=200, state in":
        (2, 200, "strong", True),
    "strong decay, S=64, no state": (3, 64, "strong", False),
    "slow decay, S=15 (one partial sub-chunk)": (4, 15, "slow", True),
}


def oracle64(r, k, v, w, u, s0):
    """The wkv recurrence stepped in float64: the reference the fp32
    versions approximate."""
    r, k, v, w, u = (torch.as_tensor(a).double() for a in (r, k, v, w, u))
    B, S, H, dh = r.shape
    st = (torch.zeros(B, H, dh, dh, dtype=torch.float64) if s0 is None
          else torch.as_tensor(s0).double())
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               st + u[None, :, :, None] * kv))
        st = st * w[:, t, :, :, None] + kv
    return torch.stack(ys, 1), st


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_factored_form_matches_oracles(case):
    """The kernel's factorisation, computed in float64, is the recurrence:
    it equals the float64 oracle to 1e-12, the fp32 oracles of both
    packages to their fp32 rounding (1e-6 of the largest magnitude), and
    the port's fp32 chunked plain version to 5e-5 (that form recovers each
    decay product as exp(sum log w): 2.6e-5 from the float64 oracle on
    these strong decays)."""
    seed, S, decay, state = K4_CASES[case]
    inputs = rwkv_inputs(seed, S, decay=decay, state=state)
    y, st = k4_heads(inputs, dict.fromkeys(SPLIT_K4, "exact"),
                     dtype=torch.float64)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    r, k, v, w, u, s0 = torch_args(inputs)
    jy, js = jref.rwkv6_scan(*(jnp.asarray(a) for a in inputs[:5]),
                             s0=None if s0 is None else jnp.asarray(
                                 inputs[5]), return_state=True)
    want = [("float64 oracle", oracle64(*inputs), 1e-12),
            ("port oracle", tref.rwkv6_scan(r, k, v, w, u, s0=s0,
                                            return_state=True), 1e-6),
            ("jax oracle", (np.array(jy), np.array(js)), 1e-6),
            ("port chunked", tref.rwkv6_scan_chunked(
                r, k, v, w, u, s0=s0, return_state=True), 5e-5)]
    for name, (wy, ws), tol in want:
        wy, ws = torch.as_tensor(wy).double(), torch.as_tensor(ws).double()
        ey = float((y - wy).abs().max() / wy.abs().max())
        es = float((st - ws).abs().max() / ws.abs().max())
        assert ey <= tol and es <= tol, (name, ey, es)


def test_k4_chunk_start_reference_overflows():
    """One reference at the chunk's start: k_j 2^(-cum_j) passes fp32's
    range two steps after a w of 1e-30, and inf times an underflowed 0
    gives NaN.  The sub-chunk references keep both factors <= 1."""
    inputs = rwkv_inputs(2, 200, decay="strong")
    exact = dict.fromkeys(SPLIT_K4, "exact")
    y, _ = k4_heads(inputs, exact, reference="start")
    assert not torch.isfinite(y).all()
    y, st = k4_heads(inputs, exact)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


# ----------------------------------------------------------------------------
# rounding of the tensor-core operands, at the timed shapes' statistics
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k4_timed():
    """rwkv6's prefill statistics: S = 1024, two heads, bf16 inputs, a
    state in; the plain version's output (bf16) and state."""
    inputs = rwkv_inputs(7, 1024)
    r, k, v, w, u, s0 = torch_args(inputs, torch.bfloat16)
    want = tref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0, return_state=True)
    return inputs, want


def held_k4(inputs, want, modes):
    y, st = k4_heads(inputs, modes)
    return (ratio(y.bfloat16(), want[0], OUT_REL, OUT_ABS),
            ratio(st, want[1], STATE_REL, STATE_ABS))


def test_k4_splits_hold_chip_smoke_bars(k4_timed):
    ry, rs = held_k4(*k4_timed, SPLIT_K4)
    assert ry <= 1 and rs <= 1, (ry, rs)


@pytest.mark.parametrize("product", [None, *SPLIT_K4])
def test_k4_one_rounding_misses_chip_smoke_bars(k4_timed, product):
    """Every operand rounded once (None), or one product's operands only
    (three products down to one, or two products down to one; for r'' S_in
    also two products, the state rounded once): a bar is missed."""
    variants = ([dict.fromkeys(SPLIT_K4, "one")] if product is None
                else [{**SPLIT_K4, product: "one"}])
    if product == "rs":
        variants.append({**SPLIT_K4, "rs": "a"})
    for modes in variants:
        ry, rs = held_k4(*k4_timed, modes)
        assert ry > 1 or rs > 1, (modes, ry, rs)


@pytest.fixture(scope="module")
def k3_timed():
    """zamba2's prefill statistics: S = 1024, two heads at the ends of the
    timed A range (-1, -16), softplus-ed dt, bf16 x/B/C, a state in."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(2)
    rn = lambda *s: torch.randn(*s, generator=g)
    x = rn(1, 1024, 2, 64).bfloat16()
    dt = F.softplus(rn(1, 1024, 2))
    A = torch.tensor([-1.0, -16.0])
    Bm, Cm = rn(1, 1024, 64).bfloat16(), rn(1, 1024, 64).bfloat16()
    D = torch.ones(2)
    h0 = rn(1, 2, 64, 64)
    want = tref.mamba2_scan_chunked(x, dt, A, Bm, Cm, D, h0=h0,
                                    return_state=True)
    return (x, dt, A, Bm, Cm, D, h0), want


def held_k3(args, want, modes):
    x, dt, A, Bm, Cm, D, h0 = args
    ys, hs = [], []
    for h in range(x.shape[2]):
        y, hh = k3_model(x[0, :, h], dt[0, :, h], A[h], Bm[0], Cm[0], D[h],
                         h0[0, h], modes)
        ys.append(y.bfloat16())
        hs.append(hh)
    y, hh = torch.stack(ys, 1)[None], torch.stack(hs)[None]
    return (ratio(y, want[0], OUT_REL, OUT_ABS),
            ratio(hh, want[1], STATE_REL, STATE_ABS))


def test_k3_splits_hold_chip_smoke_bars(k3_timed):
    ry, rs = held_k3(*k3_timed, SPLIT_K3)
    assert ry <= 1 and rs <= 1, (ry, rs)


@pytest.mark.parametrize("product", [None, *SPLIT_K3])
def test_k3_one_rounding_misses_chip_smoke_bars(k3_timed, product):
    modes = (dict.fromkeys(SPLIT_K3, "one") if product is None
             else {**SPLIT_K3, product: "one"})
    ry, rs = held_k3(*k3_timed, modes)
    assert ry > 1 or rs > 1, (modes, ry, rs)


@pytest.mark.parametrize("S", [1, 70, 130])
def test_k3_chunk_form_matches_oracles(S):
    """K3's per-chunk arithmetic, unrounded, equals the sequential oracles
    of both packages on a ragged S with a state in (fp32 sums: 1e-5 of the
    largest magnitude)."""
    rng = np.random.default_rng(S)
    x = rng.normal(size=(1, S, 2, 64)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(1, S, 2))) * 0.5 + 0.01).astype(np.float32)
    A = np.array([-1.0, -8.0], np.float32)
    Bm, Cm = (rng.normal(size=(1, S, 64)).astype(np.float32)
              for _ in range(2))
    D = np.array([1.0, 0.5], np.float32)
    h0 = rng.normal(size=(1, 2, 64, 64)).astype(np.float32)
    exact = dict.fromkeys([*SPLIT_K3, "g"], "exact")
    ys, hs = [], []
    for h in range(2):
        y, hh = k3_model(torch.from_numpy(x[0, :, h]),
                         torch.from_numpy(dt[0, :, h]), float(A[h]),
                         torch.from_numpy(Bm[0]), torch.from_numpy(Cm[0]),
                         float(D[h]), torch.from_numpy(h0[0, h]), exact)
        ys.append(y)
        hs.append(hh)
    y, hh = torch.stack(ys, 1)[None], torch.stack(hs)[None]
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)]
    ty, th = tref.mamba2_scan(*args, h0=torch.from_numpy(h0),
                              return_state=True)
    jy, jh = jref.mamba2_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm,
                                                         D)),
                              h0=jnp.asarray(h0), return_state=True)
    for wy, wh in ((ty, th), (np.array(jy), np.array(jh))):
        wy, wh = torch.as_tensor(wy).double(), torch.as_tensor(wh).double()
        assert float((y.double() - wy).abs().max()) <= 1e-5 * float(
            wy.abs().max())
        assert float((hh.double() - wh).abs().max()) <= 1e-5 * float(
            wh.abs().max())


# ----------------------------------------------------------------------------
# K4's decode step: the state split into column groups
# ----------------------------------------------------------------------------

def k4_decode_model(r, k, v, w, u, s0, groups=4):
    """S = 1 with the state's columns in ``groups`` independent groups,
    as the decode kernel's blocks take them: y[j] = sum_i r_i (S_ij + u_i
    k_i v_j), S'_ij = w_i S_ij + k_i v_j."""
    B, _, H, dh = r.shape
    ri, ki, wi = r[:, 0], k[:, 0], w[:, 0]                 # (B, H, dh)
    y = torch.empty(B, 1, H, dh)
    s_out = torch.empty(B, H, dh, dh)
    width = dh // groups
    for grp in range(groups):
        cols = slice(grp * width, grp * width + width)
        vj = v[:, 0, :, cols]                                # (B, H, w)
        kv = ki[..., :, None] * vj[..., None, :]             # (B, H, dh, w)
        st = s0[..., cols]
        y[:, 0, :, cols] = torch.einsum(
            "bhi,bhij->bhj", ri, st + u[None, :, :, None] * kv)
        s_out[..., cols] = st * wi[..., None] + kv
    return y, s_out


def test_k4_decode_column_split_matches_oracles():
    inputs = rwkv_inputs(11, 1, H=4)
    r, k, v, w, u, s0 = torch_args(inputs)
    y, st = k4_decode_model(r, k, v, w, u, s0)
    ty, ts = tref.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
    jy, js = jref.rwkv6_scan(*(jnp.asarray(a) for a in inputs[:5]),
                             s0=jnp.asarray(inputs[5]), return_state=True)
    for wy, ws in ((ty, ts), (np.array(jy), np.array(js))):
        wy, ws = torch.as_tensor(wy), torch.as_tensor(ws)
        torch.testing.assert_close(y, wy, rtol=1e-6, atol=1e-6 * float(
            wy.abs().max()))
        torch.testing.assert_close(st, ws, rtol=1e-6, atol=1e-6 * float(
            ws.abs().max()))
