"""The arithmetic of the chunk-parallel backward kernels (the bf16 routes of
K3-bwd and K4-bwd), as CPU models, held to float64 autograd.

Both kernels split the sequence into chunks of L = 64 steps and run in
three phases, sequential only between chunks:

  A. the state at every chunk's start (K3's h_in, K4's S_in): each chunk's
     own contribution is one 64 x 64 x 64 product, the forward's chunk-state
     product (K3: (B o wd)^T X; K4: (k o 2^(cum_L - cum))^T V), and a walk
     over the chunks adds them with the chunk's decay;
  B. the state gradient at every chunk's end (G_out), the same way
     backwards (K3: C^T diag(e^s) dY; K4: (r o 2^cumx)^T dY, every factor
     at most 1);
  C. each chunk's gradients from its h_in / S_in and G_out alone, every
     chunk independent of the others.  K3 as L x L and L x 64 products;
     its decay gradient exp(a_t) <G_t, h_{t-1}> in the direct form split
     exactly over the chunk (four terms, every exponent <= 0, nothing
     subtracted):
        e^{s_L} <G_out, h_in>                      (T1)
      + sum_{tau < t} wd_tau (B_tau^T G_out x_tau)  (T2)
      + sum_{m >= t} e^{s_m} (C_m^T h_in . dy_m)   (T3)
      + sum_{m >= t} sum_{tau < t} att[m, tau] (dy_m . x_tau)   (T4,
        a row prefix over tau, then a column suffix over m).
     K4 steps S_{t-1} forwards from S_in and G_t backwards from G_out
     inside the chunk, and takes dw_t = rowsum(G_t o S_{t-1}) (0 where
     w < 1e-30) with dr, dk, dv from the same states.

``k3_design`` and ``k4_design`` model those phases (every batch row, head
and chunk at once).  ``modes`` says how each tensor-core product rounds its
operands (``mm``: exact, one bf16 rounding, or an fp32 side as bf16 hi +
lo).  They are held to autograd through the sequential recurrences in
float64 on the cases of ``tests/test_torch_scan_bwd.py`` and the chunk
edges S = 63, 64, 65, 130 (float64 within 1e-10 of max|want|, fp32 within
the fp32 bar 3e-4), with K4's strong decay (w = 0 and denormal w) and
K3's strided mixer views among them.  Then, at the training shapes'
statistics (dh = ds = 64, S = 1024): the chosen splits hold chip_smoke's
bf16 bar against the plain backward, and so does every product rounded
once; the four-term decomposition of K3's decay gradient gives dA within
2e-6 of max|dA| of the direct form, and the reverse-cumsum identity (the
usual chunked SSD backward) more than ten times further; K4's direct dw holds where the log-decay
identity divides its rounding by w.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ref as tref  # noqa: E402

L = 64                  # the kernels' chunk
BAR = {"f32": 3e-4, "bf16": 6e-2}
F64_BAR = 1e-10
FLOOR_W = 1e-30
# K3's tensor-core products and the side of each that is fp32 (split as
# bf16 hi + lo: "a" the left side, "b" the right); the other side is a
# bf16 input, exact.  CB = C B^T and DYX = dY X^T have both sides exact.
SPLIT_K3 = dict(
    state="a",       # A: (B o wd)^T X           B o wd fp32
    grad="b",        # B: C^T (e^s o dY)         e^s o dY fp32
    att_dy="a",      # C: att^T dY  (dx)         att fp32
    b_gout="b",      #    B G_out   (dx)         G_out fp32
    m_c="a",         #    M^T C     (dB)         M fp32
    x_gout="b",      #    X G_out^T (dB, T2)     G_out fp32
    dy_hin="b",      #    dY h_in^T (dC, T3)     h_in fp32
    m_b="a")         #    M B       (dC)         M fp32
SPLIT_K4 = dict(state="a",   # A: (k o 2^(cum_L - cum))^T V
                grad="a")    # B: (r o 2^cumx)^T dY


def within(got, want, bar, what=""):
    got = got.double() if isinstance(got, torch.Tensor) else \
        torch.as_tensor(np.asarray(got, np.float64))
    want = want.double()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= bar * scale, (what, err, scale, err / (bar * scale))


def err_ratio(got, want, bar):
    w = want.double()
    return float((got.double() - w).abs().max()) / (
        bar * float(w.abs().max()))


# ----------------------------------------------------------------------------
# tensor-core products
# ----------------------------------------------------------------------------

def rnd(x):
    return x.to(torch.bfloat16).to(x.dtype)


def trunc(x):
    """fp32 x cut to its bf16 part (the low 16 bits cleared): the kernels'
    hi; x - trunc(x) is exact in fp32."""
    return (x.float().view(torch.int32) & -65536).view(torch.float32)


def mm(a, b, mode):
    """a @ b (batched) as a tensor-core product: bf16 operands, sums in the
    inputs' dtype.  mode: "exact" (no rounding: the float64 and fp32
    models), "one" (each side rounded once to bf16), "a" / "b" (that side
    as hi + lo, hi = trunc(x), lo = bf16(x - hi): two products; the other
    side is taken as it is, a bf16 input)."""
    if mode == "exact":
        return a @ b
    a, b = a.float(), b.float()
    if mode == "one":
        return rnd(a) @ rnd(b)
    if mode == "a":
        ah = trunc(a)
        return ah @ rnd(b) + rnd(a - ah) @ rnd(b)
    bh = trunc(b)
    return rnd(a) @ bh + rnd(a) @ rnd(b - bh)


# ----------------------------------------------------------------------------
# K3-bwd, the chunked design
# ----------------------------------------------------------------------------

def chunks(t, S_pad, fill=0.0):
    """(B, S, ...) -> (B, nC, L, ...), padded past S with ``fill``."""
    B, S = t.shape[:2]
    pad = t.new_full((B, S_pad - S) + tuple(t.shape[2:]), fill)
    t = torch.cat([t, pad], 1)
    return t.reshape((B, S_pad // L, L) + tuple(t.shape[2:]))


def k3_design(x, dt, A, Bm, Cm, D, dy, h0=None, dh_out=None, modes=None,
              decay="four_terms"):
    """K3-bwd's bf16 route in the inputs' dtype -> (dx, ddt, dA, dB, dC,
    dD, dh0).  Steps past S are the forward's padding (dt = 0: decay 1,
    nothing injected).  ``decay="identity"`` takes a_t's gradient as the
    usual chunked SSD backward does, the suffix sums over every later step
    of <dy_m, C_m . h_m> - dt_m B_m^T G_m x_m plus <dh_out, h_T>."""
    modes = dict.fromkeys(SPLIT_K3, "exact") if modes is None else modes
    f = x.dtype
    B, S, H, dh = x.shape
    ds = Bm.shape[-1]
    nC = -(-S // L)
    Sp = nC * L
    # (B, H, nC, L, ...) per head; B and C are shared by the heads
    X = chunks(x.contiguous(), Sp).permute(0, 3, 1, 2, 4)
    DY = chunks(dy.contiguous(), Sp).permute(0, 3, 1, 2, 4)
    DT = chunks(dt, Sp).permute(0, 3, 1, 2)
    Bc = chunks(Bm.contiguous(), Sp)[:, None]
    Cc = chunks(Cm.contiguous(), Sp)[:, None]
    s = torch.cumsum(A[None, :, None, None] * DT, -1)   # inclusive
    sL = s[..., -1:]
    es = torch.exp(s)
    decL = torch.exp(sL - s)
    wd = decL * DT
    # -- A. chunk-start states
    loc_h = mm((Bc * wd[..., None]).transpose(-1, -2), X, modes["state"])
    h_in = torch.empty_like(loc_h)
    h = torch.zeros((B, H, ds, dh), dtype=f) if h0 is None else h0
    for c in range(nC):
        h_in[:, :, c] = h
        h = torch.exp(sL[:, :, c, 0])[..., None, None] * h + loc_h[:, :, c]
    h_T = h
    # -- B. chunk-end state gradients, walking backwards
    loc_g = mm(Cc.transpose(-1, -2).expand(B, H, nC, ds, L),
               es[..., None] * DY, modes["grad"])
    g_out = torch.empty_like(loc_g)
    g = torch.zeros((B, H, ds, dh), dtype=f) if dh_out is None else dh_out
    for c in reversed(range(nC)):
        g_out[:, :, c] = g
        g = torch.exp(sL[:, :, c, 0])[..., None, None] * g + loc_g[:, :, c]
    dh0 = g
    # -- C. every chunk alone
    CB = Cc @ Bc.transpose(-1, -2)                      # [m, tau]
    DYX = DY @ X.transpose(-1, -2)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    ex = torch.where(tri, s[..., :, None] - s[..., None, :],
                     torch.tensor(-float("inf"), dtype=f))
    E = torch.exp(ex)                                   # selected, then exp
    att = CB * E * DT[..., None, :]
    M = E * DT[..., None, :] * DYX
    Q = CB * E * DYX
    P = Q * DT[..., None, :]
    Bh = Bc.expand(B, H, nC, L, ds)
    Ch = Cc.expand(B, H, nC, L, ds)
    dx = mm(att.transpose(-1, -2), DY, modes["att_dy"]) \
        + wd[..., None] * mm(Bh, g_out, modes["b_gout"]) + D[:, None, None,
                                                              None] * DY
    XG = mm(X, g_out.transpose(-1, -2), modes["x_gout"])
    dBh = mm(M.transpose(-1, -2), Ch, modes["m_c"]) + wd[..., None] * XG
    DYH = mm(DY, h_in.transpose(-1, -2), modes["dy_hin"])
    dCh = es[..., None] * DYH + mm(M, Bh, modes["m_b"])
    u = (Bh * XG).sum(-1)                               # B^T G_out x
    v = (Ch * DYH).sum(-1)                              # C^T h_in . dy
    ddt_pre = Q.sum(-2) + decL * u                      # column sums
    if decay == "four_terms":
        T1 = torch.exp(sL[..., 0]) * (g_out * h_in).sum((-1, -2))
        pre = wd * u
        T2 = torch.cumsum(pre, -1) - pre                # exclusive prefix
        T3 = torch.flip(torch.cumsum(torch.flip(es * v, [-1]), -1), [-1])
        R = torch.cumsum(P, -1) - P                     # R[m, t]: tau < t
        R = torch.where(tri, R, torch.zeros((), dtype=f))   # t <= m only
        T4 = R.sum(-2)                                  # over m >= t
        da = T1[..., None] + T2 + T3 + T4
    else:
        # dcum_m = <dy_m, C_m . h_m> - dt_m B_m^T G_m x_m; the sums run in
        # float64 over every later step, as tests/test_torch_scan_bwd.py's
        # k3_bwd_model(decay="identity") does
        dcum = (Ch * dCh).sum(-1) - DT * ddt_pre
        flat = dcum.reshape(B, H, Sp).double()
        run = torch.zeros((B, H), dtype=torch.float64) if dh_out is None \
            else (dh_out * h_T).sum((-1, -2)).double()
        da = torch.empty_like(flat)
        for t in reversed(range(Sp)):
            run = run + flat[..., t]
            da[..., t] = run
        da = da.to(f).reshape(B, H, nC, L)
    ddt = ddt_pre + A[None, :, None, None] * da
    unchunk = lambda t: t.reshape((B, H, Sp) + tuple(t.shape[4:]))[  # noqa
        :, :, :S]
    dA_part = (DT * da).sum((-1, -2))                   # (B, H)
    dD_part = (DY * X).sum((-1, -2, -3))
    dBh, dCh = unchunk(dBh), unchunk(dCh)               # (B, H, S, ds)
    dB = torch.zeros((B, S, ds), dtype=f)
    dC = torch.zeros((B, S, ds), dtype=f)
    for hh in range(H):                                 # heads in order
        dB = dB + dBh[:, hh]
        dC = dC + dCh[:, hh]
    dA = torch.zeros(H, dtype=f)
    dD = torch.zeros(H, dtype=f)
    for b in range(B):                                  # batch in order
        dA = dA + dA_part[b]
        dD = dD + dD_part[b]
    return (unchunk(dx).permute(0, 2, 1, 3), unchunk(ddt).permute(0, 2, 1),
            dA, dB, dC, dD, dh0)


# ----------------------------------------------------------------------------
# K4-bwd, the chunked design
# ----------------------------------------------------------------------------

def k4_design(r, k, v, w, u, dy, s0=None, ds_out=None, modes=None,
              dw_form="direct"):
    """K4-bwd's bf16 route in the inputs' dtype -> (dr, dk, dv, dw, du,
    ds0).  Steps past S: w = 1 and zeros.  ``dw_form="identity"`` takes
    dlog w_t from chunk-local suffix sums (the log-decay identity) and
    divides by w."""
    modes = dict.fromkeys(SPLIT_K4, "exact") if modes is None else modes
    f = r.dtype
    B, S, H, dh = r.shape
    nC = -(-S // L)
    Sp = nC * L
    ch = lambda t, fill=0.0: chunks(t, Sp, fill).permute(  # noqa: E731
        0, 3, 1, 2, 4)                                  # (B, H, nC, L, dh)
    R, K, V, W, DY = ch(r), ch(k), ch(v), ch(w, 1.0), ch(dy)
    lw = torch.log2(torch.clamp_min(W, FLOOR_W))
    cum = torch.cumsum(lw, -2)                          # inclusive
    cumx = cum - lw                                     # exclusive
    cumL = cum[..., -1:, :]
    dec = torch.exp2(cumL[..., 0, :])                   # (B, H, nC, dh)
    # -- A. chunk-start states: S_out = dec o S_in + k2^T V
    k2 = K * torch.exp2(cumL - cum)
    loc_s = mm(k2.transpose(-1, -2), V, modes["state"])
    s_in = torch.empty_like(loc_s)
    st = torch.zeros((B, H, dh, dh), dtype=f) if s0 is None else s0
    for c in range(nC):
        s_in[:, :, c] = st
        st = dec[:, :, c, :, None] * st + loc_s[:, :, c]
    # -- B. chunk-end gradients: G_in = dec o G_out + (r o 2^cumx)^T dY
    loc_g = mm((R * torch.exp2(cumx)).transpose(-1, -2), DY, modes["grad"])
    g_out = torch.empty_like(loc_g)
    g = torch.zeros((B, H, dh, dh), dtype=f) if ds_out is None else ds_out
    for c in reversed(range(nC)):
        g_out[:, :, c] = g
        g = dec[:, :, c, :, None] * g + loc_g[:, :, c]
    ds0 = g
    # -- C. every chunk alone, step by step inside it (w as it is)
    vd = (V * DY).sum(-1)                               # (B, H, nC, L)
    ruk = (R * u[None, :, None, None] * K).sum(-1)
    dR, dK, dV, dW = (torch.zeros_like(R) for _ in range(4))
    st = s_in.clone()
    prev = []
    for t in range(L):                                  # S_{t-1}; dr
        prev.append(st)
        dR[..., t, :] = torch.einsum("...ij,...j->...i", st, DY[..., t, :]) \
            + u[None, :, None] * K[..., t, :] * vd[..., t, None]
        st = W[..., t, :, None] * st + K[..., t, :, None] * V[..., t, None, :]
    g = g_out.clone()
    for t in reversed(range(L)):                        # G_t; dk, dv, dw
        dK[..., t, :] = torch.einsum("...ij,...j->...i", g, V[..., t, :]) \
            + u[None, :, None] * R[..., t, :] * vd[..., t, None]
        dV[..., t, :] = torch.einsum("...ij,...i->...j", g, K[..., t, :]) \
            + ruk[..., t, None] * DY[..., t, :]
        dW[..., t, :] = (g * prev[t]).sum(-1)
        g = W[..., t, :, None] * g + R[..., t, :, None] * DY[..., t, None, :]
    if dw_form == "identity":
        # dlog w_t = sum_{m > t} r_m o (S_{m-1} dy_m) - sum_{m >= t} k_m o
        # (G_m v_m) + rowsum(G_out o S_out), inside each chunk
        a_terms = R * (dR - u[None, :, None, None] * K * vd[..., None])
        b_terms = K * (dK - u[None, :, None, None] * R * vd[..., None])
        acc = (g_out * st).sum(-1)
        for t in reversed(range(L)):
            acc = acc - b_terms[..., t, :]
            dW[..., t, :] = acc / W[..., t, :]
            acc = acc + a_terms[..., t, :]
    dW = torch.where(W < FLOOR_W, torch.zeros((), dtype=f), dW)
    du_part = (R * K * vd[..., None]).sum((-2, -3))     # (B, H, dh)
    du = torch.zeros((H, dh), dtype=f)
    for b in range(B):                                  # batch in order
        du = du + du_part[b]
    un = lambda t: t.reshape(B, H, Sp, dh)[:, :, :S].permute(  # noqa: E731
        0, 2, 1, 3)
    return un(dR), un(dK), un(dV), un(dW), du, ds0


# ----------------------------------------------------------------------------
# the models vs float64 autograd through the sequential oracles
# ----------------------------------------------------------------------------

import test_torch_scan_bwd as sb  # noqa: E402  (its inputs, cases, oracles)

EDGES = {   # chunk edges of L = 64
    "S=63": 63, "S=64": 64, "S=65": 65, "S=130": 130}
K4_CASES = {**sb.RWKV_MODEL_CASES,
            **{f"chunk edge {n}": (S, "slow", "state_in_and_out")
               for n, S in EDGES.items()},
            "strong decay, w = 0 and denormal w, S=130": (
                130, "strong", "state_in_and_out")}
K3_CASES = {**sb.MAMBA_MODEL_CASES,
            **{f"chunk edge {n}": (S, "state_in_and_out", n == "S=130")
               for n, S in EDGES.items()}}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(K4_CASES))
def test_k4_design_equals_autograd_through_the_oracle(name, dtype):
    S, w_kind, state = K4_CASES[name]
    d = sb.rwkv_inputs(S, seed=7 + S, w_kind=w_kind)
    s0, ds_out = sb.pick(state, d["s0"], d["ds_out"])
    B, _, H, dh = d["r"].shape
    ins = [sb.t64(d[n]) for n in ("r", "k", "v", "w", "u")]
    state0 = torch.zeros(B, H, dh, dh, dtype=torch.float64) if s0 is None \
        else sb.t64(s0)
    want = list(sb.oracle_grads(sb.seq_rwkv6, ins, state0, (
        sb.t64(d["dy"]), None if ds_out is None else sb.t64(ds_out))))
    want[3] = torch.where(ins[3] < FLOOR_W, torch.zeros_like(want[3]),
                          want[3])
    c = lambda a: None if a is None else sb.t64(a).to(dtype)  # noqa: E731
    got = k4_design(*(t.to(dtype) for t in ins), c(d["dy"]), s0=c(s0),
                    ds_out=c(ds_out))
    bar = F64_BAR if dtype == torch.float64 else BAR["f32"]
    for gname, g, w_ in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                            want):
        within(g, w_, bar, gname)
    if w_kind == "strong":
        floor = ins[3] < FLOOR_W
        assert floor.any() and not got[3][floor].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_design_equals_autograd_through_the_oracle(name, dtype):
    S, state, strided = K3_CASES[name]
    d = sb.mamba_inputs(S, seed=11 + S)
    h0, dh_out = sb.pick(state, d["h0"], d["dh_out"])
    B, _, H, dh = d["x"].shape
    ds = d["Bm"].shape[-1]
    ins = [sb.t64(d[n]) for n in ("x", "dt", "A", "Bm", "Cm", "D")]
    state0 = torch.zeros(B, H, ds, dh, dtype=torch.float64) if h0 is None \
        else sb.t64(h0)
    want = sb.oracle_grads(sb.seq_mamba2, ins, state0, (
        sb.t64(d["dy"]), None if dh_out is None else sb.t64(dh_out)))
    c = lambda a: None if a is None else sb.t64(a).to(dtype)  # noqa: E731
    x, dt, A, Bm, Cm, D = (t.to(dtype) for t in ins)
    if strided:
        x, Bm, Cm = sb.mixer_views(x, Bm, Cm)
        assert not x.is_contiguous() and not Bm.is_contiguous()
    got = k3_design(x, dt, A, Bm, Cm, D, c(d["dy"]), h0=c(h0),
                    dh_out=c(dh_out))
    bar = F64_BAR if dtype == torch.float64 else BAR["f32"]
    for gname, g, w_ in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dh0"),
                            got, want):
        within(g, w_, bar, gname)


# ----------------------------------------------------------------------------
# the decay's gradient: the direct form, decomposed; not the identity
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_long():
    """1024 steps (16 chunks), B = 2, H = 3: the inputs, float64 autograd
    through the oracle, and the fp32 inputs."""
    d = sb.mamba_inputs(1024, seed=9, B=2, H=3)
    ins = [sb.t64(d[n]) for n in ("x", "dt", "A", "Bm", "Cm", "D")]
    want = sb.oracle_grads(sb.seq_mamba2, ins, sb.t64(d["h0"]),
                           (sb.t64(d["dy"]), sb.t64(d["dh_out"])))
    f = [t.float() for t in ins]
    kw = dict(h0=sb.t64(d["h0"]).float(), dh_out=sb.t64(d["dh_out"]).float())
    return f, sb.t64(d["dy"]).float(), kw, want


def test_k3_four_terms_equal_the_direct_form(mamba_long):
    """fp32, over 16 chunks: the four-term split of exp(a_t) <G_t,
    h_{t-1}> gives dA within 2e-6 of max|dA| of the stepwise direct form
    (the fp32 route's, ``k3_bwd_model``) and of float64 autograd.  ddt lands
    within 3e-5 of both: the chunk's exponents s_m - s_tau are differences
    of fp32 cumulative sums (as in K3's forward and the plain chunked
    form), which the stepwise form does not take."""
    f, dy, kw, want = mamba_long
    four = k3_design(*f, dy, **kw)
    direct = sb.k3_bwd_model(*f, dy, **kw)
    within(four[2], direct[2], 2e-6, "dA: four terms vs direct")
    within(four[2], want[2], 2e-6, "dA: four terms")
    within(four[1], direct[1], 3e-5, "ddt: four terms vs direct")
    within(four[1], want[1], 3e-5, "ddt: four terms")


def test_k3_reverse_cumsum_identity_loses_dA(mamba_long):
    """The usual chunked SSD backward takes a_t's gradient as suffix sums
    of <dy_m, C_m . h_m> - dt_m B_m^T G_m x_m over every later step (here
    even summed in float64): the sums cancel what fp32 rounded in each
    term, and dA lands more than ten times further from float64 autograd
    than the four-term direct form's."""
    f, dy, kw, want = mamba_long
    err = {kind: err_ratio(k3_design(*f, dy, decay=kind, **kw)[2], want[2],
                           1.0)
           for kind in ("four_terms", "identity")}
    assert err["four_terms"] <= 2e-6, err
    assert err["identity"] > 10 * err["four_terms"], err


def test_k4_direct_dw_holds_where_the_identity_loses():
    """With w down to 1e-4, dw through the log-decay identity (chunk-local
    suffix sums of dlog w, divided by w) misses the fp32 bar by more than
    three times, even with the sums only 64 steps long; the stepwise direct
    form rowsum(G_t o S_{t-1}) holds it."""
    d = sb.rwkv_inputs(130, seed=5)
    rng = np.random.default_rng(6)
    d["w"] = 10.0 ** rng.uniform(-4.0, 0.0, size=d["w"].shape)
    ins = [sb.t64(d[n]) for n in ("r", "k", "v", "w", "u")]
    want = sb.oracle_grads(sb.seq_rwkv6, ins, sb.t64(d["s0"]),
                           (sb.t64(d["dy"]), sb.t64(d["ds_out"])))[3]
    f = [t.float() for t in ins]
    kw = dict(s0=sb.t64(d["s0"]).float(),
              ds_out=sb.t64(d["ds_out"]).float())
    dy = sb.t64(d["dy"]).float()
    within(k4_design(*f, dy, **kw)[3], want, BAR["f32"], "dw direct")
    ident = k4_design(*f, dy, dw_form="identity", **kw)[3]
    assert err_ratio(ident, want, BAR["f32"]) > 3


# ----------------------------------------------------------------------------
# the tensor-core operands' rounding, at the training shapes' statistics
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k3_training():
    """zamba2's training statistics: dh = ds = 64, S = 1024 (16 chunks),
    two heads at the ends of the A range (-1, -16), softplus-ed dt, bf16
    x, B, C and dy; no state (the training shape) and a state in and its
    gradient out.  The plain backward (autograd through the chunked form,
    what chip_smoke holds the kernel to) for each."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(2)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x, dy = rn(1, 1024, 2, 64).bfloat16(), rn(1, 1024, 2, 64).bfloat16()
    dt = F.softplus(rn(1, 1024, 2))
    A = torch.tensor([-1.0, -16.0])
    Bm, Cm = rn(1, 1024, 64).bfloat16(), rn(1, 1024, 64).bfloat16()
    D = torch.ones(2)
    args = (x, dt, A, Bm, Cm, D, dy)
    cases = {}
    for state, kw in (("none", {}),
                      ("state", dict(h0=rn(1, 2, 64, 64),
                                     dh_out=rn(1, 2, 64, 64)))):
        cases[state] = (kw, tref.mamba2_scan_bwd(*args, **kw))
    return args, cases


def k3_ratios(k3_training, state, modes):
    """err / (bf16 bar x max|want|) of each gradient, the kernel's outputs
    rounded to their dtypes (dx, dB, dC bf16)."""
    (x, dt, A, Bm, Cm, D, dy), cases = k3_training
    kw, want = cases[state]
    got = list(k3_design(x.float(), dt, A, Bm.float(), Cm.float(), D,
                         dy.float(), modes=modes, **kw))
    for i in (0, 3, 4):
        got[i] = got[i].bfloat16()
    return [err_ratio(g, w_, BAR["bf16"]) for g, w_ in zip(got, want)]


@pytest.mark.parametrize("state", ["none", "state"])
def test_k3_splits_hold_the_bf16_bar(k3_training, state):
    """Every fp32 operand of a tensor-core product as bf16 hi + lo: each
    gradient within a bf16 ulp or so of the plain backward (err/bar <=
    0.05, the bar 6e-2 of max|want|)."""
    ratios = k3_ratios(k3_training, state, SPLIT_K3)
    assert max(ratios) <= 0.05, ratios


@pytest.mark.parametrize("product", [None, *SPLIT_K3])
def test_k3_one_rounding_still_holds_the_bf16_bar(k3_training, product):
    """No single split is needed for chip_smoke's bf16 bar: every product
    rounded once (None), or one product's fp32 side rounded once, still
    holds it, so dropping a split misses the bar nowhere.  The splits buy
    margin: with every product rounded once, dB and dC land more than
    twice as far from the plain backward as with the splits."""
    modes = (dict.fromkeys(SPLIT_K3, "one") if product is None
             else {**SPLIT_K3, product: "one"})
    for state in ("none", "state"):
        ratios = k3_ratios(k3_training, state, modes)
        assert max(ratios) <= 1, (state, ratios)
        if product is None:
            split = k3_ratios(k3_training, state, SPLIT_K3)
            assert ratios[3] > 2 * split[3] and ratios[4] > 2 * split[4], (
                ratios, split)


@pytest.fixture(scope="module")
def k4_training():
    """rwkv6's training statistics: dh = 64, S = 1024, two heads, bf16 r,
    k, v, dy and w at rwkv6's decay (w0 ~ -3); with and without a state."""
    g = torch.Generator().manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    r, k, v, dy = (rn(1, 1024, 2, 64).bfloat16() for _ in range(4))
    w = torch.exp(-torch.exp(-3.0 + 0.5 * rn(1, 1024, 2, 64))).bfloat16()
    u = 0.1 * rn(2, 64)
    args = (r, k, v, w, u, dy)
    cases = {}
    for state, kw in (("none", {}),
                      ("state", dict(s0=rn(1, 2, 64, 64),
                                     ds_out=rn(1, 2, 64, 64)))):
        cases[state] = (kw, tref.rwkv6_scan_bwd(*args, **kw))
    return args, cases


def k4_ratios(k4_training, state, modes):
    (r, k, v, w, u, dy), cases = k4_training
    kw, want = cases[state]
    got = list(k4_design(r.float(), k.float(), v.float(), w.float(), u,
                         dy.float(), modes=modes, **kw))
    for i in range(4):
        got[i] = got[i].bfloat16()
    return [err_ratio(g, w_, BAR["bf16"]) for g, w_ in zip(got, want)]


@pytest.mark.parametrize("state", ["none", "state"])
def test_k4_splits_hold_the_bf16_bar(k4_training, state):
    ratios = k4_ratios(k4_training, state, SPLIT_K4)
    assert max(ratios) <= 0.05, ratios


@pytest.mark.parametrize("product", [None, *SPLIT_K4])
def test_k4_one_rounding_still_holds_the_bf16_bar(k4_training, product):
    """As for K3: phase A's or B's product rounded once still holds the
    bar; with both, dw lands about twice as far off as with the splits."""
    modes = (dict.fromkeys(SPLIT_K4, "one") if product is None
             else {**SPLIT_K4, product: "one"})
    for state in ("none", "state"):
        ratios = k4_ratios(k4_training, state, modes)
        assert max(ratios) <= 1, (state, ratios)
        if product is None:
            split = k4_ratios(k4_training, state, SPLIT_K4)
            assert ratios[3] > 1.5 * split[3], (ratios, split)
