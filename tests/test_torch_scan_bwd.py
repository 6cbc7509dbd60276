"""The scans' gradients: the port's plain backward against JAX, and the
arithmetic of the backward kernels K3-bwd and K4-bwd as CPU models.

(a) ``ref.rwkv6_scan_bwd`` and ``ref.mamba2_scan_bwd`` (autograd through
    the port's chunked forms, the plain versions the card's kernels are
    held against) equal ``jax.vjp`` of the JAX package's
    ``ref.rwkv6_scan_chunked`` and ``ref.mamba2_scan_chunked`` on the same
    numpy inputs: every input's gradient, the initial state's included,
    with and without a state in and a final-state gradient.  Bars relative
    to max|want|: fp32 3e-4, bf16 inputs 6e-2 (``tests/test_kernels.py``).

(b) ``k4_bwd_model`` and ``k3_bwd_model`` follow the CUDA kernels step for
    step: K4-bwd's forward pass with a checkpoint of the state at every
    8-step chunk, its reverse pass that recomputes each chunk's states from
    its checkpoint, the direct decay gradient rowsum(G_t o S_{t-1}) (0
    where w < 1e-30, the plain version's floor) and du summed over the
    batch in order; K3-bwd the same way (checkpoints, a recompute of each
    chunk's states, dC's head parts), its reverse pass (dx, dB's head
    parts, B^T G x) and the direct decay gradient exp(a_t) <G_t, h_{t-1}>,
    dB and dC summed over the heads in order, dA and dD over the batch in
    order.  They are held to autograd through
    the sequential recurrences (``seq_rwkv6`` and ``seq_mamba2`` below:
    ``ref.rwkv6_scan`` and ``ref.mamba2_scan`` in the inputs' dtype, which
    differentiate step by step) in float64: the models run in float64
    within 1e-10 of max|want| and, run in fp32, within the fp32 bar 3e-4,
    with w under the floor, strong decay and strided x/B/C views among the
    cases.  Two more cases show
    why both kernels take the direct form: the log-decay identity gives
    RWKV6's dlog w, whose fp32 rounding is divided by w on the way to dw,
    and Mamba2's da as suffix sums that cancel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

BAR = {"f32": 3e-4, "bf16": 6e-2}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
F64_BAR = 1e-10
FLOOR_W = 1e-30


def within(got, want, bar, what=""):
    got = np.asarray(torch.as_tensor(got).double()) \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bar * scale, (what, err, scale)


def np_f32(t):
    return np.asarray(t, np.float32)


# ----------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ----------------------------------------------------------------------------

def rwkv_inputs(S, seed, B=2, H=2, dh=16, w_kind="slow"):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s)  # noqa: E731
    r, k, v, dy = (n(B, S, H, dh) for _ in range(4))
    if w_kind == "slow":              # rwkv6's init: w0 = -3
        w = np.exp(-np.exp(-3.0 + 0.5 * n(B, S, H, dh)))
    else:                             # strong: w down to e^-150 and 0
        w = np.exp(-np.exp(2.0 * n(B, S, H, dh) + 1.0))
        w.reshape(-1)[::7] = 0.0
        w.reshape(-1)[3::11] = 1e-39
    u = 0.1 * n(H, dh)
    return dict(r=r, k=k, v=v, w=w, u=u, dy=dy, s0=n(B, H, dh, dh),
                ds_out=n(B, H, dh, dh))


def mamba_inputs(S, seed, B=2, H=3, dh=16, ds=8):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s)  # noqa: E731
    x, dy = n(B, S, H, dh), n(B, S, H, dh)
    dt = np.log1p(np.exp(n(B, S, H)))            # softplus
    A = -np.linspace(1.0, 16.0, H)
    return dict(x=x, dt=dt, A=A, Bm=n(B, S, ds), Cm=n(B, S, ds),
                D=1.0 + 0.1 * n(H), dy=dy, h0=n(B, H, ds, dh),
                dh_out=n(B, H, ds, dh))


STATES = ["none", "state_in", "state_in_and_out"]


def pick(state, a, b):
    """(initial state, final-state gradient) for the case ``state``."""
    return (a if state != "none" else None,
            b if state == "state_in_and_out" else None)


# ----------------------------------------------------------------------------
# (a) the plain backward vs jax.vjp of JAX's chunked references
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("S", [1, 37, 64, 130])
def test_plain_rwkv6_backward_equals_jax_vjp(S, state, dtype):
    d = rwkv_inputs(S, seed=S)
    s0, ds_out = pick(state, d["s0"], d["ds_out"])
    B, _, H, dh = d["r"].shape
    s0_j = np.zeros((B, H, dh, dh)) if s0 is None else s0
    seq = [np_f32(d[n]) for n in "rkvw"]

    def f(r, k, v, w, u, s0_):
        return jref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0_,
                                       return_state=True)
    jin = [jnp.asarray(a, JDT[dtype]) for a in seq] \
        + [jnp.asarray(np_f32(d["u"])), jnp.asarray(np_f32(s0_j))]
    (y, s), vjp = jax.vjp(f, *jin)
    ct = (jnp.asarray(np_f32(d["dy"]), y.dtype),
          jnp.asarray(np_f32(ds_out) if ds_out is not None
                      else np.zeros(s.shape, np.float32)))
    want = vjp(ct)

    tt = lambda a, dt_=torch.float32: torch.from_numpy(  # noqa: E731
        np_f32(a)).to(dt_)
    got = tref.rwkv6_scan_bwd(
        *(tt(a, TDT[dtype]) for a in seq), tt(d["u"]),
        tt(d["dy"], TDT[dtype]), s0=None if s0 is None else tt(s0),
        ds_out=None if ds_out is None else tt(ds_out))
    for name, g, w_ in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.dtype == (TDT[dtype] if name in ("dr", "dk", "dv", "dw")
                           else torch.float32), name
        within(g, np.asarray(w_, np.float32), BAR[dtype], name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("S", [1, 37, 64, 130])
def test_plain_mamba2_backward_equals_jax_vjp(S, state, dtype):
    d = mamba_inputs(S, seed=100 + S)
    h0, dh_out = pick(state, d["h0"], d["dh_out"])
    B, _, H, dh = d["x"].shape
    ds = d["Bm"].shape[-1]
    h0_j = np.zeros((B, H, ds, dh)) if h0 is None else h0

    def f(x, dt, A, Bm, Cm, D, h0_):
        return jref.mamba2_scan_chunked(x, dt, A, Bm, Cm, D, h0=h0_,
                                        return_state=True)
    lo = JDT[dtype]
    jin = [jnp.asarray(np_f32(d["x"]), lo), jnp.asarray(np_f32(d["dt"])),
           jnp.asarray(np_f32(d["A"])), jnp.asarray(np_f32(d["Bm"]), lo),
           jnp.asarray(np_f32(d["Cm"]), lo), jnp.asarray(np_f32(d["D"])),
           jnp.asarray(np_f32(h0_j))]
    (y, h), vjp = jax.vjp(f, *jin)
    ct = (jnp.asarray(np_f32(d["dy"]), y.dtype),
          jnp.asarray(np_f32(dh_out) if dh_out is not None
                      else np.zeros(h.shape, np.float32)))
    want = vjp(ct)

    tt = lambda a, dt_=torch.float32: torch.from_numpy(  # noqa: E731
        np_f32(a)).to(dt_)
    lo_t = TDT[dtype]
    got = tref.mamba2_scan_bwd(
        tt(d["x"], lo_t), tt(d["dt"]), tt(d["A"]), tt(d["Bm"], lo_t),
        tt(d["Cm"], lo_t), tt(d["D"]), tt(d["dy"], lo_t),
        h0=None if h0 is None else tt(h0),
        dh_out=None if dh_out is None else tt(dh_out))
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
    for name, g, w_ in zip(names, got, want):
        assert g.dtype == (lo_t if name in ("dx", "dB", "dC")
                           else torch.float32), name
        within(g, np.asarray(w_, np.float32), BAR[dtype], name)


# ----------------------------------------------------------------------------
# (b) the kernels' arithmetic as CPU models
# ----------------------------------------------------------------------------

K4_CHUNK = 8        # rwkv6_scan_bwd.cu's kC


def k4_bwd_model(r, k, v, w, u, dy, s0=None, ds_out=None, chunk=K4_CHUNK):
    """K4-bwd's algorithm in the inputs' dtype (fp32 or float64); every
    (b, h) at once, the steps in the kernel's order."""
    B, S, H, dh = r.shape
    f = r.dtype
    zero = torch.zeros((B, H, dh, dh), dtype=f)
    st = zero.clone() if s0 is None else s0.clone()
    nC = -(-S // chunk)
    ckpt = []
    for c in range(nC):                    # 1. forward: checkpoints
        ckpt.append(st.clone())
        if c == nC - 1:
            break
        for t in range(c * chunk, (c + 1) * chunk):
            st = st * w[:, t, :, :, None] \
                + k[:, t, :, :, None] * v[:, t, :, None, :]
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    g = zero.clone() if ds_out is None else ds_out.clone()
    du_part = torch.zeros((B, H, dh), dtype=f)
    for c in reversed(range(nC)):          # 2. reverse, chunk by chunk
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        vd = (v[:, t0:t1] * dy[:, t0:t1]).sum(-1)          # (B, n, H)
        ruk = (r[:, t0:t1] * u * k[:, t0:t1]).sum(-1)
        st = ckpt[c].clone()
        prev = []
        for j, t in enumerate(range(t0, t1)):  # recompute S_{t-1}; dr
            prev.append(st.clone())
            dr[:, t] = torch.einsum("bhij,bhj->bhi", st, dy[:, t]) \
                + u * k[:, t] * vd[:, j, :, None]
            du_part += r[:, t] * k[:, t] * vd[:, j, :, None]
            st = st * w[:, t, :, :, None] \
                + k[:, t, :, :, None] * v[:, t, :, None, :]
        for j, t in reversed(list(enumerate(range(t0, t1)))):
            dk[:, t] = torch.einsum("bhij,bhj->bhi", g, v[:, t]) \
                + u * r[:, t] * vd[:, j, :, None]
            dv[:, t] = torch.einsum("bhij,bhi->bhj", g, k[:, t]) \
                + ruk[:, j, :, None] * dy[:, t]
            direct = (g * prev[j]).sum(-1)
            dw[:, t] = torch.where(w[:, t] < FLOOR_W,
                                   torch.zeros_like(direct), direct)
            g = g * w[:, t, :, :, None] \
                + r[:, t, :, :, None] * dy[:, t, :, None, :]
    du = torch.zeros((H, dh), dtype=f)
    for b in range(B):                     # 3. the batch, in order
        du = du + du_part[b]
    return dr, dk, dv, dw, du, g


K3_CHUNK = 8        # mamba2_scan_bwd.cu's kC


def k3_bwd_model(x, dt, A, Bm, Cm, D, dy, h0=None, dh_out=None,
                 chunk=K3_CHUNK, decay="direct"):
    """K3-bwd's algorithm in the inputs' dtype (fp32 or float64); x, Bm, Cm
    may be strided views.  ``decay="identity"`` takes a_t's gradient
    through the suffix sums of dcum (in float64) instead of the direct
    exp(a_t) <G_t, h_{t-1}>, for the comparison that chose the kernel's
    form."""
    B, S, H, dh = x.shape
    ds = Bm.shape[-1]
    f = x.dtype
    ea = torch.exp(A * dt)                                  # (B, S, H)

    def step(h, t):
        inject = (Bm[:, t, None, :] * dt[:, t, :, None])[..., None] \
            * x[:, t, :, None, :]
        return h * ea[:, t, :, None, None] + inject

    h = torch.zeros((B, H, ds, dh), dtype=f) if h0 is None else h0.clone()
    nC = -(-S // chunk)
    ckpt = []
    for c in range(nC):                    # 1. forward: checkpoints
        ckpt.append(h.clone())
        if c == nC - 1:
            break
        for t in range(c * chunk, (c + 1) * chunk):
            h = step(h, t)
    g = torch.zeros((B, H, ds, dh), dtype=f) if dh_out is None \
        else dh_out.clone()
    dx = torch.zeros((B, S, H, dh), dtype=f)
    dBh = torch.zeros((B, S, H, ds), dtype=f)
    dCh = torch.zeros((B, S, H, ds), dtype=f)
    ddt = torch.zeros((B, S, H), dtype=f)
    da = torch.zeros((B, S, H), dtype=f)
    dcum = torch.zeros((B, S, H), dtype=f)
    dD_part = torch.zeros((B, H), dtype=f)
    for c in reversed(range(nC)):          # 2. reverse, chunk by chunk
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        h = ckpt[c].clone()
        prev = []
        for t in range(t0, t1):            # recompute h_{t-1}; dC's parts
            prev.append(h)
            h = step(h, t)
            dCh[:, t] = torch.einsum("bhsd,bhd->bhs", h, dy[:, t])
            dcum[:, t] = (Cm[:, t, None, :] * dCh[:, t]).sum(-1)
        for j, t in reversed(list(enumerate(range(t0, t1)))):
            g = g + Cm[:, t, None, :, None] * dy[:, t, :, None, :]
            dx[:, t] = dt[:, t, :, None] * torch.einsum(
                "bhsd,bs->bhd", g, Bm[:, t]) + D[:, None] * dy[:, t]
            gx = torch.einsum("bhsd,bhd->bhs", g, x[:, t])
            dBh[:, t] = dt[:, t, :, None] * gx
            ddt[:, t] = (Bm[:, t, None, :] * gx).sum(-1)
            da[:, t] = ea[:, t] * (g * prev[j]).sum((-1, -2))
            dcum[:, t] = dcum[:, t] - dt[:, t] * ddt[:, t]
            dD_part += (dy[:, t] * x[:, t]).sum(-1)
            g = g * ea[:, t, :, None, None]
    if decay == "identity":
        # da_t = sum_{m >= t} dcum_m + <dh_out, h_T>, in float64
        run = torch.zeros((B, H), dtype=torch.float64) if dh_out is None \
            else (dh_out * h).sum((-1, -2)).double()
        for t in reversed(range(S)):
            run = run + dcum[:, t].double()
            da[:, t] = run.to(f)
    ddt = ddt + A * da
    dA_part = (dt * da).sum(1)                              # (B, H)
    dB = torch.zeros((B, S, ds), dtype=f)
    dC = torch.zeros((B, S, ds), dtype=f)
    for hh in range(H):                    # 3. the heads, in order
        dB = dB + dBh[:, :, hh]
        dC = dC + dCh[:, :, hh]
    dA = torch.zeros(H, dtype=f)
    dD = torch.zeros(H, dtype=f)
    for b in range(B):                     # the batch, in order
        dA = dA + dA_part[b]
        dD = dD + dD_part[b]
    return dx, ddt, dA, dB, dC, dD, g


def seq_rwkv6(r, k, v, w, u, s0):
    """The sequential RWKV6 recurrence of ``ref.rwkv6_scan`` in the inputs'
    dtype (the port's oracle computes in fp32) -> (y, final state)."""
    s, ys = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = s * w[:, t, :, :, None] + kv
    return torch.stack(ys, 1), s


def seq_mamba2(x, dt, A, Bm, Cm, D, h0):
    """The sequential SSD recurrence of ``ref.mamba2_scan`` in the inputs'
    dtype -> (y, final state)."""
    h, ys = h0, []
    for t in range(x.shape[1]):
        h = h * torch.exp(A * dt[:, t])[..., None, None] + torch.einsum(
            "bs,bhd->bhsd", Bm[:, t], x[:, t] * dt[:, t, :, None])
        ys.append(torch.einsum("bs,bhsd->bhd", Cm[:, t], h))
    return torch.stack(ys, 1) + D[:, None] * x, h


def oracle_grads(fn, inputs, state, out_grads):
    """autograd through a sequential oracle in float64: the gradients of
    ``inputs`` and of the initial ``state``."""
    ins = [t.detach().double().requires_grad_(True) for t in inputs]
    st = state.detach().double().requires_grad_(True)
    y, s = fn(*ins, st)
    outs = [(y, out_grads[0].double())]
    if out_grads[1] is not None:
        outs.append((s, out_grads[1].double()))
    return torch.autograd.grad([o for o, _ in outs], ins + [st],
                               [g for _, g in outs])


def t64(a):
    return torch.from_numpy(np.asarray(a, np.float64))


RWKV_MODEL_CASES = {
    # name: (S, w_kind, state)
    "S=1": (1, "slow", "state_in_and_out"),
    "one chunk S=8": (8, "slow", "state_in_and_out"),
    "chunk edge S=9": (9, "slow", "state_in"),
    "S=37 no state": (37, "slow", "none"),
    "strong decay, w = 0 and denormal w, S=37": (37, "strong",
                                                 "state_in_and_out"),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(RWKV_MODEL_CASES))
def test_k4_bwd_model_equals_autograd_through_the_oracle(name, dtype):
    S, w_kind, state = RWKV_MODEL_CASES[name]
    d = rwkv_inputs(S, seed=7 + S, w_kind=w_kind)
    s0, ds_out = pick(state, d["s0"], d["ds_out"])
    B, _, H, dh = d["r"].shape
    ins = [t64(d[n]) for n in ("r", "k", "v", "w", "u")]
    state0 = torch.zeros(B, H, dh, dh, dtype=torch.float64) if s0 is None \
        else t64(s0)
    want = list(oracle_grads(seq_rwkv6, ins, state0, (
        t64(d["dy"]), None if ds_out is None else t64(ds_out))))
    # below the floor the plain version's gradient is 0; the oracle has
    # no floor
    want[3] = torch.where(ins[3] < FLOOR_W, torch.zeros_like(want[3]),
                          want[3])
    c = lambda a: None if a is None else t64(a).to(dtype)  # noqa: E731
    got = k4_bwd_model(*(t.to(dtype) for t in ins), c(d["dy"]),
                       s0=c(s0), ds_out=c(ds_out))
    bar = F64_BAR if dtype == torch.float64 else BAR["f32"]
    for gname, g, w_ in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                            want):
        within(g, w_.numpy(), bar, gname)
    if w_kind == "strong":
        floor = ins[3] < FLOOR_W
        assert floor.any() and not got[3][floor].any()


MAMBA_MODEL_CASES = {
    "S=1": (1, "state_in_and_out", False),
    "S=37 no state": (37, "none", False),
    "S=33 state in": (33, "state_in", False),
    "S=70, the mixer's strided x/B/C views": (70, "state_in_and_out", True),
}


def mixer_views(x, Bm, Cm):
    """x, B and C as views into one (B, S, H*dh + 2*ds) tensor, as the
    mixer's split hands them over."""
    B, S, H, dh = x.shape
    xbc = torch.cat([x.reshape(B, S, H * dh), Bm, Cm], -1)
    xv, bv, cv = torch.split(xbc, [H * dh, Bm.shape[-1], Cm.shape[-1]], -1)
    return xv.reshape(B, S, H, dh), bv, cv


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(MAMBA_MODEL_CASES))
def test_k3_bwd_model_equals_autograd_through_the_oracle(name, dtype):
    S, state, strided = MAMBA_MODEL_CASES[name]
    d = mamba_inputs(S, seed=11 + S)
    h0, dh_out = pick(state, d["h0"], d["dh_out"])
    B, _, H, dh = d["x"].shape
    ds = d["Bm"].shape[-1]
    ins = [t64(d[n]) for n in ("x", "dt", "A", "Bm", "Cm", "D")]
    state0 = torch.zeros(B, H, ds, dh, dtype=torch.float64) if h0 is None \
        else t64(h0)
    want = oracle_grads(seq_mamba2, ins, state0, (
        t64(d["dy"]), None if dh_out is None else t64(dh_out)))
    c = lambda a: None if a is None else t64(a).to(dtype)  # noqa: E731
    x, dt, A, Bm, Cm, D = (t.to(dtype) for t in ins)
    if strided:
        x, Bm, Cm = mixer_views(x, Bm, Cm)
        assert not x.is_contiguous() and not Bm.is_contiguous()
    got = k3_bwd_model(x, dt, A, Bm, Cm, D, c(d["dy"]), h0=c(h0),
                       dh_out=c(dh_out))
    bar = F64_BAR if dtype == torch.float64 else BAR["f32"]
    for gname, g, w_ in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dh0"),
                            got, want):
        within(g, w_.numpy(), bar, gname)


def test_k4_bwd_model_equals_the_plain_backward_at_rwkv6s_decay():
    """At rwkv6's own decay (w ~ 0.95) the model and the plain backward
    (autograd through the chunked form, what the card's kernel is held to)
    agree in fp32 at the fp32 bar, over several chunks."""
    d = rwkv_inputs(70, seed=3)
    f = lambda a: torch.from_numpy(np_f32(a))  # noqa: E731
    ins = [f(d[n]) for n in ("r", "k", "v", "w", "u")]
    want = tref.rwkv6_scan_bwd(*ins, f(d["dy"]), s0=f(d["s0"]),
                               ds_out=f(d["ds_out"]))
    got = k4_bwd_model(*ins, f(d["dy"]), s0=f(d["s0"]),
                       ds_out=f(d["ds_out"]))
    for gname, g, w_ in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                            want):
        within(g, w_.numpy(), BAR["f32"], gname)


def test_log_decay_identity_loses_dw_where_w_is_small():
    """The identity dlog w_t = sum_{s>t} r_s o (S_{s-1} dy_s) - sum_{s>=t}
    k_s o (G_s v_s) + rowsum(ds_out o S_T) is exact, but in fp32 its
    rounding (of the size of the sums) is divided by w on the way to dw:
    with w down to 1e-4 it misses the fp32 bar by more than ten times,
    where the direct form K4-bwd takes stays within it."""
    d = rwkv_inputs(64, seed=5)
    rng = np.random.default_rng(6)
    d["w"] = 10.0 ** rng.uniform(-4.0, 0.0, size=d["w"].shape)
    ins = [t64(d[n]) for n in ("r", "k", "v", "w", "u")]
    want = oracle_grads(seq_rwkv6, ins, t64(d["s0"]),
                        (t64(d["dy"]), t64(d["ds_out"])))[3]
    r, k, v, w, u = (t.float() for t in ins)
    dy, s0, ds_out = (t64(d[n]).float() for n in ("dy", "s0", "ds_out"))
    S = r.shape[1]
    st, a_terms, prevs = s0.clone(), [], []
    for t in range(S):
        prevs.append(st)
        a_terms.append(r[:, t] * torch.einsum("bhij,bhj->bhi", st, dy[:, t]))
        st = st * w[:, t, :, :, None] \
            + k[:, t, :, :, None] * v[:, t, :, None, :]
    acc = (ds_out * st).sum(-1)                  # rowsum(ds_out o S_T)
    g = ds_out.clone()
    dlogw = torch.zeros_like(r)
    for t in reversed(range(S)):
        acc = acc - k[:, t] * torch.einsum("bhij,bhj->bhi", g, v[:, t])
        dlogw[:, t] = acc
        acc = acc + a_terms[t]
        g = g * w[:, t, :, :, None] \
            + r[:, t, :, :, None] * dy[:, t, :, None, :]
    identity = dlogw / w
    scale = float(want.abs().max())
    assert float((identity.double() - want).abs().max()) > 10 * BAR["f32"] \
        * scale
    direct = k4_bwd_model(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)[3]
    within(direct, want.numpy(), BAR["f32"], "dw direct")


def test_plain_dw_is_lost_under_strong_decay():
    """Autograd through the chunked form (the plain backward) gives dw as
    a difference of O(1) sums divided by w: with w down to e^-150 (above
    the floor) it is off by more than a million times dw's own size, where
    K4-bwd's direct form holds to the float64 recurrence."""
    d = rwkv_inputs(37, seed=44, w_kind="strong")
    ins = [t64(d[n]) for n in ("r", "k", "v", "w", "u")]
    want = oracle_grads(seq_rwkv6, ins, t64(d["s0"]), (t64(d["dy"]), None))[3]
    want = torch.where(ins[3] < FLOOR_W, torch.zeros_like(want), want)
    f = [t.float() for t in ins]
    dy, s0 = t64(d["dy"]).float(), t64(d["s0"]).float()
    scale = float(want.abs().max())
    plain = tref.rwkv6_scan_bwd(*f, dy, s0=s0)[3]
    assert float((plain.double() - want).abs().max()) > 1e6 * scale
    within(k4_bwd_model(*f, dy, s0=s0)[3], want.numpy(), BAR["f32"], "dw")


@pytest.mark.parametrize("B,H", [(1, 2), (2, 3)])
def test_decay_identity_loses_digits_in_mamba2s_dA(B, H):
    """Mamba2's decay through the identity (suffix sums of dcum, even in
    float64) loses what fp32 rounded in each dcum term to the cancellation
    of the sums: over 1024 steps its dA lands far further from the exact
    one than the direct form's, which K3-bwd takes."""
    d = mamba_inputs(1024, seed=9, B=B, H=H)
    ins = [t64(d[n]) for n in ("x", "dt", "A", "Bm", "Cm", "D")]
    want = oracle_grads(seq_mamba2, ins, t64(d["h0"]),
                        (t64(d["dy"]), None))[2]
    f = [t.float() for t in ins]
    dy, h0 = t64(d["dy"]).float(), t64(d["h0"]).float()
    err = {kind: float((k3_bwd_model(*f, dy, h0=h0, decay=kind)[2].double()
                        - want).abs().max() / want.abs().max())
           for kind in ("direct", "identity")}
    assert err["direct"] <= BAR["f32"]
    assert err["identity"] > 10 * err["direct"], err
