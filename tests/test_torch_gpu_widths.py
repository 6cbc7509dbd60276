"""The kernels' small-width routes on the card, against their plain versions.

Every kernel takes each head width a config of the repo gives: the fast
routes take D = 64 / 128 (K1, K2, K2-bwd) and dh = ds = 64 (K3, K3-bwd, K4,
K4-bwd); every other width up to 128 (attention) or 64 (the scans) takes
the small-width route, which reports itself in the wrapper's ``routes``
count.  Every ``.reduced()`` config (head_dim 16; zamba2's and mamba2's
ssm d_state 8, head_dim 8) then runs on the card unmodified, and gives the
CPU's tokens and losses.

Each case carries the ``gpu`` marker and skips without a CUDA device (in a
fixture).  This file imports neither JAX nor ``repro``:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_widths.py

Bars are ``tests/test_kernels.py``'s: 3e-4 for fp32, 6e-2 where bf16
rounds; the gradients max |got - want| <= bar * max |want|; the reduced
models fp32 with TF32 off, losses and logits within rtol 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402

torch.set_num_threads(1)

WRAPPERS = (pa.paged_attention, fa.flash_attention, fa.flash_attention_bwd,
            m2.mamba2_scan, m2.mamba2_scan_bwd, rw.rwkv6_scan,
            rw.rwkv6_scan_bwd)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tol(dtype):
    return 3e-4 if dtype == torch.float32 else 6e-2


def routes() -> dict:
    return {fn.__name__: dict(fn.routes) for fn in WRAPPERS}


def small_launches(before: dict) -> dict:
    """{wrapper: small-width launches since ``before``}."""
    now = routes()
    return {k: now[k].get("small", 0) - before[k].get("small", 0)
            for k in now}


def within(got, want, bar):
    """max |got - want| <= bar * max(1, max |want|) for each pair."""
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= bar * max(1.0, float(w.float().abs().max())), (err,
                                                                      bar)


# ----------------------------------------------------------------------------
# K1, K2, K2-bwd
# ----------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,Hkv", [(16, 4, 2), (8, 2, 2), (32, 6, 2),
                                     (48, 4, 1), (96, 4, 4), (127, 2, 1)])
def test_paged_attention_small_width(cuda, D, H, Hkv, dtype):
    """Rows with no key, fewer keys than a tile, and several tiles of 128
    keys, through a shuffled page table."""
    rng = np.random.default_rng(D)
    lens, page = [0, 5, 130, 300], 16
    max_pages = -(-max(lens) // page) + 1
    P = len(lens) * max_pages + 3
    g = torch.Generator().manual_seed(D)
    q = torch.randn(len(lens), H, D, generator=g).to(cuda, dtype)
    kp = torch.randn(P, page, Hkv, D, generator=g).to(cuda, dtype)
    vp = torch.randn(P, page, Hkv, D, generator=g).to(cuda, dtype)
    pt = torch.from_numpy(rng.permutation(P)[:len(lens) * max_pages].reshape(
        len(lens), max_pages).astype(np.int32)).to(cuda)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = routes()
    got = ops.paged_attention(q, kp, vp, pt, sl)
    assert small_launches(before)["paged_attention"] == 1
    want = ref.paged_attention(q, kp, vp, pt, sl)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol(dtype),
                               atol=tol(dtype))
    assert not got[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,D,causal", [(40, 40, 16, True),
                                             (70, 130, 16, False),
                                             (100, 60, 8, True),
                                             (65, 65, 40, True),
                                             (33, 90, 96, True),
                                             (20, 20, 127, False)])
def test_flash_attention_small_width(cuda, Sq, Skv, D, causal, dtype,
                                     compute):
    """Forward and gradient (K2 with its LSE, then K2-bwd) through the
    small-width route: GQA, tile edges, empty causal rows (Sq > Skv)."""
    g = torch.Generator().manual_seed(Sq + Skv + D)
    mk = lambda h, s: torch.randn(2, h, s, D, generator=g).to(  # noqa: E731
        cuda, dtype).requires_grad_(True)
    q, k, v = mk(4, Sq), mk(2, Skv), mk(2, Skv)
    dout = torch.randn(2, 4, Sq, D, generator=g).to(cuda, dtype)
    before = routes()
    out = ops.flash_attention(q, k, v, causal=causal, compute_dtype=compute)
    out.backward(dout)
    n = small_launches(before)
    assert n["flash_attention"] == 1 and n["flash_attention_bwd"] == 1
    bar = max(tol(dtype), tol(compute))
    qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    want = ref.mha_attention(qr, kr, vr, causal=causal,
                             compute_dtype=compute)
    want.backward(dout)
    torch.testing.assert_close(out.float(), want.float(), rtol=bar,
                               atol=bar)
    for got_g, want_g in ((q.grad, qr.grad), (k.grad, kr.grad),
                          (v.grad, vr.grad)):
        err = float((got_g.float() - want_g.float()).abs().max())
        assert err <= bar * float(want_g.float().abs().max()), err


@pytest.mark.gpu
def test_attention_kernels_refuse_a_head_above_128(cuda):
    q = torch.randn(1, 2, 8, 160, device=cuda)
    with pytest.raises(ValueError, match="D=160"):
        fa.flash_attention(q, q, q)
    kp = torch.randn(4, 8, 2, 160, device=cuda)
    pt = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    sl = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="D=160"):
        pa.paged_attention(q[:, :, 0], kp, kp, pt, sl)


# ----------------------------------------------------------------------------
# K3, K3-bwd, K4, K4-bwd
# ----------------------------------------------------------------------------

def mamba_inputs(dtype, *, B, S, H, dh, ds, seed):
    """x, B and C as strided views of one projection, as the mixer gives
    them (their rows need no alignment on this route)."""
    g = torch.Generator().manual_seed(seed)
    proj = torch.randn(B, S, H * dh + 2 * ds + 3, generator=g)
    x = proj[..., :H * dh].view(B, S, H, dh)
    Bm = proj[..., H * dh + 1:H * dh + 1 + ds]
    Cm = proj[..., H * dh + 2 + ds:H * dh + 2 + 2 * ds]
    dt = torch.rand(B, S, H, generator=g) * 0.1 + 0.01
    A = -torch.rand(H, generator=g) * 2 - 0.1
    D = torch.randn(H, generator=g)
    h0 = torch.randn(B, H, ds, dh, generator=g)
    dy = torch.randn(B, S, H, dh, generator=g)
    dh_out = torch.randn(B, H, ds, dh, generator=g)
    return proj, (x, dt, A, Bm, Cm, D, h0, dy, dh_out)


@pytest.mark.gpu
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 37, 130])
@pytest.mark.parametrize("dh,ds", [(8, 8), (16, 8), (8, 32), (64, 16)])
def test_mamba2_scan_small_width(cuda, dh, ds, S, dtype, state):
    proj, cpu = mamba_inputs(torch.float32, B=2, S=S, H=3, dh=dh, ds=ds,
                             seed=S + dh + ds)
    proj = proj.to(cuda, dtype)
    H = 3
    x = proj[..., :H * dh].view(2, S, H, dh)
    Bm = proj[..., H * dh + 1:H * dh + 1 + ds]
    Cm = proj[..., H * dh + 2 + ds:H * dh + 2 + 2 * ds]
    dt, A, D, h0, dy, dh_out = (t.to(cuda) for t in
                                (cpu[1], cpu[2], cpu[5], cpu[6], cpu[7],
                                 cpu[8]))
    dy = dy.to(dtype)
    h0, dh_out = (h0, dh_out) if state else (None, None)
    before = routes()
    y, h = m2.mamba2_scan(x, dt, A, Bm, Cm, D, h0=h0, return_state=True)
    got = m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0, dh_out=dh_out)
    n = small_launches(before)
    assert n["mamba2_scan"] == 1 and n["mamba2_scan_bwd"] == 1
    assert m2.mamba2_scan.last_kernel == "mamba2_scan_small_kernel"
    y_w, h_w = ref.mamba2_scan_chunked(x, dt, A, Bm, Cm, D, h0=h0,
                                       return_state=True)
    within([y], [y_w], tol(dtype))
    within([h], [h_w], 3e-4 if dtype == torch.float32 else tol(dtype))
    want = ref.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0,
                               dh_out=dh_out)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            continue
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol(dtype) * float(b.float().abs().max()), (i, err)


def rwkv_inputs(dtype, *, B, S, H, dh, seed):
    g = torch.Generator().manual_seed(seed)
    r, k, v, dy = (torch.randn(B, S, H, dh, generator=g) for _ in range(4))
    w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(B, S, H, dh,
                                                      generator=g)))
    u = torch.randn(H, dh, generator=g) * 0.1
    s0 = torch.randn(B, H, dh, dh, generator=g)
    ds_out = torch.randn(B, H, dh, dh, generator=g)
    lo = lambda t: t.to("cuda", dtype)  # noqa: E731
    return (lo(r), lo(k), lo(v), lo(w), u.cuda(), s0.cuda(), lo(dy),
            ds_out.cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 37, 130])
@pytest.mark.parametrize("dh", [16, 8, 40])
def test_rwkv6_scan_small_width(cuda, dh, S, dtype, state):
    """Prefill and the S = 1 decode, with and without a state."""
    r, k, v, w, u, s0, dy, ds_out = rwkv_inputs(dtype, B=2, S=S, H=3, dh=dh,
                                                seed=S + dh)
    s0, ds_out = (s0, ds_out) if state else (None, None)
    before = routes()
    y, s = rw.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
    got = rw.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
    n = small_launches(before)
    assert n["rwkv6_scan"] == 1 and n["rwkv6_scan_bwd"] == 1
    assert rw.rwkv6_scan.last_kernel == "rwkv6_scan_small_kernel"
    y_w, s_w = ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0,
                                      return_state=True)
    within([y], [y_w], tol(dtype))
    within([s], [s_w], 3e-4 if dtype == torch.float32 else tol(dtype))
    want = ref.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            continue
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol(dtype) * float(b.float().abs().max()), (i, err)


@pytest.mark.gpu
def test_scan_kernels_refuse_a_width_above_64(cuda):
    r, k, v, w, u, *_ = rwkv_inputs(torch.float32, B=1, S=4, H=2, dh=80,
                                    seed=0)
    with pytest.raises(ValueError, match="dh=80"):
        rw.rwkv6_scan(r, k, v, w, u)
    _, (x, dt, A, Bm, Cm, D, *_) = mamba_inputs(torch.float32, B=1, S=4,
                                                H=2, dh=8, ds=72, seed=0)
    with pytest.raises(ValueError, match="ds=72"):
        m2.mamba2_scan(*(t.cuda() for t in (x, dt, A, Bm, Cm, D)))


# ----------------------------------------------------------------------------
# the reduced configs, unmodified, on the card against the CPU
# ----------------------------------------------------------------------------

def reduced(name: str, family: str | None = None):
    from repro_torch import configs
    cfg = configs.get_config(name)
    if family:
        cfg = dataclasses.replace(cfg, family=family)
    return cfg.reduced()


# (config, family override, the wrappers its forward runs)
SERVE = [("qwen2-0.5b", None, ("flash_attention",)),
         ("olmoe-1b-7b", None, ("flash_attention",)),
         ("rwkv6-1.6b", None, ("rwkv6_scan",)),
         ("zamba2-1.2b", None, ("mamba2_scan", "flash_attention")),
         ("zamba2-1.2b", "mamba2", ("mamba2_scan",)),
         ("whisper-large-v3", None, ("flash_attention",))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,family,kernels", SERVE)
def test_reduced_config_served_on_the_card_gives_the_cpus_tokens(
        cuda, name, family, kernels):
    """Prefill then 6 greedy steps from the same weights on the card and
    the CPU: the same tokens, logits within rtol 1e-4, and the kernels
    went through their small-width routes."""
    from repro_torch.models import api
    cfg = reduced(name, family)
    model = api.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    S, steps = 37, 6
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, size=(2, S)))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            2, cfg.n_frames, cfg.d_model,
            generator=torch.Generator().manual_seed(7))
    kw = {"max_len": S + steps} if cfg.family in (
        "zamba2", "encdec", "dense", "moe") else {}
    outs = {}
    for dev in ("cpu", "cuda"):
        p = type(params)(cfg, device=dev)
        p.load_state_dict(params.state_dict())
        before = routes()
        logits, state = model.prefill(
            p, {k: v.to(dev) for k, v in batch.items()}, **kw)
        seq, lg = [], [logits[:, -1].float().cpu()]
        for i in range(steps):
            tok = logits[:, -1].argmax(-1)[:, None]
            seq.append(tok.cpu())
            logits, state = model.decode_step(p, tok, state, S + i)
            lg.append(logits[:, -1].float().cpu())
        outs[dev] = (torch.cat(seq, 1), torch.stack(lg))
        if dev == "cuda":
            n = small_launches(before)
            assert all(n[k] > 0 for k in kernels), n
    assert torch.equal(outs["cuda"][0], outs["cpu"][0])
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_reduced_engine_on_the_card_gives_the_cpus_tokens(cuda):
    """The paged engine on the reduced qwen2 (head_dim 16): K1's
    small-width route every decode step, K2's in whole-prompt prefill;
    whole and chunked prefill give the CPU's tokens."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine, PagedLM, Request
    cfg = configs.get_config("qwen2-0.5b").reduced()
    params = api.get_model(cfg).init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    reqs = [(i, rng.integers(0, cfg.vocab, size=(int(rng.integers(5, 60)),))
             .astype(np.int32)) for i in range(6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = type(params)(cfg, device=dev)
        p.load_state_dict(params.state_dict())
        for chunked in (False, True):
            before = routes()
            lm = PagedLM(cfg, p, max_batch=4, max_seq=96, page_tokens=16,
                         device=dev)
            eng = Engine(lm, chunked_prefill=chunked)
            for rid, prompt in reqs:
                eng.submit(Request(rid=rid, prompt=prompt,
                                   max_new_tokens=12))
            eng.run_to_completion()
            outs[dev, chunked] = {r.rid: r.out_tokens for r in eng.finished}
            if dev == "cuda":   # chunked prefill attends through its pages
                n = small_launches(before)
                assert n["paged_attention"] > 0
                assert (n["flash_attention"] > 0) != chunked
    for chunked in (False, True):
        assert outs["cuda", chunked] == outs["cpu", chunked]


TRAIN = [("qwen2-0.5b", None, ("flash_attention", "flash_attention_bwd")),
         ("rwkv6-1.6b", None, ("rwkv6_scan", "rwkv6_scan_bwd")),
         ("zamba2-1.2b", None, ("mamba2_scan", "mamba2_scan_bwd",
                                "flash_attention", "flash_attention_bwd")),
         ("zamba2-1.2b", "mamba2", ("mamba2_scan", "mamba2_scan_bwd")),
         ("whisper-large-v3", None, ("flash_attention",
                                     "flash_attention_bwd"))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,family,kernels", TRAIN)
def test_reduced_config_trained_on_the_card_gives_the_cpus_losses(
        cuda, tmp_path, name, family, kernels):
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = reduced(name, family)
    init = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", "cuda"):
        tc = TrainerConfig(ckpt_dir=str(tmp_path / dev), ckpt_every=0,
                           batch=2, seq_len=40, comm="single",
                           opt=AdamWConfig(lr=3e-3, warmup_steps=0))
        tr = Trainer(cfg, tc, device=dev, init_params=init)
        before = routes()
        losses[dev] = [m["loss"] for m in tr.train(3)]
        if dev == "cuda":
            n = small_launches(before)
            assert all(n[k] > 0 for k in kernels), n
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,dk,dv", [(8, 32, 4, 64), (2, 4, 8, 16),
                                       (3, 5, 1, 70)])
def test_k4_split_key_route_matches_its_plain_version(cuda, dtype, B, H, dk,
                                                      dv):
    """K4's split-key route (one decode step on dk of the dv keys of every
    head; rwkv6-1.6b's pod rank: 8 rows, 32 heads, 4 of 64 keys) against
    ``ref.rwkv6_scan_split``: the fp32 readout part and the state rows,
    one launch; at dv = 64 the sum of the dv/dk slices' parts against the
    full-state S = 1 route (``rwkv6_scan_decode_kernel``)."""
    g = torch.Generator(device="cuda").manual_seed(dk)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda)

    r, k, w = (rnd(B, 1, H, dv).to(dtype) for _ in range(3))
    w = (torch.sigmoid(w.float()) * 0.5 + 0.45).to(dtype)
    v = rnd(B, 1, H, dv).to(dtype)
    u = rnd(H, dv) * 0.1
    s0 = rnd(B, H, dv, dv)
    n = rw.rwkv6_scan_split.launches
    parts = []
    for i in range(dv // dk):
        keys = slice(i * dk, (i + 1) * dk)
        args = (r[..., keys].contiguous(), k[..., keys].contiguous(), v,
                w[..., keys].contiguous(), u[:, keys].contiguous(),
                s0[:, :, keys].contiguous())
        y, s = ops.rwkv6_scan_split(*args)
        y_w, s_w = ref.rwkv6_scan_split(*args)
        assert y.dtype == s.dtype == torch.float32
        torch.testing.assert_close(y, y_w, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(s, s_w, rtol=1e-6, atol=1e-6)
        parts.append(y)
    assert rw.rwkv6_scan_split.launches == n + dv // dk
    if dv == 64:
        y, _ = rw.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
        assert rw.rwkv6_scan.last_kernel == "rwkv6_scan_decode_kernel"
        assert (sum(parts).to(dtype).float() - y.float()).abs().max() \
            <= tol(dtype) * y.float().abs().max()
