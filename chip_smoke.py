#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one card

Drives the port's main path — paged serving (``PagedLM`` + ``Engine``) of
qwen2-0.5b at full width and depth, bf16, random weights from a seed — and
holds every CUDA kernel of that path against its plain PyTorch version:

  1. set-up: the card's name and power limit; build the kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
  2. each kernel vs its plain version on the card, at the main path's
     shapes (tolerances stated where they are checked), and timed with CUDA
     events beside its bound and the plain version;
  3. the engine: 16 requests, whole-prompt prefill and then chunked
     prefill; the launch counters must show every decode layer went
     through K1 (paged attention) and every whole-prefill layer through K2
     (flash attention);
  4. one prefill and one decode step through the kernels vs through the
     plain versions on the same state; and a reduced fp32 model served on
     the card vs the same weights served on the CPU, token for token.

Prints one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``.  Any failed check raises, and the script exits non-zero
without the last line.  It imports nothing of JAX and nothing of the JAX
package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_S = 3.35e12                 # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12,   # dense tensor-core bf16
              "torch.float32": 67e12}     # fp32 outside the tensor cores
# Kernel vs plain version, elementwise: |got - want| <= rel * |want| + abs.
# bf16 outputs: both sides round an fp32 result summed in another order, so
# they may land one bf16 ulp apart (at most 2^-7 |want|); rel = 2^-6 allows
# two.  abs covers outputs near 0, where the ulp vanishes but the fp32 sums
# still differ: 2.5e-4 with fp32 products.
BF16_TOL = (2.0 ** -6, 2.5e-4)
FP32_TOL = (1e-5, 1e-5)   # fp32 outputs, summed in another order
# Under compute_dtype=bf16 the kernel rounds each unnormalised probability
# and the plain version each normalised one: every p_j may differ by 2^-8
# p_j, so an output may differ by 2^-8 sum_j p_j |v_j| before its own
# rounding, however near 0 the output is.  The abs term is twice that,
# computed per element as 2^-7 * attention(q, k, |v|).
BF16_COMPUTE_REL, BF16_COMPUTE_PV = 2.0 ** -6, 2.0 ** -7
# logits of the full bf16 model through the kernels vs the plain versions:
# the two differ by an ulp of bf16 here and there (summation order), and 24
# bf16 residual layers carry that to 0.041-0.042 at |logit| <= 3.2 (three
# H100 runs); the bound leaves room for about twice that
LOGIT_TOL = 0.1


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def tol_ratio(got, want, tol) -> float:
    """max |got - want| / (rel * |want| + abs): at most 1 when in tolerance.
    ``abs`` is a number or a tensor of ``want``'s shape."""
    rel, ab = tol
    w = want.float()
    return float(((got.float() - w).abs() / (rel * w.abs() + ab)).max())


# ----------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ----------------------------------------------------------------------------

def paged_case(rng, *, B, H, Hkv, D, page, seq_lens, dtype):
    """Inputs for K1: a scattered page table over a pool with spare pages."""
    import numpy as np
    import torch
    dev = "cuda"
    max_pages = max(-(-int(s) // page) for s in seq_lens) + 1
    P = B * max_pages + 7
    perm = rng.permutation(P)[:B * max_pages].reshape(B, max_pages)
    q = torch.randn(B, H, D, device=dev).to(dtype)
    kp = torch.randn(P, page, Hkv, D, device=dev).to(dtype)
    vp = torch.randn(P, page, Hkv, D, device=dev).to(dtype)
    pt = torch.from_numpy(perm.astype(np.int32)).to(dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, sl


def run_kernel_checks(report: dict) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    results = {}

    # -- K1: decode attention at the slice's shapes ---------------------------
    errs = []
    lens = np.concatenate([[1, 17, 2048, 1000, 16, 33],
                           rng.integers(1, 2049, size=10)]).astype(np.int32)
    main = paged_case(rng, B=16, H=14, Hkv=2, D=64, page=16,
                      seq_lens=lens, dtype=torch.bfloat16)
    cases = [("qwen2 decode B=16 H=14 Hkv=2 D=64 bf16", main, BF16_TOL),
             ("MHA B=8 H=Hkv=32 D=128 bf16",
              paged_case(rng, B=8, H=32, Hkv=32, D=128, page=16,
                         seq_lens=rng.integers(1, 1025, size=8),
                         dtype=torch.bfloat16), BF16_TOL),
             ("fp32 B=4 H=8 Hkv=1 D=64 page=8 with seq_len 0",
              paged_case(rng, B=4, H=8, Hkv=1, D=64, page=8,
                         seq_lens=[0, 5, 64, 300], dtype=torch.float32),
              FP32_TOL)]
    for name, args, tol in cases:
        got = pa.paged_attention(*args)
        want = ref.paged_attention(*args)
        torch.cuda.synchronize()
        e, s = max_err(got, want), tol_ratio(got, want, tol)
        print(f"[K1] {name}: max_abs_err={e:.3e} max|want|="
              f"{float(want.float().abs().max()):.3e} err/tol={s:.3f} "
              f"(tol {tol[0]:.3g}|want| + {tol[1]:.3g})")
        check(s <= 1, f"K1 disagrees with its plain version: {name}")
        errs.append(e)
    q, kp, vp, pt, sl = main
    Hkv, D, H, B = kp.shape[2], q.shape[2], q.shape[1], q.shape[0]
    n_tok = int(sl.sum())
    isz = q.element_size()
    nbytes = (2 * n_tok * Hkv * D * isz + 2 * q.numel() * isz
              + sum(-(-int(s) // kp.shape[1]) for s in sl.tolist()) * 4
              + B * 4)
    b_ms, b_by = bound(nbytes, 4.0 * n_tok * H * D, q.dtype)
    print(f"[K1] timed: B={B} H={H} Hkv={Hkv} D={D} {q.dtype}, "
          f"sum(seq_lens)={n_tok}, {nbytes} bytes, {4 * n_tok * H * D} flops")
    results["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:73",
        max_abs_err=max(errs),
        ms=time_ms(lambda: pa.paged_attention(q, kp, vp, pt, sl)),
        plain_ms=time_ms(lambda: ref.paged_attention(q, kp, vp, pt, sl)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # -- K2: causal prefill attention at the slice's shapes --------------------
    def fa_case(B, H, Hkv, Sq, Skv, D, dtype):
        mk = lambda h, s: torch.randn(B, h, s, D, device="cuda").to(dtype)
        return mk(H, Sq), mk(Hkv, Skv), mk(Hkv, Skv)

    errs = []
    main = fa_case(1, 14, 2, 2048, 2048, 64, torch.bfloat16)
    cases = [
        ("qwen2 prefill S=2048 bf16", main, True, torch.float32, BF16_TOL),
        ("qwen2 prefill ragged S=1000 bf16",
         fa_case(1, 14, 2, 1000, 1000, 64, torch.bfloat16), True,
         torch.float32, BF16_TOL),
        ("D=128 H=Hkv=32 S=512 compute_dtype=bf16",
         fa_case(1, 32, 32, 512, 512, 128, torch.bfloat16), True,
         torch.bfloat16, None),
        ("fp32 Sq=100 Skv=300 causal right-aligned",
         fa_case(2, 4, 2, 100, 300, 64, torch.float32), True, torch.float32,
         FP32_TOL),
        ("fp32 Sq=300 Skv=100 causal, empty rows",
         fa_case(1, 4, 4, 300, 100, 128, torch.float32), True,
         torch.float32, FP32_TOL),
        ("fp32 non-causal Sq=77 Skv=200",
         fa_case(1, 8, 1, 77, 200, 64, torch.float32), False, torch.float32,
         FP32_TOL),
    ]
    for name, (q, k, v), causal, cdt, tol in cases:
        got = fa.flash_attention(q, k, v, causal=causal, compute_dtype=cdt)
        want = ref.mha_attention(q, k, v, causal=causal, compute_dtype=cdt)
        if tol is None:        # compute_dtype=bf16: see BF16_COMPUTE_PV
            pv = ref.mha_attention(q, k, v.abs(), causal=causal,
                                   compute_dtype=cdt).float()
            tol = (BF16_COMPUTE_REL, BF16_COMPUTE_PV * pv + 1e-5)
            tol_txt = f"{tol[0]:.3g}|want| + 2^-7 p@|v| + 1e-5"
        else:
            tol_txt = f"{tol[0]:.3g}|want| + {tol[1]:.3g}"
        torch.cuda.synchronize()
        e, s = max_err(got, want), tol_ratio(got, want, tol)
        print(f"[K2] {name}: max_abs_err={e:.3e} max|want|="
              f"{float(want.float().abs().max()):.3e} err/tol={s:.3f} "
              f"(tol {tol_txt})")
        check(s <= 1, f"K2 disagrees with its plain version: {name}")
        errs.append(e)
    q, k, v = main
    B, H, S, D = q.shape
    isz = q.element_size()
    visible = S * (S + 1) / 2            # causal keys seen, summed over rows
    b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * isz,
                       4.0 * B * H * D * visible, q.dtype)
    print(f"[K2] timed: B={B} H={H} Hkv={k.shape[1]} S={S} D={D} {q.dtype} "
          f"causal, {(2 * q.numel() + 2 * k.numel()) * isz} bytes, "
          f"{4 * B * H * D * visible:.0f} flops")
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:85",
        max_abs_err=max(errs),
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: ref.mha_attention(q, k, v, causal=True),
                         iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)))
    for r in results.values():
        r["kernel_ms"] = r["ms"]
    report.update(results)
    return results


# ----------------------------------------------------------------------------
# phases 3-4: the engine
# ----------------------------------------------------------------------------

def make_requests(cfg, n, lo, hi, max_new, seed):
    import numpy as np

    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, size=(int(rng.integers(lo, hi + 1)),)).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    pa.paged_attention.launches = 0
    fa.flash_attention.launches = 0


def read_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    return pa.paged_attention.launches, fa.flash_attention.launches


def run_engine(cfg, params, *, chunked: bool, launches: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.serving.engine import Engine, PagedLM
    n_req, max_new = 16, 32
    reqs = make_requests(cfg, n_req, 128, 1024, max_new, seed=1)
    lm = PagedLM(cfg, params, max_batch=8, max_seq=1024 + max_new + 16,
                 page_tokens=16, device="cuda")
    eng = Engine(lm, chunked_prefill=chunked, prefill_chunk_pages=4)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    reset_counts()                     # the main path's run starts here
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = read_counts()             # ... and ends here
    st = eng.stats()
    mode = "chunked" if chunked else "whole"
    check(len(eng.finished) == n_req, f"{mode}: not every request finished")
    toks = np.concatenate([r.out_tokens for r in eng.finished])
    check(all(len(r.out_tokens) == max_new for r in eng.finished),
          f"{mode}: a request has the wrong number of tokens")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{mode}: a token lies outside the vocabulary")
    L = cfg.n_layers
    check(k1 == st["decode_steps"] * L,
          f"{mode}: K1 launched {k1} times, expected decode_steps x L = "
          f"{st['decode_steps'] * L}")
    want_k2 = 0 if chunked else n_req * L
    check(k2 == want_k2, f"{mode}: K2 launched {k2} times, expected "
          f"{want_k2}")
    launches[mode] = {"paged_attention": k1, "flash_attention": k2}
    out = {"mode": mode, "requests": n_req, "tokens": int(toks.size),
           "wall_s": wall, "tokens_per_s": toks.size / wall,
           "median_step_ms": st["measured_step_s"] * 1e3,
           "k1_launches": k1, "k2_launches": k2, "stats": st}
    print(f"[engine {mode}] {json.dumps(out)}")
    return {r.rid: list(r.out_tokens) for r in eng.finished}


def compare_paths(cfg, params) -> None:
    """Prefill and one decode step through the kernels vs through the plain
    versions, on the same state, on the card."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.serving.engine import PagedLM

    lm = PagedLM(cfg, params, max_batch=8, max_seq=1024 + 64,
                 page_tokens=16, device="cuda")
    reqs = make_requests(cfg, 8, 128, 1024, 8, seed=2)
    plain = {"paged_attention": ref.paged_attention,
             "flash_attention": ref.mha_attention}

    def through_plain(fn):
        saved = {k: getattr(ops, k) for k in plain}
        for k, f in plain.items():
            setattr(ops, k, f)
        try:
            return fn()
        finally:
            for k, f in saved.items():
                setattr(ops, k, f)

    # whole-prompt prefill: K2 vs plain, on a slot of its own
    r = reqs[0]
    slot = lm.claim_slot(len(r.prompt), 1)
    kern = lm._prefill_logits(slot, r.prompt)
    pl = through_plain(lambda: lm._prefill_logits(slot, r.prompt))
    lm.free_slot(slot)
    e_pre = max_err(kern, pl)
    print(f"[compare] prefill logits: max_abs_err={e_pre:.3e} "
          f"max|logit|={float(pl.abs().max()):.3f} "
          f"argmax {int(kern.argmax())} vs {int(pl.argmax())} "
          f"(tol {LOGIT_TOL})")

    # the state for the decode step: 8 prefilled slots, timed one by one
    pre_ms = []
    for r in reqs:
        slot = lm.claim_slot(len(r.prompt), r.max_new_tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.out_tokens.append(lm.prefill_slot(slot, r.prompt))
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    n_pre = sum(len(r.prompt) for r in reqs)
    print(f"[prefill] per request ms: {[round(x, 3) for x in pre_ms]} "
          f"(prompts {[len(r.prompt) for r in reqs]}; "
          f"{n_pre / (sum(pre_ms) / 1e3):.1f} prompt tokens/s)")

    tokens = np.array([r.out_tokens[-1] for r in reqs], np.int32)
    active = np.ones((8,), bool)
    k_save, v_save = lm.k_pool.clone(), lm.v_pool.clone()
    kern = lm.decode_logits(tokens, active)
    lm.k_pool.copy_(k_save)
    lm.v_pool.copy_(v_save)
    pl = through_plain(lambda: lm.decode_logits(tokens, active))
    e_dec = max_err(kern, pl)
    agree = int((kern.argmax(-1) == pl.argmax(-1)).sum())
    top2 = pl.float().topk(2, dim=-1).values
    gap = float((top2[:, 0] - top2[:, 1]).min())
    print(f"[compare] decode logits: max_abs_err={e_dec:.3e} "
          f"max|logit|={float(pl.abs().max()):.3f} argmax agreement "
          f"{agree}/{len(tokens)} (smallest top-2 gap {gap:.3e}, tol "
          f"{LOGIT_TOL})")
    check(e_pre <= LOGIT_TOL and e_dec <= LOGIT_TOL,
          f"kernels and plain versions disagree on logits "
          f"({e_pre:.3e}, {e_dec:.3e} > {LOGIT_TOL})")
    # greedy decoding must pick the same tokens: the run is seeded and both
    # paths are deterministic, so a flip is a fault, not noise
    check(agree == len(tokens),
          f"decode argmax differs on {len(tokens) - agree} of "
          f"{len(tokens)} rows")
    profile_decode(lm, tokens, active)


def profile_decode(lm, tokens, active, steps: int = 5) -> None:
    """Where a decode step's time goes: wall time per step (host clock
    around synchronised steps, without the profiler), device time by kernel
    (torch.profiler, over the same number of steps) and the device's busy
    share of the unprofiled wall time.  Each step rewrites the same K/V
    rows, so the state does not drift."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lm.decode_logits(tokens, active)           # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        lm.decode_logits(tokens, active)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lm.decode_logits(tokens, active)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side rows only (kernels, copies): an operator's row repeats the
    # time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3 / steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_ms = sum(ms for _, ms in rows)
    out = {"batch": int(active.sum()),
           "context_tokens": int(lm.seq_lens.sum()),
           "step_wall_ms": wall_ms,
           "step_wall_ms_under_profiler": prof_wall_ms,
           "device_ms": dev_ms if rows else "not measured",
           "device_busy_share": dev_ms / wall_ms if rows else "not measured",
           "top_device_ms": [[k, ms] for k, ms in
                             sorted(rows, key=lambda r: -r[1])[:8]]}
    print(f"[profile decode step] {json.dumps(out)}")


def compare_with_cpu() -> None:
    """A reduced fp32 model (D=64 heads, so the kernels take it) served on
    the card and, from the same weights, on the CPU: same greedy tokens."""
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine, PagedLM
    cfg = configs.get_config("qwen2-0.5b").reduced(head_dim=64)
    gen = torch.Generator(device="cpu").manual_seed(3)
    params = api.get_model(cfg).init(gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = type(params)(cfg, device=dev)
        p.load_state_dict(params.state_dict())
        for chunked in (False, True):
            lm = PagedLM(cfg, p, max_batch=4, max_seq=96, page_tokens=16,
                         device=dev)
            eng = Engine(lm, chunked_prefill=chunked)
            for r in make_requests(cfg, 6, 5, 60, 12, seed=4):
                eng.submit(r)
            eng.run_to_completion()
            outs[dev, chunked] = {r.rid: r.out_tokens for r in eng.finished}
    for chunked in (False, True):
        check(outs["cuda", chunked] == outs["cpu", chunked],
              f"reduced fp32 model: card and CPU tokens differ "
              f"(chunked={chunked})")
    print("[compare] reduced fp32 qwen2 (D=64): card tokens == CPU tokens, "
          "whole and chunked prefill")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import api

    # fp32 products stay fp32 on the card: TF32 keeps ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_power()
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s")

    report: dict = {}
    run_kernel_checks(report)
    launches: dict = {}                # per engine run: whole, chunked
    cfg = configs.get_config("qwen2-0.5b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = api.get_model(cfg).init(gen)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    print(f"[engine] qwen2-0.5b: {n_par} parameters "
          f"({n_par * 2 / 1e9:.2f} GB bf16), init "
          f"{time.perf_counter() - t0:.1f} s")
    whole = run_engine(cfg, params, chunked=False, launches=launches)
    chunked = run_engine(cfg, params, chunked=True, launches=launches)
    same = sum(whole[i] == chunked[i] for i in whole)
    print(f"[engine] whole vs chunked prefill: {same}/{len(whole)} "
          "requests with identical tokens (bf16)")
    # the main path is the launcher's: whole-prompt prefill, then decode
    check(all(launches["whole"].values()),
          f"a kernel of the main path never launched: {launches}")
    compare_paths(cfg, params)
    compare_with_cpu()
    kernels = []
    for name, r in report.items():
        kernels.append({"name": r["name"], "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": launches["whole"][name],
                        "launches_chunked_prefill":
                            launches["chunked"][name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "kernel_ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
