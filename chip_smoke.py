#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one card

Drives the port's main paths at full width and depth, bf16, random weights
from a seed — paged serving (``PagedLM`` + ``Engine``) of qwen2-0.5b, and
recurrent serving (``api.get_model``: prefill, then greedy ``decode_step``s
against an O(1) state) of rwkv6-1.6b and zamba2-1.2b — and holds every CUDA
kernel of those paths against its plain PyTorch version:

  1. set-up: the card's name and power limit; build the kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
  2. each kernel vs its plain version on the card, at the main paths'
     shapes and their edges (tolerances stated where they are checked), and
     timed with CUDA events beside its bound and the plain version: K1
     paged attention (split-K; at the timed B=16 shape, the engine's batch
     8 with its 67-page table, and one 16k-key row), K2 flash attention
     (tensor cores for bf16; both compute dtypes, beside SDPA), K3 the
     Mamba2 SSD scan, K4 the RWKV6 wkv scan (bf16 prefill on their
     tensor-core kernels, K4's S = 1 on its decode kernel, fp32 prefill on
     the FMA kernels: each call's route is checked; eager ``ms`` and
     CUDA-graph ``ms_graph``);
  3. the engine: 16 requests, whole-prompt prefill and then chunked
     prefill; the launch counters must show every decode layer went
     through K1 (paged attention) and every whole-prefill layer through K2
     (flash attention);
  4. one prefill and one decode step through the kernels vs through the
     plain versions on the same state; and a reduced fp32 model served on
     the card vs the same weights served on the CPU, token for token;
  5. rwkv6-1.6b, then zamba2-1.2b (one model on the card at a time): 4
     prompts of 1024 tokens prefilled as one batch, then 32 greedy decode
     steps; the counters must show K4 on every rwkv6 layer of prefill and
     decode, K3 on every zamba2 backbone layer of prefill and K2 on every
     application of zamba2's shared attention block; prefill and first
     decode logits through the kernels vs through the plain versions; the
     scans' routes on the main path (tensor-core kernels in prefill, K4's
     decode kernel in decode); a profiled prefill and decode step;
  6. reduced fp32 rwkv6, zamba2 and mamba2 models, shaped for the kernels,
     served on the card and on the CPU from the same weights: same tokens;
  7. (run before phase 5, while qwen2's weights are on the card) the
     serving cluster: 8 qwen2-0.5b nodes (``ServingCluster``, one shared
     weight copy) on a 2x2x2 torus, 32 requests; after three decode steps
     four running requests migrate (their KV pages copied between the
     nodes' pools on the card, priced on the shared packet-level fabric
     timeline), the last after ``fail_link`` on its direct route, then
     ``rebalance()`` once.  Every request finishes, every token stream
     equals the run without migration, the faulted move's hops rise, the
     counters show K1 on every decode layer of every node and K2 on every
     whole-prefill layer; the same on the fluid tier with the torch rate
     solver on the card;
  8. the fluid tier at 512 nodes (8x8x8, 2000 flows) with the numpy and
     the torch rate solver: the card's torch solves equal the same solver
     on the host, bytes are conserved per class, the gap to the numpy
     solver is reported; ms per solve for each (the torch solver's
     host-side incidence build and its waterfill on the card apart).

Prints one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``.  Any failed check raises, and the script exits non-zero
without the last line.  It imports nothing of JAX and nothing of the JAX
package ``repro``.

    python3 chip_smoke.py --engine-ab PARENT   # PARENT: another checkout
    python3 chip_smoke.py --scan-ab PARENT

runs phases 3-4 alone (the qwen2 engine, per-request prefill, the profiled
decode step), or K3's and K4's times alone (``ms`` and ``ms_graph`` of K3
and K4 prefill and K4's decode step at the timed shapes), for the port of
PARENT and of this checkout, each in a process of its own, in the order
PARENT, this, this, PARENT: two versions compared on one card in one
call.
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
# Scan outputs in bf16 (K3, K4): kernel and plain version compute in fp32
# from the same bf16 inputs, in another order (K4 multiplies the decays
# where the plain chunked form takes exp(sum log w)), and round to bf16: at
# most an ulp apart, 2^-7 |want| (rel 2^-6 allows two).  Near 0, where the
# ulp vanishes, the two fp32 sums still differ in proportion to the
# magnitudes summed, for which the output's largest magnitude stands: abs
# 2^-12 max|want|, a sixteenth of a bf16 ulp at the top of the range.
SCAN_OUT_REL, SCAN_OUT_ABS = 2.0 ** -6, 2.0 ** -12
# final scan states, fp32 on both sides over up to 1024 steps (the plain
# forms go through exp/log, a few fp32 ulps each): 1e-4 relative plus
# 1e-4 of the state's largest magnitude
SCAN_STATE_REL, SCAN_STATE_ABS = 1e-4, 1e-4
# recurrent serving at full size (section 5)
N_PROMPTS, PROMPT_LEN, DECODE_STEPS = 4, 1024, 32
# Full-depth recurrent models with random bf16 weights amplify last-bit
# differences: two plain versions of the same scan (the chunked form and
# the sequential oracle, both exact in fp32) give bf16 logits 0.31 (rwkv6)
# and 0.77 (zamba2) apart at |logit| ~4.7 (H100).  So in bf16 the
# kernels' logits are held to REC_SPREAD_FACTOR times the spread between
# those two plain versions, measured in the same run (never below
# LOGIT_TOL), and their argmax on every row whose top-2 gap exceeds that
# bound.  The same weights in fp32 carry the tight check, where rounding
# is not amplified to that degree: the kernels must agree with the plain
# version to FP32_LOGIT_TOL (measured 9.3e-5 for rwkv6 and 5.0e-4 for
# zamba2 at full size on an H100) with the same argmax on every row.
REC_SPREAD_FACTOR = 3.0
FP32_LOGIT_TOL = 1e-2
# device kernels of each of our wrappers, by a part of their names: K3's
# mamba2_scan_kernel and mamba2_scan_mma_kernel, K4's rwkv6_scan_kernel,
# rwkv6_scan_mma_kernel and rwkv6_scan_decode_kernel
OUR_KERNELS = {"K1": ("paged_",),   # every kernel of paged_attention.cu
               "K2": ("flash_attention",), "K3": ("mamba2_scan",),
               "K4": ("rwkv6_scan",)}


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


def time_graph_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Per-call device time of fn() with no host in the way: ``iters``
    calls captured in one CUDA graph, replayed ``reps`` times."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * iters)


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

def paged_case(rng, *, B, H, Hkv, D, page, seq_lens, dtype, max_pages=None):
    """Inputs for K1: a scattered page table over a pool with spare pages;
    ``max_pages`` below a row's pages clamps that row's keys."""
    import numpy as np
    import torch
    dev = "cuda"
    if max_pages is None:
        max_pages = max(-(-int(s) // page) for s in seq_lens) + 1
    P = B * max_pages + 7
    perm = rng.permutation(P)[:B * max_pages].reshape(B, max_pages)
    q = torch.randn(B, H, D, device=dev).to(dtype)
    kp = torch.randn(P, page, Hkv, D, device=dev).to(dtype)
    vp = torch.randn(P, page, Hkv, D, device=dev).to(dtype)
    pt = torch.from_numpy(perm.astype(np.int32)).to(dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, sl


def garbage_tail(pt, sl, page):
    """The page table with every entry past a row's resident pages set to
    an id far outside the pool: a kernel that reads one faults."""
    pt = pt.clone()
    for b, s in enumerate(sl.tolist()):
        pt[b, -(-min(s, pt.shape[1] * page) // page):] = 2 ** 30
    return pt


def k1_bound(q, kp, pt, sl):
    """Bytes K1 must move (the resident K/V rows, q, out, the table entries
    in use, seq_lens) and its flops, for these inputs."""
    B, H, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    keys = [min(int(s), pt.shape[1] * page) for s in sl.tolist()]
    n_tok = sum(keys)
    isz = q.element_size()
    nbytes = (2 * n_tok * Hkv * D * isz + 2 * q.numel() * isz
              + sum(-(-s // page) for s in keys) * 4 + B * 4)
    flops = 4.0 * n_tok * H * D
    return n_tok, nbytes, flops, bound(nbytes, flops, q.dtype)


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
    bf = torch.bfloat16
    # the engine's own shape: batch 8, a 67-page table (max_seq 1072)
    engine = paged_case(rng, B=8, H=14, Hkv=2, D=64, page=16,
                        seq_lens=rng.integers(128, 1057, size=8), dtype=bf,
                        max_pages=67)
    long1 = paged_case(rng, B=1, H=14, Hkv=2, D=64, page=16,
                       seq_lens=[16384], dtype=bf)
    cases = [("qwen2 decode B=16 H=14 Hkv=2 D=64 bf16", main, BF16_TOL),
             ("engine shape B=8 67-page table bf16", engine, BF16_TOL),
             ("B=1 one 16384-key sequence bf16 (128 partitions)", long1,
              BF16_TOL),
             ("partition edges 127/128/129/255/256/257, seq_len 0 beside "
              "4000-key rows, bf16",
              paged_case(rng, B=9, H=14, Hkv=2, D=64, page=16,
                         seq_lens=[127, 128, 129, 255, 256, 257, 0, 4000,
                                   4000], dtype=bf), BF16_TOL),
             ("MHA B=8 H=Hkv=32 D=128 bf16",
              paged_case(rng, B=8, H=32, Hkv=32, D=128, page=16,
                         seq_lens=rng.integers(1, 1025, size=8),
                         dtype=bf), BF16_TOL),
             ("H/Hkv=12 (two head chunks) D=128 bf16",
              paged_case(rng, B=3, H=24, Hkv=2, D=128, page=16,
                         seq_lens=[700, 1, 129], dtype=bf), BF16_TOL),
             ("fp32 B=4 H=8 Hkv=1 D=64 page=8 with seq_len 0",
              paged_case(rng, B=4, H=8, Hkv=1, D=64, page=8,
                         seq_lens=[0, 5, 64, 300], dtype=torch.float32),
              FP32_TOL),
             ("fp32 seq_lens past a 3-page table (clamped) D=128",
              paged_case(rng, B=3, H=14, Hkv=2, D=128, page=16,
                         seq_lens=[40, 500, 0], dtype=torch.float32,
                         max_pages=3), FP32_TOL)]
    for name, args, tol in cases:
        q, kp, vp, pt, sl = args
        # entries past a row's length are garbage the kernel must not read
        got = pa.paged_attention(q, kp, vp,
                                 garbage_tail(pt, sl, kp.shape[1]), sl)
        blocks = pa.paged_attention.last_blocks   # the grid launched
        want = ref.paged_attention(*args)
        torch.cuda.synchronize()
        e, s = max_err(got, want), tol_ratio(got, want, tol)
        print(f"[K1] {name}: max_abs_err={e:.3e} max|want|="
              f"{float(want.float().abs().max()):.3e} err/tol={s:.3f} "
              f"(tol {tol[0]:.3g}|want| + {tol[1]:.3g}), "
              f"{blocks} blocks launched")
        check(s <= 1, f"K1 disagrees with its plain version: {name}")
        check(all(not got[b].any() for b, n in enumerate(sl.tolist())
                  if n == 0), f"K1: a row with no key is not 0: {name}")
        errs.append(e)
    # ms is the eager loop, as for every kernel; K1's device time is below
    # the wrapper's host cost, so that loop times the host, and ms_graph
    # replays the calls from a CUDA graph (the device back to back)
    timed = {}
    for tag, (q, kp, vp, pt, sl) in (("", main), ("_engine_shape", engine),
                                     ("_b1_16k", long1)):
        n_tok, nbytes, flops, (b_ms, b_by) = k1_bound(q, kp, pt, sl)
        call = (lambda q=q, kp=kp, vp=vp, pt=pt, sl=sl:
                pa.paged_attention(q, kp, vp, pt, sl))
        ms_graph, ms = time_graph_ms(call), time_ms(call, iters=200)
        blocks = pa.paged_attention.last_blocks   # the grid launched
        timed.update({f"ms{tag}": ms, f"ms_graph{tag}": ms_graph,
                      f"blocks{tag}": blocks})
        if tag:
            timed[f"bound_ms{tag}"] = b_ms
        print(f"[K1] timed{tag or ' (main)'}: B={q.shape[0]} H={q.shape[1]} "
              f"Hkv={kp.shape[2]} D={q.shape[2]} {q.dtype}, table "
              f"{pt.shape[1]} pages, sum(seq_lens)={n_tok}, {nbytes} bytes, "
              f"{flops:.0f} flops: ms={ms:.5f} (eager) ms_graph="
              f"{ms_graph:.5f} bound_ms={b_ms:.6f} ({b_by}), "
              f"{b_ms / ms_graph:.3f} of the bound by ms_graph, {blocks} "
              f"blocks launched")
    check(timed["blocks"] >= 132, f"K1: {timed['blocks']} blocks at the "
          "timed shape, fewer than the card's 132 SMs")
    q, kp, vp, pt, sl = main
    _, _, _, (b_ms, b_by) = k1_bound(q, kp, pt, sl)
    results["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:73",
        max_abs_err=max(errs), ms=timed.pop("ms"),
        plain_ms=time_ms(lambda: ref.paged_attention(q, kp, vp, pt, sl)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, **timed)

    # -- K2: causal prefill attention at the slice's shapes --------------------
    def fa_case(B, H, Hkv, Sq, Skv, D, dtype):
        mk = lambda h, s: torch.randn(B, h, s, D, device="cuda").to(dtype)
        return mk(H, Sq), mk(Hkv, Skv), mk(Hkv, Skv)

    errs = []
    main = fa_case(1, 14, 2, 2048, 2048, 64, torch.bfloat16)
    zamba = fa_case(4, 32, 32, 1024, 1024, 64, torch.bfloat16)
    s1024 = fa_case(1, 14, 2, 1024, 1024, 64, torch.bfloat16)  # engine's
                                                               # longest
    cases = [
        ("qwen2 prefill S=2048 bf16", main, True, torch.float32, BF16_TOL),
        ("qwen2 prefill S=2048 bf16 compute_dtype=bf16", main, True,
         torch.bfloat16, None),
        ("zamba2 shared block B=4 H=Hkv=32 S=1024 bf16", zamba, True,
         torch.float32, BF16_TOL),
        ("qwen2 prefill ragged S=1000 bf16",
         fa_case(1, 14, 2, 1000, 1000, 64, torch.bfloat16), True,
         torch.float32, BF16_TOL),
        *((f"tile edges S={S} bf16",
           fa_case(2, 14, 2, S, S, 64, torch.bfloat16), True, torch.float32,
           BF16_TOL) for S in (63, 64, 65, 127, 129)),
        ("D=128 H=Hkv=32 S=512 bf16 (scale after the product)",
         fa_case(1, 32, 32, 512, 512, 128, torch.bfloat16), True,
         torch.float32, BF16_TOL),
        ("bf16 Sq=300 Skv=100 causal, empty rows",
         fa_case(1, 4, 4, 300, 100, 64, torch.bfloat16), True, torch.float32,
         BF16_TOL),
        ("bf16 non-causal Sq=77 Skv=200",
         fa_case(1, 8, 1, 77, 200, 128, torch.bfloat16), False,
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

    def k2_bound(q, k):
        B, H, S, D = q.shape
        isz = q.element_size()
        visible = S * (S + 1) / 2        # causal keys seen, summed over rows
        nbytes = (2 * q.numel() + 2 * k.numel()) * isz
        flops = 4.0 * B * H * D * visible
        print(f"[K2] timed: B={B} H={H} Hkv={k.shape[1]} S={S} D={D} "
              f"{q.dtype} causal, {nbytes} bytes, {flops:.0f} flops")
        return bound(nbytes, flops, q.dtype)

    def fa_ms(q, k, v, cdt=torch.float32):
        return time_ms(lambda: fa.flash_attention(
            q, k, v, causal=True, compute_dtype=cdt), iters=50)

    def sdpa_ms(q, k, v):
        return time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters=50)

    q, k, v = main
    b_ms, b_by = k2_bound(q, k)
    zb_ms, _ = k2_bound(zamba[0], zamba[1])
    lib_ms = sdpa_ms(q, k, v)
    results["flash_attention"] = r = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:85",
        max_abs_err=max(errs), ms=fa_ms(q, k, v),
        plain_ms=time_ms(lambda: ref.mha_attention(q, k, v, causal=True),
                         iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        ms_graph=time_graph_ms(lambda: fa.flash_attention(q, k, v),
                               iters=20),
        ms_compute_bf16=fa_ms(q, k, v, torch.bfloat16),
        library_ms_repeat=sdpa_ms(q, k, v),
        ms_zamba2_shape=fa_ms(*zamba), bound_ms_zamba2_shape=zb_ms,
        library_ms_zamba2_shape=sdpa_ms(*zamba),
        ms_qwen2_s1024=fa_ms(*s1024), library_ms_qwen2_s1024=sdpa_ms(*s1024))
    print(f"[K2] qwen2 prefill shape: ms={r['ms']:.5f} (compute fp32; "
          f"graph-replayed {r['ms_graph']:.5f}), compute_dtype=bf16 "
          f"{r['ms_compute_bf16']:.5f}; SDPA {lib_ms:.5f} / "
          f"{r['library_ms_repeat']:.5f}; {r['ms'] / lib_ms:.2f}x SDPA; "
          f"bound {b_ms:.6f} ({b_by}). zamba2 shape: "
          f"{r['ms_zamba2_shape']:.5f} vs SDPA "
          f"{r['library_ms_zamba2_shape']:.5f}; qwen2 S=1024: "
          f"{r['ms_qwen2_s1024']:.5f} vs SDPA "
          f"{r['library_ms_qwen2_s1024']:.5f}")
    for r in results.values():
        r["kernel_ms"] = r["ms"]
    report.update(results)
    return results


def scan_tol(want, rel, ab):
    """(rel, abs) with abs a fraction of want's largest magnitude."""
    return rel, ab * float(want.float().abs().max())


def mamba_case(B, S, H, dtype, *, h0: bool, seed: int):
    """K3 inputs shaped as zamba2's prefill gives them: softplus-ed dt, A
    from -1 to -16 (up to exp(-32) a step), ds = dh = 64."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, device="cuda", generator=g)
    x = rn(B, S, H, 64).to(dtype)
    dt = F.softplus(rn(B, S, H))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm, Cm = rn(B, S, 64).to(dtype), rn(B, S, 64).to(dtype)
    D = torch.ones(H, device="cuda")
    return x, dt, A, Bm, Cm, D, (rn(B, H, 64, 64) if h0 else None)


def mixer_views(case):
    """K3 inputs as zamba2's mixer hands them over: x, B and C views
    into one (B, S, H*dh + 2*ds) projection (ssm.py's split), not
    contiguous."""
    import torch
    x, dt, A, Bm, Cm, D, h0 = case
    B, S, H, dh = x.shape
    xbc = torch.cat([x.reshape(B, S, H * dh), Bm, Cm], -1)
    xv, bv, cv = torch.split(xbc, [H * dh, Bm.shape[-1], Cm.shape[-1]], -1)
    return xv.reshape(B, S, H, dh), dt, A, bv, cv, D, h0


def rwkv_case(B, S, H, dtype, *, s0: bool, seed: int):
    """K4 inputs shaped as rwkv6's time-mix gives them: w = exp(-exp(w0 +
    lora)) around w0 = -3 (slow decay), u ~ 0.1."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, device="cuda", generator=g)
    r, k, v = (rn(B, S, H, 64).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(-3.0 + 0.5 * rn(B, S, H, 64))).to(dtype)
    u = 0.1 * rn(H, 64)
    return r, k, v, w, u, (rn(B, H, 64, 64) if s0 else None)


def scan_times(m2, rw) -> dict:
    """``ms`` (the eager loop: the wrapper's host cost and the device) and
    ``ms_graph`` (CUDA-graph replay: the device alone) of the scan wrappers
    ``m2.mamba2_scan`` and ``rw.rwkv6_scan`` at the main paths' timed
    shapes: K3 and K4 prefill (bf16, S = 1024, no state in, state out) and
    K4's decode step (S = 1, state in and out)."""
    import torch
    bf = torch.bfloat16
    x, dt, A, Bm, Cm, D, _ = mamba_case(4, 1024, 64, bf, h0=False, seed=1)
    r, k, v, w, u, _ = rwkv_case(4, 1024, 32, bf, s0=False, seed=6)
    rd, kd, vd, wd, ud, sd = rwkv_case(4, 1, 32, bf, s0=True, seed=9)
    k3 = lambda: m2.mamba2_scan(x, dt, A, Bm, Cm, D, return_state=True)
    k4 = lambda: rw.rwkv6_scan(r, k, v, w, u, return_state=True)
    k4d = lambda: rw.rwkv6_scan(rd, kd, vd, wd, ud, s0=sd, return_state=True)
    return {"mamba2_scan": dict(ms=time_ms(k3),
                                ms_graph=time_graph_ms(k3, iters=20)),
            "rwkv6_scan": dict(ms=time_ms(k4),
                               ms_graph=time_graph_ms(k4, iters=20),
                               ms_decode=time_ms(k4d, iters=50),
                               ms_graph_decode=time_graph_ms(k4d))}


def run_scan_checks(report: dict) -> dict:
    """K3 and K4 vs their plain versions at the recurrent paths' shapes:
    with and without state in, state out, a ragged S and S = 1."""
    import torch

    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rw

    results = {}
    routes = {"K3": {}, "K4": {}}
    times = scan_times(m2, rw)

    def routed(fn, want, name):
        """The device kernel the wrapper's C entry point reported."""
        tag = "K3" if fn is m2.mamba2_scan else "K4"
        check(fn.last_kernel == want, f"{tag} {name}: launched "
              f"{fn.last_kernel}, expected {want}")
        routes[tag][name] = fn.last_kernel

    def held(tag, name, got, want):
        (gy, gs), (wy, ws) = got, want
        tol_y = scan_tol(wy, SCAN_OUT_REL, SCAN_OUT_ABS)
        tol_s = scan_tol(ws, SCAN_STATE_REL, SCAN_STATE_ABS)
        ry, rs = tol_ratio(gy, wy, tol_y), tol_ratio(gs, ws, tol_s)
        e = max_err(gy, wy)
        print(f"[{tag}] {name}: out max_abs_err={e:.3e} max|want|="
              f"{float(wy.float().abs().max()):.3e} err/tol={ry:.3f}; "
              f"state max_abs_err={max_err(gs, ws):.3e} max|want|="
              f"{float(ws.abs().max()):.3e} err/tol={rs:.3f}")
        check(ry <= 1 and rs <= 1,
              f"{tag} disagrees with its plain version: {name}")
        return e

    # -- K3: zamba2 prefill, B=4 S=1024 H=64 dh=ds=64 -----------------------
    bf = torch.bfloat16
    cases = [("zamba2 prefill B=4 S=1024 H=64 bf16, state out",
              mamba_case(4, 1024, 64, bf, h0=False, seed=1)),
             ("B=4 S=1024 H=64 bf16, state in and out",
              mamba_case(4, 1024, 64, bf, h0=True, seed=2)),
             ("ragged S=1000 bf16, state in and out",
              mamba_case(4, 1000, 64, bf, h0=True, seed=3)),
             *((f"chunk edge S={S} bf16, state in and out",
                mamba_case(2, S, 8, bf, h0=True, seed=30 + S))
               for S in (15, 16, 63, 65)),
             ("zamba2 mixer's strided views B=2 S=300 H=8 bf16, state in "
              "and out", mixer_views(mamba_case(2, 300, 8, bf, h0=True,
                                                seed=40))),
             ("S=1 bf16, state in and out",
              mamba_case(4, 1, 64, bf, h0=True, seed=4)),
             ("fp32 B=2 S=300 H=8, state in and out",
              mamba_case(2, 300, 8, torch.float32, h0=True, seed=5))]
    errs = []
    for name, (x, dt, A, Bm, Cm, D, h0) in cases:
        got = m2.mamba2_scan(x, dt, A, Bm, Cm, D, h0=h0, return_state=True)
        routed(m2.mamba2_scan, "mamba2_scan_mma_kernel" if x.dtype == bf
               else "mamba2_scan_kernel", name)
        want = ref.mamba2_scan_chunked(x, dt, A, Bm, Cm, D, h0=h0,
                                       return_state=True)
        torch.cuda.synchronize()
        errs.append(held("K3", name, got, want))
    x, dt, A, Bm, Cm, D, _ = cases[0][1]
    B, S, H, dh = x.shape
    ds = Bm.shape[-1]
    isz = x.element_size()
    nbytes = (2 * x.numel() + 2 * Bm.numel()) * isz + dt.numel() * 4 \
        + 2 * H * 4 + B * H * ds * dh * 4
    flops = B * S * H * (5.0 * ds * dh + 2 * dh)
    b_ms, b_by = bound(nbytes, flops, x.dtype)
    print(f"[K3] timed: B={B} S={S} H={H} dh={dh} ds={ds} {x.dtype}, no "
          f"state in, state out: {nbytes} bytes, {flops:.0f} flops "
          f"(state-passing form)")
    results["mamba2_scan"] = dict(
        name="mamba2_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/mamba2_scan.cu",
        replaces="src/repro/kernels/mamba2_scan.py:69",
        max_abs_err=max(errs), **times["mamba2_scan"],
        plain_ms=time_ms(lambda: ref.mamba2_scan_chunked(
            x, dt, A, Bm, Cm, D, return_state=True), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # -- K4: rwkv6 prefill B=4 S=1024 H=32 dh=64, and its decode step -------
    strong = rwkv_case(2, 200, 8, bf, s0=True, seed=12)
    sw = torch.exp(-torch.exp(2.0 * torch.randn(
        strong[3].shape, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(13)) + 1.0))
    sw[:, 5:9] = 0.0                      # w = 0: the 1e-30 floor
    sw[:, 40:44] = 1e-39                  # a bf16 denormal
    strong = strong[:3] + (sw.to(bf),) + strong[4:]
    cases = [("rwkv6 prefill B=4 S=1024 H=32 bf16, state out",
              rwkv_case(4, 1024, 32, bf, s0=False, seed=6)),
             ("B=4 S=1024 H=32 bf16, state in and out",
              rwkv_case(4, 1024, 32, bf, s0=True, seed=7)),
             ("ragged S=1000 bf16, state in and out",
              rwkv_case(4, 1000, 32, bf, s0=True, seed=8)),
             *((f"chunk edge S={S} bf16, state in and out",
                rwkv_case(2, S, 8, bf, s0=True, seed=20 + S))
               for S in (2, 15, 16, 63, 64, 65)),
             ("strong decay (w = 0, denormal w) S=200 bf16, state in and "
              "out", strong),
             ("rwkv6 decode S=1 bf16, state in and out",
              rwkv_case(4, 1, 32, bf, s0=True, seed=9)),
             ("decode S=1 fp32, state in and out",
              rwkv_case(4, 1, 32, torch.float32, s0=True, seed=11)),
             ("fp32 B=2 S=300 H=8, state in and out",
              rwkv_case(2, 300, 8, torch.float32, s0=True, seed=10))]
    errs = []
    for name, (r, k, v, w, u, s0) in cases:
        got = rw.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
        S = r.shape[1]
        routed(rw.rwkv6_scan, "rwkv6_scan_decode_kernel" if S == 1
               else "rwkv6_scan_mma_kernel" if r.dtype == bf
               else "rwkv6_scan_kernel", name)
        want = ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0,
                                      return_state=True)
        torch.cuda.synchronize()
        errs.append(held("K4", name, got, want))

    def k4_bound(r, s_in):
        B, S, H, dh = r.shape
        nbytes = 5 * r.numel() * r.element_size() + H * dh * 4 \
            + (1 + s_in) * B * H * dh * dh * 4
        flops = B * S * H * 5.0 * dh * dh
        return nbytes, flops, bound(nbytes, flops, r.dtype)

    r, k, v, w, u, _ = cases[0][1]
    nbytes, flops, (b_ms, b_by) = k4_bound(r, False)
    print(f"[K4] timed prefill: B={r.shape[0]} S={r.shape[1]} "
          f"H={r.shape[2]} dh={r.shape[3]} {r.dtype}, no state in, state "
          f"out: {nbytes} bytes, {flops:.0f} flops")
    rd, kd, vd, wd, ud, sd = next(c for n, c in cases
                                  if n.startswith("rwkv6 decode"))
    nb_d, fl_d, (bd_ms, bd_by) = k4_bound(rd, True)
    print(f"[K4] timed decode: B={rd.shape[0]} S=1 H={rd.shape[2]}, state "
          f"in and out: {nb_d} bytes, {fl_d:.0f} flops")
    results["rwkv6_scan"] = dict(
        name="rwkv6_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:59",
        max_abs_err=max(errs), **times["rwkv6_scan"],
        plain_ms=time_ms(lambda: ref.rwkv6_scan_chunked(
            r, k, v, w, u, return_state=True), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        plain_ms_decode=time_ms(lambda: ref.rwkv6_scan_chunked(
            rd, kd, vd, wd, ud, s0=sd, return_state=True)),
        bound_ms_decode=bd_ms, bound_by_decode=bd_by)
    results["mamba2_scan"]["device_routes"] = routes["K3"]
    results["rwkv6_scan"]["device_routes"] = routes["K4"]
    for r_ in results.values():
        r_["kernel_ms"] = r_["ms"]
        dec = (f"; decode ms={r_['ms_decode']:.5f} ms_graph_decode="
               f"{r_['ms_graph_decode']:.5f} bound_ms_decode="
               f"{r_['bound_ms_decode']:.6f}" if "ms_decode" in r_ else "")
        print(f"[{r_['name']}] ms={r_['ms']:.5f} ms_graph="
              f"{r_['ms_graph']:.5f} plain_ms={r_['plain_ms']:.4f} "
              f"bound_ms={r_['bound_ms']:.6f} ({r_['bound_by']}){dec}; "
              f"library: none (no single PyTorch call computes the scan)")
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


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as rw
    return {"paged_attention": pa.paged_attention,
            "flash_attention": fa.flash_attention,
            "mamba2_scan": m2.mamba2_scan, "rwkv6_scan": rw.rwkv6_scan}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def through_plain(fn, *, oracle: bool = False):
    """Run fn() with every kernel of ``ops`` swapped for its plain version
    (the CPU path's functions, here on the card's tensors); ``oracle``
    takes the scans' sequential oracles instead of their chunked forms."""
    from repro_torch.kernels import ops, ref
    plain = {"paged_attention": ref.paged_attention,
             "flash_attention": ref.mha_attention,
             "mamba2_scan": ref.mamba2_scan if oracle
             else ref.mamba2_scan_chunked,
             "rwkv6_scan": ref.rwkv6_scan if oracle
             else ref.rwkv6_scan_chunked}
    saved = {k: getattr(ops, k) for k in plain}
    for k, f in plain.items():
        setattr(ops, k, f)
    try:
        return fn()
    finally:
        for k, f in saved.items():
            setattr(ops, k, f)


def run_engine(cfg, params, *, chunked: bool,
               launches: dict) -> tuple[dict, dict]:
    """Serve 16 requests; returns their tokens by request id and the
    run's walls and tokens/s."""
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
    counts = read_counts()             # ... and ends here
    k1, k2 = counts["paged_attention"], counts["flash_attention"]
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
    check(counts["mamba2_scan"] == counts["rwkv6_scan"] == 0,
          f"{mode}: a scan kernel launched on the transformer path: {counts}")
    launches[mode] = counts
    out = {"mode": mode, "requests": n_req, "tokens": int(toks.size),
           "wall_s": wall, "tokens_per_s": toks.size / wall,
           "median_step_ms": st["measured_step_s"] * 1e3,
           "k1_launches": k1, "k2_launches": k2, "stats": st}
    print(f"[engine {mode}] {json.dumps(out)}")
    return {r.rid: list(r.out_tokens) for r in eng.finished}, out


def compare_paths(cfg, params) -> dict:
    """Prefill and one decode step through the kernels vs through the plain
    versions, on the same state, on the card; returns the per-request
    prefill times and the profiled decode step."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import PagedLM

    lm = PagedLM(cfg, params, max_batch=8, max_seq=1024 + 64,
                 page_tokens=16, device="cuda")
    reqs = make_requests(cfg, 8, 128, 1024, 8, seed=2)

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
    pre_tps = n_pre / (sum(pre_ms) / 1e3)
    print(f"[prefill] per request ms: {[round(x, 3) for x in pre_ms]} "
          f"(prompts {[len(r.prompt) for r in reqs]}; "
          f"{pre_tps:.1f} prompt tokens/s)")

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
    return {"prefill_ms": pre_ms, "prompt_tokens_per_s": pre_tps,
            "decode_step": profile_decode(lm, tokens, active)}


def device_profile(fn, steps: int) -> dict:
    """Where a call's time goes: wall time per call (host clock around
    synchronised calls, without the profiler), device time by kernel
    (torch.profiler, over the same number of calls) and the device's busy
    share of the unprofiled wall time.  fn() must leave the state it reads
    as it found it (or rewrite the same rows), so the calls do not drift."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()                                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side rows only (kernels, copies): an operator's row repeats the
    # time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3 / steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_ms = sum(ms for _, ms in rows)
    ours = {tag: sum(ms for k, ms in rows if any(n in k for n in names))
            for tag, names in OUR_KERNELS.items()}
    ours = {tag: ms for tag, ms in ours.items() if ms}
    return {"step_wall_ms": wall_ms,
            "step_wall_ms_under_profiler": prof_wall_ms,
            "device_ms": dev_ms if rows else "not measured",
            "device_busy_share": dev_ms / wall_ms if rows else "not measured",
            "our_kernels_device_ms": ours,
            "our_kernels_device_share": {
                tag: ms / dev_ms for tag, ms in ours.items()},
            "top_device_ms": [[k, ms] for k, ms in
                              sorted(rows, key=lambda r: -r[1])[:8]]}


def profile_decode(lm, tokens, active, steps: int = 5) -> dict:
    """The engine's decode step: each step rewrites the same K/V rows."""
    out = {"batch": int(active.sum()),
           "context_tokens": int(lm.seq_lens.sum()),
           **device_profile(lambda: lm.decode_logits(tokens, active), steps)}
    print(f"[profile decode step] {json.dumps(out)}")
    return out


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


# ----------------------------------------------------------------------------
# phase 7: the serving cluster (live KV-page migration on the shared fabric)
# ----------------------------------------------------------------------------

CLUSTER_REQUESTS = 32
CLUSTER_MAX_NEW = 32


def run_cluster(cfg, params, *, migrate: bool, fidelity: str = "packet",
                sim_kw: dict | None = None) -> dict:
    """8 qwen2-0.5b nodes on a 2x2x2 torus sharing the one weight copy on
    the card: 32 requests; with ``migrate``, after a few decode steps four
    running requests move (the last after ``fail_link`` on its direct
    route) and ``rebalance()`` runs once."""
    import torch

    from repro_torch.core.topology import Torus
    from repro_torch.serving.cluster import ServingCluster
    torus = Torus((2, 2, 2))
    cl = ServingCluster(cfg, params, torus=torus, max_batch=8,
                        max_seq=1024 + CLUSTER_MAX_NEW + 16, page_tokens=16,
                        tp_axes=(), fidelity=fidelity, sim_kw=sim_kw,
                        device="cuda")
    reqs = make_requests(cfg, CLUSTER_REQUESTS, 128, 1024, CLUSTER_MAX_NEW,
                         seed=5)
    for r in reqs:
        cl.submit(r)
    torch.cuda.synchronize()
    reset_counts()                     # the cluster path's run starts here
    t0 = time.perf_counter()
    for _ in range(4):                 # prefill + three decode steps
        cl.step()
    reports, faulted = [], None
    if migrate:
        # four running requests, each to the source's +x neighbour; the
        # last after its direct link fails, so it must detour
        moves = []
        for src in (0, 2, 5, 7):
            rid = min(r.rid for r in cl.nodes[src].engine.running.values())
            moves.append((rid, src, torus.neighbors(src)[0]))
        for i, (rid, src, dst) in enumerate(moves):
            if i == len(moves) - 1:
                cl.fail_link(src, dst)
                faulted = len(reports)
            reports.append(cl.migrate(rid, dst))
        moved = cl.rebalance()
        if moved is not None:
            reports.append(moved)
    cl.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()             # ... and ends here
    st = cl.stats()
    steps = sum(n["decode_steps"] for n in st["nodes"].values())
    return {"tokens": {r.rid: list(r.out_tokens) for r in cl.finished},
            "finished": len(cl.finished), "counts": counts,
            "decode_steps": steps, "wall_s": wall, "reports": reports,
            "faulted": faulted, "stats": st}


def cluster_phase(cfg, params) -> dict:
    """Phase 7: the cluster with and without migrations, on the packet
    tier and on the fluid tier with the torch rate solver on the card;
    returns the migrating packet run's launch counts (the cluster path)."""
    import numpy as np
    base = run_cluster(cfg, params, migrate=False)
    moved = run_cluster(cfg, params, migrate=True)
    fluid = run_cluster(cfg, params, migrate=True, fidelity="fluid",
                        sim_kw={"solver": "torch"})
    L = cfg.n_layers
    for name, run in (("no migration", base), ("packet", moved),
                      ("fluid/torch solver", fluid)):
        check(run["finished"] == CLUSTER_REQUESTS,
              f"cluster ({name}): {run['finished']} of {CLUSTER_REQUESTS} "
              "requests finished")
        toks = np.concatenate([t for t in run["tokens"].values()])
        check(all(len(t) == CLUSTER_MAX_NEW for t in run["tokens"].values())
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"cluster ({name}): wrong token count or token outside the "
              "vocabulary")
        c = run["counts"]
        check(c["paged_attention"] == run["decode_steps"] * L,
              f"cluster ({name}): K1 launched {c['paged_attention']} times, "
              f"expected decode steps of all nodes x L = "
              f"{run['decode_steps'] * L}")
        check(c["flash_attention"] == CLUSTER_REQUESTS * L,
              f"cluster ({name}): K2 launched {c['flash_attention']} times, "
              f"expected one whole prefill a request x L = "
              f"{CLUSTER_REQUESTS * L}")
        check(c["mamba2_scan"] == c["rwkv6_scan"] == 0,
              f"cluster ({name}): a scan kernel launched: {c}")
    for name, run in (("packet", moved), ("fluid/torch solver", fluid)):
        diff = [rid for rid in base["tokens"]
                if run["tokens"][rid] != base["tokens"][rid]]
        first = None
        if diff:
            a, b = base["tokens"][diff[0]], run["tokens"][diff[0]]
            first = next(i for i in range(len(a)) if a[i] != b[i])
        check(not diff, f"cluster ({name}): requests {diff} differ from the "
              f"run without migration (first at step {first} of request "
              f"{diff[0] if diff else None})")
        check(len(run["reports"]) >= 4, f"cluster ({name}): "
              f"{len(run['reports'])} migrations")
        f = run["reports"][run["faulted"]]
        check(f.hops > f.min_hops,
              f"cluster ({name}): the faulted migration took {f.hops} hops "
              f"(healthy {f.min_hops})")
    gen = CLUSTER_REQUESTS * CLUSTER_MAX_NEW
    for name, run in (("no migration", base), ("packet", moved),
                      ("fluid/torch solver", fluid)):
        out = {"run": name, "generated_tokens": gen, "wall_s": run["wall_s"],
               "tokens_per_s": gen / run["wall_s"],
               "decode_steps_all_nodes": run["decode_steps"],
               "k1": run["counts"]["paged_attention"],
               "k2": run["counts"]["flash_attention"],
               "median_node_step_ms": float(np.median(
                   [n["measured_step_s"] for n in
                    run["stats"]["nodes"].values()])) * 1e3,
               "modelled_fabric_s": run["stats"]["fabric_sim_now_s"]}
        print(f"[cluster] {json.dumps(out)}")
        for i, m in enumerate(run["reports"]):
            print(f"[cluster {name}] migration {i} (modelled fabric time, "
                  f"not card time): rid {m.rid} {m.src}->{m.dst} "
                  f"{m.n_pages} pages {m.nbytes} B, hops {m.hops} "
                  f"(min {m.min_hops}), modelled_s {m.modelled_s:.6e}, "
                  f"isolated_s {m.isolated_s:.6e}, reprefill_s "
                  f"{m.reprefill_s:.6e}, speedup {m.speedup:.2f}x")
    print(f"[cluster] all {CLUSTER_REQUESTS} requests finished on both tiers"
          "; migrated token streams == the run without migration")
    return moved["counts"]


# ----------------------------------------------------------------------------
# phase 8: the fluid tier's rate solver at 512 nodes
# ----------------------------------------------------------------------------

SOLVER_DIMS = (8, 8, 8)
SOLVER_FLOWS = 2000


def solver_workload(seed: int = 0) -> list:
    """2000 multi-class flows, 64 KB..2 MB, staggered starts on 8x8x8 (the
    JAX package's ``benchmarks/simscale.py`` workload, same generator)."""
    import random

    from repro_torch.core.fabric import TrafficClass
    rng = random.Random(seed)
    n = 1
    for d in SOLVER_DIMS:
        n *= d
    flows = []
    for _ in range(SOLVER_FLOWS):
        src = rng.randrange(n)
        dst = rng.randrange(n)
        while dst == src:
            dst = rng.randrange(n)
        nbytes = rng.randint(64 * 1024, 2 * 1024 * 1024)
        cls = rng.choice(list(TrafficClass))
        start = rng.randint(0, 4) * 200e-6
        flows.append((src, dst, nbytes, cls, start))
    return flows


def fluid_run(flows, **kw):
    """One ``FluidSim`` run of ``flows`` on the 8x8x8 torus; returns the
    finish times, the sim (its flow ids are 0, 1, ... in ``flows`` order)
    and its wall seconds."""
    import numpy as np

    from repro_torch.core import fabric
    from repro_torch.core.topology import Torus
    fabric.clear_route_cache()
    t0 = time.perf_counter()
    sim = fabric.make_sim(Torus(SOLVER_DIMS), fidelity="fluid",
                          qos=fabric.QosPolicy(), **kw)
    fids = [sim.inject(s, d, nb, cls=c, start_s=st)
            for s, d, nb, c, st in flows]
    sim.run()
    wall = time.perf_counter() - t0
    assert fids == list(range(len(flows)))
    return np.array([sim.finish_s(f) for f in fids]), sim, wall


def solver_phase() -> None:
    """Phase 8: ``FluidSim`` with the numpy solver and with the torch solver
    on the card, on one workload (the default settings, which the cluster
    uses).

    The torch solver ports the JAX package's jnp waterfill, thresholds
    and all (a link saturates at 1e-6 of its rate, against the numpy
    solver's 1e-9), and on this workload the two algorithms part: the
    run's numpy-vs-torch gaps (per solve and in the finish times) are
    reported, not held (ROADMAP §3; the CPU tests hold the torch solver to
    the jnp one on the largest of these solves).  Held: the card's solves
    against the same solver on the host (the three largest active sets,
    rtol 1e-4: fp32 sums in another order), and bytes conserved per class
    in both runs.  Timed: ms per solve of each solver, the torch solver's
    host-side incidence build and its waterfill on the card apart."""
    import numpy as np

    from repro_torch.core import fabric
    from repro_torch.core.fabric import fluid
    flows = solver_workload()
    spent = {k: [0, 0.0] for k in ("np", "torch", "waterfill")}
    gap_np = [0.0]
    largest: list = []                 # (alive flows, inputs, card rates)
    saved = {"np": fluid.FluidSim._rates_np,
             "torch": fluid.FluidSim._rates_torch,
             "waterfill": fluid._torch_waterfill}

    def timed(key, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)   # returns numpy: the card is synced
            finally:
                spent[key][0] += 1
                spent[key][1] += time.perf_counter() - t0
        return call

    def rates_torch(self, act):
        got = timed("torch", saved["torch"])(self, act)
        want = saved["np"](self, act)  # not timed: the gap, reported
        gap_np[0] = max(gap_np[0], float(np.max(np.abs(got - want) / want)))
        return got

    def waterfill(*args):
        out = timed("waterfill", saved["waterfill"])(*args)
        largest.append((int(args[4].sum()), args[:-1], out[0]))
        largest.sort(key=lambda x: -x[0])
        del largest[3:]
        return out

    fluid.FluidSim._rates_np = timed("np", saved["np"])
    fluid.FluidSim._rates_torch = rates_torch
    fluid._torch_waterfill = waterfill
    try:
        f_np, s_np, w_np = fluid_run(flows)
        f_t, s_t, w_t = fluid_run(flows, solver="torch")
    finally:
        fluid.FluidSim._rates_np = saved["np"]
        fluid.FluidSim._rates_torch = saved["torch"]
        fluid._torch_waterfill = saved["waterfill"]
    host_err = 0.0
    for n_alive, args, card in largest:
        host, _ = saved["waterfill"](*args, "cpu")
        live = args[4] > 0
        host_err = max(host_err, float(np.max(
            np.abs(card[live] - host[live]) / host[live])))
    (n_np, t_np), (n_t, t_t) = spent["np"], spent["torch"]
    t_wf = spent["waterfill"][1]
    # n_solves counts every solve; the solver runs in those with >= 2
    # active flows (one flow takes the link rate)
    out = {"dims": list(SOLVER_DIMS), "flows": SOLVER_FLOWS,
           "links": len(s_t._lid_keys),
           "card_vs_host_max_rel_err": host_err,
           "card_vs_host_solves": [n for n, _, _ in largest],
           "torch_vs_np_per_solve_max_rel_gap": gap_np[0],
           "torch_vs_np_finish_max_rel_gap": float(
               np.max(np.abs(f_t - f_np) / f_np)),
           "np": {"n_solves": s_np.n_solves, "solver_calls": n_np,
                  "sim_wall_s": w_np,
                  "ms_per_solve": t_np / max(n_np, 1) * 1e3},
           "torch": {"n_solves": s_t.n_solves, "solver_calls": n_t,
                     "sim_wall_s": w_t, "ms_per_solve": t_t / n_t * 1e3,
                     "host_build_ms_per_solve": (t_t - t_wf) / n_t * 1e3,
                     "waterfill_ms_per_solve": t_wf / n_t * 1e3}}
    print(f"[solver 512 nodes] {json.dumps(out)}")
    check(s_t.device == "cuda", "the torch solver did not run on the card")
    check(host_err <= 1e-4, f"512-node fluid: the torch solver on the card "
          f"differs from itself on the host by {host_err:.3e} (rtol 1e-4)")
    want = {c: 0.0 for c in fabric.TrafficClass}
    for fid, (_, _, nb, c, _) in enumerate(flows):
        want[c] += nb * s_t.flow(fid).hops
    for sim in (s_np, s_t):
        got = sim.class_stats()
        check(all(abs(got[c] - want[c]) <= 1e-9 * want[c] for c in want),
              f"512-node fluid: class bytes not conserved: {got} vs {want}")


# ----------------------------------------------------------------------------
# phases 5-6: recurrent serving (rwkv6, zamba2)
# ----------------------------------------------------------------------------

def expected_launches(cfg) -> dict:
    """The launches one prefill of (N_PROMPTS, PROMPT_LEN) and DECODE_STEPS
    greedy decode steps must show, per kernel."""
    want = dict.fromkeys(kernel_wrappers(), 0)
    if cfg.family == "rwkv6":      # K4: every layer, prefill and decode
        want["rwkv6_scan"] = cfg.n_layers * (1 + DECODE_STEPS)
    if cfg.family == "zamba2":     # K3 every backbone layer, K2 every
        want["mamba2_scan"] = cfg.n_layers  # shared block, prefill only
        want["flash_attention"] = cfg.n_layers // cfg.attn_every
    return want


def serve_recurrent(name: str) -> dict:
    """Prefill (N_PROMPTS, PROMPT_LEN) as one batch, then DECODE_STEPS greedy
    decode steps, through ``api.get_model`` at full size; returns the
    kernels' launches of that run."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.models import api
    cfg = configs.get_config(name)
    model = api.get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[{cfg.name}] {n_par} parameters ({n_bytes / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(N_PROMPTS, PROMPT_LEN))).to("cuda")}
    kw = ({"max_len": PROMPT_LEN + DECODE_STEPS}
          if cfg.family == "zamba2" else {})
    model.prefill(params, batch, **kw)         # warm: cuBLAS, first launches
    torch.cuda.synchronize()

    reset_counts()                             # the main path's run
    t0 = time.perf_counter()
    logits, state = model.prefill(params, batch, **kw)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    # the device kernel each scan wrapper launched last, in prefill
    routes = {"prefill": tuple(fn.last_kernel for fn in
                               (m2.mamba2_scan, rw.rwkv6_scan)
                               if fn.launches)}
    tok = logits[:, -1].argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(DECODE_STEPS):
        logits, state = model.decode_step(params, tok, state, PROMPT_LEN + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    counts = read_counts()                     # ... ends here
    if cfg.family == "rwkv6":      # the decode steps ran last
        check(routes["prefill"] == ("rwkv6_scan_mma_kernel",)
              and rw.rwkv6_scan.last_kernel == "rwkv6_scan_decode_kernel",
              f"{cfg.name}: K4 took {routes['prefill']} in prefill and "
              f"{rw.rwkv6_scan.last_kernel} in decode")
    if cfg.family == "zamba2":
        check(routes["prefill"] == ("mamba2_scan_mma_kernel",),
              f"{cfg.name}: K3 took {routes['prefill']} in prefill")
    toks = torch.cat(out, 1).cpu().numpy()
    check(tuple(logits.shape) == (N_PROMPTS, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name}: decode logits not finite or of the wrong shape")
    check(toks.shape == (N_PROMPTS, DECODE_STEPS + 1)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{cfg.name}: a token lies outside the vocabulary")
    want = expected_launches(cfg)
    check(counts == want, f"{cfg.name}: launches {counts}, expected {want}")
    res = {"model": cfg.name, "prompts": N_PROMPTS, "prompt_len": PROMPT_LEN,
           "decode_steps": DECODE_STEPS, "prefill_ms": pre_s * 1e3,
           "prompt_tokens_per_s": N_PROMPTS * PROMPT_LEN / pre_s,
           "decode_ms_per_step": dec_s * 1e3 / DECODE_STEPS,
           "generated_tokens_per_s": N_PROMPTS * DECODE_STEPS / dec_s,
           "launches": counts, "scan_routes": {
               "prefill": routes["prefill"],
               "decode": rw.rwkv6_scan.last_kernel
               if cfg.family == "rwkv6" else None},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[serve {cfg.name}] {json.dumps(res)}")

    compare_recurrent_paths(cfg, model, params, batch, kw)
    _, state = model.prefill(params, batch, **kw)
    tok = logits[:, -1].argmax(-1)[:, None]
    prof = {"prefill": device_profile(
        lambda: model.prefill(params, batch, **kw), 1),
        "decode step": device_profile(
        lambda: model.decode_step(params, tok, state, PROMPT_LEN), 3)}
    for what, p in prof.items():
        print(f"[profile {cfg.name} {what}] {json.dumps(p)}")
    return counts


def first_logits(model, params, batch, kw, *, plain=False, oracle=False):
    """Last-token logits of the prefill and of one decode step from the
    kernels' prefill state (zamba2 rewrites the same cache row each time),
    through the kernels or, with ``plain``, through the plain versions."""
    run = (lambda f: through_plain(f, oracle=oracle)) if plain \
        else (lambda f: f())
    lk, state = model.prefill(params, batch, **kw)
    tok = lk[:, -1].argmax(-1)[:, None]
    pre = run(lambda: model.prefill(params, batch, **kw))[0]
    dec = run(lambda: model.decode_step(params, tok, state, PROMPT_LEN))[0]
    return pre[:, -1].float(), dec[:, -1].float()


def compare_recurrent_paths(cfg, model, params, batch, kw) -> None:
    """The first prefill and decode logits through the kernels vs through
    the plain versions: in bf16 (the served weights) against the spread of
    two plain versions, and in fp32 (the same weights, upcast) tightly."""
    import dataclasses

    import torch

    from repro_torch.models import api
    kern = first_logits(model, params, batch, kw)
    plain = first_logits(model, params, batch, kw, plain=True)
    orac = first_logits(model, params, batch, kw, plain=True, oracle=True)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = type(params)(cfg32, device="cuda")
    p32.load_state_dict(params.state_dict())
    m32 = api.get_model(cfg32)
    kern32 = first_logits(m32, p32, batch, kw)
    plain32 = first_logits(m32, p32, batch, kw, plain=True)
    del p32
    torch.cuda.synchronize()
    for i, what in enumerate(("prefill", "decode")):
        k, p, o = kern[i], plain[i], orac[i]
        spread = max_err(p, o)
        tol = max(REC_SPREAD_FACTOR * spread, LOGIT_TOL)
        e = max_err(k, p)
        top2 = p.topk(2, dim=-1).values
        gaps = top2[:, 0] - top2[:, 1]
        same = k.argmax(-1) == p.argmax(-1)
        clear = gaps > tol
        print(f"[compare {cfg.name}] bf16 {what} logits: max_abs_err="
              f"{e:.3e} max|logit|={float(p.abs().max()):.3f}; two plain "
              f"versions (chunked vs sequential) {spread:.3e} apart, tol "
              f"{tol:.3e}; argmax agreement {int(same.sum())}/{len(same)}, "
              f"on the {int(clear.sum())} rows with a top-2 gap above tol "
              f"{int(same[clear].sum())} (top-2 gaps "
              f"{[round(float(g), 4) for g in gaps]})")
        check(e <= tol, f"{cfg.name}: bf16 {what} logits of the kernels "
              f"and the plain versions differ by {e:.3e} > {tol:.3e}")
        check(bool(same[clear].all()),
              f"{cfg.name}: bf16 {what} argmax differs on a row whose "
              f"top-2 gap exceeds {tol:.3e}")
        k, p = kern32[i], plain32[i]
        e = max_err(k, p)
        agree = int((k.argmax(-1) == p.argmax(-1)).sum())
        top2 = p.topk(2, dim=-1).values
        gap = float((top2[:, 0] - top2[:, 1]).min())
        print(f"[compare {cfg.name}] fp32 {what} logits: max_abs_err={e:.3e}"
              f" max|logit|={float(p.abs().max()):.3f} argmax agreement "
              f"{agree}/{k.shape[0]} (smallest top-2 gap {gap:.3e}, tol "
              f"{FP32_LOGIT_TOL})")
        check(e <= FP32_LOGIT_TOL and agree == k.shape[0],
              f"{cfg.name}: fp32 {what} logits of the kernels and the plain "
              f"versions disagree ({e:.3e}, argmax {agree}/{k.shape[0]})")


def compare_recurrent_with_cpu() -> None:
    """Reduced fp32 rwkv6, zamba2 and mamba2 models shaped for the kernels
    (head_dim 64; ssm head_dim 64, d_state 64), served on the card and,
    from the same weights, on the CPU: same greedy tokens."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.models.common import SsmCfg
    ssm = SsmCfg(d_state=64, head_dim=64)
    cases = [("rwkv6-1.6b", None, dict(head_dim=64)),
             ("zamba2-1.2b", None, dict(head_dim=64, ssm=ssm)),
             ("zamba2-1.2b", "mamba2", dict(ssm=ssm))]
    S, steps = 70, 8                       # 70: one chunk of 64 and a tail
    for name, family, over in cases:
        cfg = configs.get_config(name)
        if family:
            cfg = dataclasses.replace(cfg, family=family)
        cfg = cfg.reduced(**over)
        model = api.get_model(cfg)
        params = model.init(torch.Generator(device="cpu").manual_seed(3))
        toks = torch.from_numpy(np.random.default_rng(6).integers(
            0, cfg.vocab, size=(2, S)))
        kw = {"max_len": S + steps} if cfg.family == "zamba2" else {}
        outs = {}
        for dev in ("cpu", "cuda"):
            p = type(params)(cfg, device=dev)
            p.load_state_dict(params.state_dict())
            reset_counts()
            logits, state = model.prefill(p, {"tokens": toks.to(dev)}, **kw)
            seq = []
            for i in range(steps):
                tok = logits[:, -1].argmax(-1)[:, None]
                seq.append(tok.cpu())
                logits, state = model.decode_step(p, tok, state, S + i)
            outs[dev] = torch.cat(seq, 1)
            if dev == "cuda":
                launched = {k: v for k, v in read_counts().items() if v}
        check(torch.equal(outs["cuda"], outs["cpu"]),
              f"reduced fp32 {cfg.family}: card and CPU tokens differ")
        check(bool(launched), f"reduced {cfg.family}: no kernel launched")
        print(f"[compare] reduced fp32 {cfg.family} (kernel shapes): card "
              f"tokens == CPU tokens over {steps} decode steps; kernels "
              f"launched on the card: {launched}")


# ----------------------------------------------------------------------------
# --engine-ab / --scan-ab: two checkouts of the port, on one card
# ----------------------------------------------------------------------------

def engine_only(src: str) -> None:
    """Phases 3-4 with the port under ``src``: one ``[engine-ab]`` line."""
    sys.path.insert(0, src)
    import torch

    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(("paged_attention", "flash_attention"))
    cfg = configs.get_config("qwen2-0.5b")
    params = api.get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    res: dict = {"package": str(Path(repro_torch.__file__).parent)}
    for chunked in (False, True):
        _, run = run_engine(cfg, params, chunked=chunked, launches={})
        res["chunked" if chunked else "whole"] = run
    res.update(compare_paths(cfg, params))
    print(f"[engine-ab] {json.dumps(res)}")


def scans_only(src: str) -> None:
    """K3's and K4's ``ms`` and ``ms_graph`` (``scan_times``) with the port
    under ``src``: one ``[scan-ab]`` line."""
    sys.path.insert(0, src)
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as rw
    _build.build_all(("mamba2_scan", "rwkv6_scan"))
    res = {"package": str(Path(repro_torch.__file__).parent),
           **scan_times(m2, rw)}
    print(f"[scan-ab] {json.dumps(res)}")


def ab_runs(parent: str, only: str, tag: str) -> list:
    """``chip_smoke.py --<only> SRC`` for PARENT's port and this one, each in
    a process of its own, in the order PARENT, this, this, PARENT; returns
    (label, the run's ``[tag]`` JSON) for each."""
    trees = [("parent", Path(parent).resolve()), ("this", ROOT),
             ("this", ROOT), ("parent", Path(parent).resolve())]
    rows = []
    for label, tree in trees:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), f"--{only}",
             str(tree / "src")], capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        check(proc.returncode == 0, f"the {only} run of {tree} failed")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith(f"[{tag}] ")][-1]
        rows.append((label, json.loads(line[len(tag) + 3:])))
    return rows


def scan_ab(parent: str) -> None:
    """K3's and K4's times for PARENT's port and this one, on one card."""
    for label, r in ab_runs(parent, "scans-only", "scan-ab"):
        k3, k4 = r["mamba2_scan"], r["rwkv6_scan"]
        print(f"[scan-ab {label}] K3 prefill ms {k3['ms']:.5f} ms_graph "
              f"{k3['ms_graph']:.5f}; K4 prefill ms {k4['ms']:.5f} ms_graph "
              f"{k4['ms_graph']:.5f}; K4 decode ms {k4['ms_decode']:.5f} "
              f"ms_graph {k4['ms_graph_decode']:.5f}")


def engine_ab(parent: str) -> None:
    """Phases 3-4 for PARENT's port and this one, on one card."""
    for label, r in ab_runs(parent, "engine-only", "engine-ab"):
        d = r["decode_step"]
        print(f"[engine-ab {label}] whole: {r['whole']['tokens_per_s']:.1f} "
              f"tokens/s, wall {r['whole']['wall_s']:.3f} s, median step "
              f"{r['whole']['median_step_ms']:.2f} ms; chunked: "
              f"{r['chunked']['tokens_per_s']:.1f} tokens/s; prefill "
              f"{r['prompt_tokens_per_s']:.1f} prompt tokens/s; decode step "
              f"wall {d['step_wall_ms']:.3f} ms, device {d['device_ms']} ms, "
              f"busy {d['device_busy_share']}, ours "
              f"{d['our_kernels_device_ms']}")


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine-ab", metavar="PARENT",
                    help="phases 3-4 alone, for PARENT's port and this one")
    ap.add_argument("--engine-only", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--scan-ab", metavar="PARENT",
                    help="K3's and K4's times alone, for PARENT's port and "
                         "this one")
    ap.add_argument("--scans-only", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.engine_only:
        engine_only(args.engine_only)
        return 0
    if args.engine_ab:
        engine_ab(args.engine_ab)
        return 0
    if args.scans_only:
        scans_only(args.scans_only)
        return 0
    if args.scan_ab:
        scan_ab(args.scan_ab)
        return 0
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
    run_scan_checks(report)
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
    whole, _ = run_engine(cfg, params, chunked=False, launches=launches)
    chunked, _ = run_engine(cfg, params, chunked=True, launches=launches)
    same = sum(whole[i] == chunked[i] for i in whole)
    print(f"[engine] whole vs chunked prefill: {same}/{len(whole)} "
          "requests with identical tokens (bf16)")
    # the main path is the launcher's: whole-prompt prefill, then decode
    check(launches["whole"]["paged_attention"] > 0
          and launches["whole"]["flash_attention"] > 0,
          f"a kernel of the engine path never launched: {launches}")
    compare_paths(cfg, params)
    compare_with_cpu()
    cluster_counts = cluster_phase(cfg, params)
    del params                         # one model on the card at a time
    torch.cuda.empty_cache()

    # each main path is read on its own: qwen2's engine (whole prefill, the
    # launcher's default), then rwkv6 and zamba2 served through get_model
    paths = {"qwen2_engine": launches["whole"],
             "qwen2_cluster": cluster_counts}
    for name in ("rwkv6-1.6b", "zamba2-1.2b"):
        torch.cuda.reset_peak_memory_stats()
        paths[name] = serve_recurrent(name)
        torch.cuda.empty_cache()
    compare_recurrent_with_cpu()
    solver_phase()
    kernels = []
    for name, r in report.items():
        by_path = {p: c[name] for p, c in paths.items() if c[name]}
        entry = {"name": r["name"], "route": r["route"],
                 "source": r["source"], "replaces": r["replaces"],
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "launches_chunked_prefill": launches["chunked"][name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "kernel_ms": r["kernel_ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        # further shapes and variants: *_decode, ms_engine_shape, ...
        entry.update({k: v for k, v in r.items() if k not in entry})
        kernels.append(entry)
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel of the main paths never launched: {paths}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
