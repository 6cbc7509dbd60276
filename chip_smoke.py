#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # needs one card

Drives the port's main paths at full width and depth, bf16, random weights
from a seed — paged serving (``PagedLM`` + ``Engine``) of qwen2-0.5b,
recurrent serving (``api.get_model``: prefill, then greedy ``decode_step``s
against an O(1) state) of rwkv6-1.6b and zamba2-1.2b, training of qwen2,
whisper-large-v3 served and trained, rwkv6-1.6b and zamba2-1.2b trained,
olmoe-1b-7b (MoE) served and trained, and the partitioned rank programs of
the recurrent families and whisper — and holds every CUDA kernel of those
paths against its plain PyTorch version:

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
     CUDA-graph ``ms_graph``); (2c) every kernel's small-width route (the
     widths outside its fast routes: D other than 64 / 128, dh and ds other
     than 64) at the reduced configs' shapes, fp32 and bf16, against its
     plain version, its route checked per call, timed in fp32;
  3. the engine: 16 requests, whole-prompt prefill and then chunked
     prefill; the launch counters must show every decode layer went
     through K1 (paged attention) and every whole-prefill layer through K2
     (flash attention);
  4. one prefill and one decode step through the kernels vs through the
     plain versions on the same state; and the CPU tests' reduced fp32
     qwen2 (head_dim 16) served on the card vs the same weights served on
     the CPU, token for token, through K1's and K2's small-width routes;
  5. rwkv6-1.6b, then zamba2-1.2b (one model on the card at a time): 4
     prompts of 1024 tokens prefilled as one batch, then 32 greedy decode
     steps; the counters must show K4 on every rwkv6 layer of prefill and
     decode, K3 on every zamba2 backbone layer of prefill and K2 on every
     application of zamba2's shared attention block; prefill and first
     decode logits through the kernels vs through the plain versions; the
     scans' routes on the main path (tensor-core kernels in prefill, K4's
     decode kernel in decode); a profiled prefill and decode step;
  6. the CPU tests' reduced fp32 rwkv6, zamba2 and mamba2 (head_dim 16,
     ssm 8 x 8) served on the card and on the CPU from the same weights:
     same tokens, launches exact, every one on a small-width route;
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
     host-side incidence build and its waterfill on the card apart);
  9. training: (a) K2-bwd (``csrc/flash_attention_bwd.cu``) vs autograd
     through the plain attention at the training and prefill shapes and
     their edges (bf16 under both compute dtypes, fp32, D=128 non-causal,
     empty causal rows; olmoe's, starcoder2's and deepseek's head layouts
     at D=128), each call's route checked (bf16 with D=64 or 128 on that
     width's wgmma pair, fp32 on the FMA pair), timed beside its bound, the
     plain backward and SDPA's (eager, and graph-replayed); (b)
     qwen2-0.5b at full width, bf16, trained 10 steps through
     ``Trainer(comm="single")`` (batch 8 x 1024, remat, AdamW): finite
     falling losses, K2 2 x 24, K2-bwd 24 and AdamW's kernel pair 1
     launches a step and nothing else, step ms, tokens/s, a profiled
     step, peak memory; (c)
     checkpoint-restart: a second trainer resumes at step 3 and its steps
     4-6 equal the first's bitwise (depth cut to 4 layers, so each
     checkpoint is ~1.6 GB); (d) the reduced fp32 qwen2 trained 5 steps on
     the card (small-width routes) and on the CPU: losses within rtol
     1e-4; (e) ``[train gspmd]``: qwen2-0.5b at full width trained 3 steps
     through ``Trainer(comm="gspmd")`` on a 1 x 1 ("data", "model") mesh
     over NCCL (world size 1) and through ``comm="single"`` from the same
     seed, clipping inactive: the same losses bitwise (single's kernel
     pair updates as GSPMD's eager update does), K2 48 and K2-bwd 24
     launches a step, AdamW's pair once a step in the single run, each
     path's step ms and the device's busy share;
 10. whisper-large-v3 (the encoder-decoder family), last, alone on the
     card: (a) served through ``api.get_model`` at full width, 8 segments
     of 1500 frames and a 224-token prompt prefilled, then 64 greedy steps;
     K2 exactly 96 a prefill (encoder, decoder self- and cross-attention)
     and 32 a decode step (cross-attention), nothing else; prefill and
     first decode logits through the kernels vs the plain version (bf16
     against two plain versions' spread, fp32 tightly); encoder, prefill
     and decode times, a profiled prefill and decode step; (b) the reduced
     fp32 whisper of the CPU tests (head_dim 16) gives the CPU's tokens;
     (c)
     trained 3 steps through ``Trainer(comm="single")`` (batch 2 x (1500
     frames + 448 tokens), remat, AdamW): finite losses, K2 192, K2-bwd
     96 and AdamW's pair 1 launches a step; (d) the reduced fp32 whisper
     trained 3 steps on the card and on the CPU: losses within rtol
     1e-4. Phases 2 and 9a
     hold K2 and K2-bwd at every shape whisper's main paths give them
     (serving at batch 8: the encoder S = 1500, the causal decoder prefill
     S = 224, cross Sq = 224 / 1 against 1500 frames; training at batch 2:
     the encoder, the causal decoder S = 448, cross 448 x 1500) and time
     them;
 11. the recurrent families trained: (a) K4-bwd and K3-bwd, each in its
     two routes (bf16: ``csrc/rwkv6_scan_bwd_chunk.cu`` and
     ``csrc/mamba2_scan_bwd_chunk.cu``, chunk-parallel; fp32:
     ``csrc/rwkv6_scan_bwd.cu`` and ``csrc/mamba2_scan_bwd.cu``,
     sequential), vs the plain backward (autograd through the chunked
     forms) at rwkv6's training shape (B=4, S=1024, H=32) and zamba2's
     (B=4, S=1024, H=64, ds=64, x/B/C as the mixer's strided views) and
     their edges (S = 1, S = 37, a state in and its gradient out, w under
     the floor), every edge in bf16 and fp32 with each call's route
     checked, each gradient within bar * max|want| (fp32 3e-4, bf16 6e-2),
     reruns bitwise, timed (eager and graph-replayed) beside the bound and
     the plain backward, the fp32 route beside;
     (b, c) rwkv6-1.6b, then zamba2-1.2b, at full width, bf16, trained 3
     steps through ``Trainer(comm="single")`` (batch 4 x 1024, remat,
     AdamW): finite losses, per step exactly K4 48 and K4-bwd 24 (rwkv6),
     K3 76, K3-bwd 38, K2 6 and K2-bwd 6 (zamba2), AdamW's pair 1, step
     ms, tokens/s, a profiled step, peak memory; (d) the reduced fp32 rwkv6, mamba2 and
     zamba2 of the CPU tests trained 3 steps on the card (small-width
     routes) and on the CPU: losses within rtol 1e-4, the launches exact.  Phase 9a holds K2-bwd at
     zamba2's shared-block shape too;
 12. the MoE family, alone on the card: olmoe-1b-7b (16 layers, 16
     heads of 128, 64 experts top-8), the first model path through K1, K2
     and K2-bwd at head width 128: (a) served at full width and depth
     through the paged engine with the qwen2 engine's traffic (16
     requests, max_batch 8, pages of 16, 32 new tokens), whole and chunked
     prefill: K1 exactly decode steps x 16 on its split-K route, K2 16 a
     request on its ``mma`` route (whole prefill); prefill and decode ms,
     tokens/s, busy share, peak memory; every layer's K1 and K2 call of 4
     prefills and a decode step held to its plain version on the kernel
     path's own inputs at phase 2's bars (a top-k router can send a token
     to other experts at a near-tie, so the end-to-end logit gap is
     reported beside the tokens whose layer-0 top-8 set differs, not
     held); (b) trained at full width with the depth cut to 4 layers (batch
     4 x 1024, remat, AdamW) through ``Trainer(comm="single")`` and then
     ``Trainer(comm="gspmd")`` on a 1 x 1 mesh over NCCL from the same
     seed, clipping inactive: losses bitwise equal (on one rank both take
     JAX's fallback to the global dispatch), K2 8 and K2-bwd 4 a step
     exactly (K2-bwd at bf16 D = 128 on its wgmma pair), AdamW's pair
     once a step in the single run, step ms, tokens/s, busy share, peak
     memory, tokens/s x 6 x the active parameters; (c) the reduced fp32
     olmoe of the CPU tests served (tokens, whole and chunked prefill) and
     trained 3 steps (losses, rtol 1e-4) on the card and the CPU, on the
     small-width routes alone.  Phases 2 and 9a hold and time K1, K2 and
     K2-bwd at olmoe's shapes (K1 at the engine's decode, B = 8, H = Hkv
     = 16; K2 causal at the engine's longest prompt, B = 1 S = 1024, and
     the training forward 4 x 1024; K2-bwd 4 x 1024), beside SDPA;
 13. the dry run (``launch/dryrun.py``), last: (a) qwen2-0.5b at phase
     9's training shape and olmoe-1b-7b at phase 12b's (4 layers), one
     step each through the GSPMD rank program on a 1 x 1 mesh, traced on
     meta and run on the card inside the op-level analyzer: FLOPs equal as
     integers, the kernels' reported launches equal to their counters, the
     roofline at most the measured device time, the predicted peak within
     [0.5, 2] of the card's; olmoe's active parameters checked against the
     per-layer arithmetic at 16 and 4 layers; (b) four production cells on
     meta (smollm-135m train_4k multipod with the JAX dry run's bars,
     deepseek-7b train_4k, olmoe-1b-7b decode_32k and rwkv6-1.6b
     long_500k on the pod); (c) the three single-device examples
     (``examples/*_torch.py``) on the card, each exiting 0 with its kernels
     launched; (d) one short autotuner search on the host, printed; 13b
     also holds the pod's tensor-parallel serving cells (deepseek-7b,
     internvl2-76b, moonshot decode_32k; qwen2-0.5b, deepseek-7b
     prefill_32k) split over "model", the decode cells within 80 GB;
 14. tensor-parallel serving (``models/transformer.py``'s rank programs),
     as far as one card holds it (one card cannot host two NCCL ranks):
     (a) qwen2-0.5b and olmoe-1b-7b at full width and depth, bf16, 8
     prompts of 1024 tokens and 32 greedy steps through ``prefill`` /
     ``decode_step`` with no mesh and on a 1 x 1 ("data", "model") mesh
     over NCCL: tokens and logits bitwise equal, K2 exactly L a prefill,
     each path's decode step ms and busy share (a "model" axis of one
     rank takes the plain path, so both runs are that path: the rank
     programs themselves run only on gloo CPU ranks, in the tests); (b) the "seq" layout's
     log-sum-exp combine at internvl2-76b's decode_32k rank shape (8 rows,
     64 / 8 heads of 128, bf16, 16 slices of a 32768-deep cache, pos in the
     first slice and at the end) against the whole sequence at phase 2's
     bf16 bar; (c) K2 at deepseek-7b's head-parallel prefill_32k rank (2
     rows, 2 heads of 128, causal) against its plain version at S = 4096,
     timed at S = 32768 beside SDPA; (d) qwen2-0.5b's decode step on a 1 x
     1 mesh through the dry run, on meta and on the card: FLOPs equal.
 15. partitioned serving of the recurrent families (the rank programs of
     ``models/rwkv.py``, ``ssm.py`` and ``hybrid.py``): (a) K4's split-key
     route at rwkv6-1.6b's decode_32k pod rank (8 rows, 32 heads, 4 of 64
     keys) against its plain version, and the sum of the 16 key slices'
     readout parts against K4's full-state S = 1 route, timed; (b) K4 and
     K3 at a prefill rank's heads (2 of 32, 4 of 64) and at the whole
     heads, 4 x 1024 tokens, against their plain versions, timed; (c)
     rwkv6-1.6b and zamba2-1.2b through the entry points on a 1 x 1 NCCL
     mesh, bitwise the plain path's (a gate: no rank program runs);
     (d) the rank programs run whole on 4 gloo ranks, each a process on
     the one card (gloo stages their collectives in host memory): both
     models at full width and depth, 4 prompts of 256 tokens and 4 decode
     steps fed the plain path's tokens, bf16 (the main path: K4 at the
     rank's heads and the split-key route, K3 and K2 at zamba2's, launches
     counted) and fp32 (logits within FP32_LOGIT_TOL of the plain path's,
     the same argmax on every row), every state leaf the rank's
     ``decode_state_specs`` shard.
 16. partitioned serving of the encoder-decoder family (the rank programs
     of ``models/encdec.py``), last: (a) whisper-large-v3 through the
     entry points on a 1 x 1 NCCL mesh, bitwise the plain path's (a
     gate); (b) K2's LSE route at a rank's frames slice of its decode
     cross-attention (8 rows, 20 heads of 64, Sq = 1, 4 slices of 375 of
     1500 frames, bf16): each slice's output and LSE against its plain
     version, the slices' LSE combine against K2 over all the frames,
     timed beside the bound and SDPA; (c) the rank programs run whole on
     8 gloo ranks sharing the card, whisper-large-v3 at full width and
     depth, 2 segments of 1500 frames, a 64-token prompt and 4 decode
     steps fed the fp32 plain path's tokens, on mesh (1, 8) (the pod's
     layouts: self K/V on the sequence, cross K/V on the layers, the
     layer's owner computing its cross-attention) and on ranks 0-2 on
     (1, 3) (the cross K/V on the frames: K2's LSE route); fp32 within
     FP32_LOGIT_TOL of the plain path with its argmax, bf16 (the main
     path) every K2 call held to its plain version and the launches
     exact, every state leaf its ``decode_state_specs`` shard.
 17. the training step's AdamW update (``kernels/adamw.py``, the kernel
     pair of ``csrc/adamw.cu``), at the leaf shapes of olmoe-1b-7b at 4
     layers and deepseek-7b at 6 (1.88 B and 2.05 B parameters, bf16,
     the fp32 router), random bf16 gradients, one tensor without one:
     one step against the plain version leaf by leaf, bitwise with
     clipping inactive; the kernel's gradient norm against an fp64 sum;
     ``ms`` (the in-place entry point, eager), ``ms_graph`` (the kernel
     pair's launch replayed in a CUDA graph), the kernels' device time
     under the profiler, the plain version's ``ms`` and the bound (every
     parameter, gradient and moment byte the step must move, twice the
     gradient's, at 3.35 TB/s); the row's launches are the main paths'
     (the training phases above, each held to once a single step).

Each phase's wall time is printed (``[phase]``, ``[phase walls]``), and
each kernel's cost on the main paths, launches x (ms - bound) at the
shape timed for each path's calls (``[ranking]``).

Prints one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``.  Any failed check raises, and the script exits non-zero
without the last line.  It imports nothing of JAX and nothing of the JAX
package ``repro``.

    python3 chip_smoke.py --engine-ab PARENT   # PARENT: another checkout
    python3 chip_smoke.py --scan-ab PARENT
    python3 chip_smoke.py --bwd-ab PARENT
    python3 chip_smoke.py --scan-bwd-ab PARENT
    python3 chip_smoke.py --train-only        # phases 1, 2c, 9 and 11
    python3 chip_smoke.py --moe-only          # 1, 2's K1/K2, 9a and 12
    python3 chip_smoke.py --dryrun-only       # 1 and 13
    python3 chip_smoke.py --serve-tp-only     # 1, 2 and 14
    python3 chip_smoke.py --serve-rec-tp-only # 1, 2's K3/K4 and 15
    python3 chip_smoke.py --serve-encdec-tp-only  # 1 and 16
    python3 chip_smoke.py --adamw-only        # 1 and 17

runs phases 3-4 alone (the qwen2 engine, per-request prefill, the profiled
decode step), K3's and K4's times alone (``ms`` and ``ms_graph`` of K3
and K4 prefill and K4's decode step at the timed shapes), K2-bwd's
(``ms`` and ``ms_graph`` at the training and prefill shapes under both
compute dtypes), or K3-bwd's and K4-bwd's (``ms`` and ``ms_graph`` at
their bf16 training shapes), for the port of PARENT and of this checkout,
each in a process of its own, in the order PARENT, this, this, PARENT: two
versions compared on one card in one call.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
# whisper-large-v3 (phase 10; arXiv:2212.04356): 8 segments of 1500 frames
# (30 s of audio each, whisper's n_audio_ctx), a 224-token prompt
# (n_text_ctx // 2, the previous-window conditioning of long-form
# transcription), then 64 greedy steps: max_len 288, within n_text_ctx 448.
# Its bf16 logits are held as the recurrent models' are, against the
# spread of two plain versions of K2's function (ref.mha_attention, and
# the same softmax summed over key blocks), and tightly in fp32.
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS = 8, 224, 64
# training: batch 2 x 448 tokens (n_text_ctx) and 2 x 1500 frames, 3 steps
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 2, 448, 3
# olmoe-1b-7b (phase 12; arXiv:2409.02060: 16 layers, d_model 2048, 16
# heads of 128, 64 experts top-8 of width 1024, vocab 50304), bf16, random
# weights from seed 0: served with the qwen2 engine's traffic (16 requests
# of 128-1024 prompt tokens, max_batch 8, pages of 16, 32 new tokens), and
# trained at full width with the depth cut 16 -> 4 (memory: weights, fp32
# moments and the stacked copies of a 6.9B-parameter step), batch 4 x 1024
OLMOE = "olmoe-1b-7b"
OLMOE_TRAIN_LAYERS, OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ = 4, 4, 1024
OLMOE_TRAIN_STEPS = 3
OLMOE_BWD_SHAPE = (OLMOE_TRAIN_BATCH, 16, 16, OLMOE_TRAIN_SEQ,
                   OLMOE_TRAIN_SEQ, 128)
# device kernels of each of our wrappers, by a part of their names
OUR_KERNELS = {"K1": ("paged_",),   # every kernel of paged_attention.cu
               "K2": ("flash_attention",),
               "K3": ("mamba2_scan_kernel", "mamba2_scan_mma_kernel",
                      "mamba2_scan_small_kernel"),
               "K4": ("rwkv6_scan_kernel", "rwkv6_scan_mma_kernel",
                      "rwkv6_scan_decode_kernel", "rwkv6_scan_small_kernel"),
               "K2-bwd": ("attn_bwd_",),   # flash_attention_bwd.cu
               "AdamW": ("adamw_norm_kernel", "adamw_update_kernel"),
               # fp32 route: the kernel and its head sum; bf16 route: the
               # state walk, the chunk kernel and the sum
               "K3-bwd": ("mamba2_scan_bwd_kernel",
                          "mamba2_scan_bwd_reduce_kernel",
                          "mamba2_scan_bwd_state_kernel",
                          "mamba2_scan_bwd_chunk_kernel",
                          "mamba2_scan_bwd_sum_kernel"),
               "K4-bwd": ("rwkv6_scan_bwd_kernel", "rwkv6_du_reduce_kernel",
                          "rwkv6_scan_bwd_state_kernel",
                          "rwkv6_scan_bwd_chunk_kernel",
                          "rwkv6_scan_bwd_du_kernel")}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


PHASE_WALLS: dict = {}      # phase -> wall seconds, printed at the end


def phase(name: str, fn, *args):
    """fn(*args), its wall time kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_WALLS[name] = round(time.perf_counter() - t0, 1)
    print(f"[phase] {name}: {PHASE_WALLS[name]} s")
    return out


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


def attn_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """The (query, key) pairs an attention's mask leaves
    (``kernels/cost.py``)."""
    from repro_torch.kernels import cost
    return cost.attn_pairs(Sq, Skv, causal)


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
    """The resident tokens, the bytes K1 must move and its flops for these
    inputs (``kernels/cost.py``), and its bound."""
    from repro_torch.kernels import cost
    B, H, D = q.shape
    flops, nbytes, n_tok = cost.paged_attention(
        B, H, kp.shape[2], D, kp.shape[1], pt.shape[1], sl.tolist(),
        q.element_size())
    return n_tok, nbytes, flops, bound(nbytes, flops, q.dtype)


def k2_shape_times(tag, q, k, v, causal, compute_dtype=None) -> dict:
    """K2 at one more shape of a main path: ms, ms_graph, the bound (4 B H
    D flops over the (query, key) pairs the mask leaves; q, k, v read, out
    written), the plain version and SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import flash_attention as fa

    cdt = compute_dtype or torch.float32
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    flops, nbytes = cost.flash_attention(B, H, k.shape[1], Sq, Skv, D,
                                         causal, q.element_size())
    b, by = bound(nbytes, flops, q.dtype)
    call = lambda: fa.flash_attention(  # noqa: E731
        q, k, v, causal=causal, compute_dtype=cdt)
    out = {f"ms_{tag}": time_ms(call, iters=50),
           f"ms_graph_{tag}": time_graph_ms(call, iters=20),
           f"bound_ms_{tag}": b, f"bound_by_{tag}": by,
           f"plain_ms_{tag}": time_ms(lambda: ref.mha_attention(
               q, k, v, causal=causal, compute_dtype=cdt), iters=3,
               warmup=1),
           f"library_ms_{tag}": time_ms(
               lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, enable_gqa=True),
               iters=50)}
    print(f"[K2] {tag}: B={B} H={H} Hkv={k.shape[1]} Sq={Sq} Skv={Skv} "
          f"D={D} bf16 {'causal' if causal else 'non-causal'}, {nbytes} "
          f"bytes, {flops:.4g} flops: ms={out[f'ms_{tag}']:.5f} "
          f"ms_graph={out[f'ms_graph_{tag}']:.5f} bound {b:.5f} ({by}),"
          f" {b / out[f'ms_graph_{tag}']:.3f} of the bound; plain "
          f"{out[f'plain_ms_{tag}']:.4f}; SDPA "
          f"{out[f'library_ms_{tag}']:.5f}")
    return out


def run_kernel_checks(report: dict) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
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
    # olmoe-1b-7b (phase 12): MHA, 16 heads of 128 (one query row a KV
    # head), at the batch of 16 and at its engine's batch of 8 (timed)
    olmoe = paged_case(rng, B=16, H=16, Hkv=16, D=128, page=16,
                       seq_lens=lens, dtype=bf)
    olmoe_engine = paged_case(rng, B=8, H=16, Hkv=16, D=128, page=16,
                              seq_lens=rng.integers(128, 1057, size=8),
                              dtype=bf, max_pages=67)
    cases = [("qwen2 decode B=16 H=14 Hkv=2 D=64 bf16", main, BF16_TOL),
             ("olmoe decode B=16 H=Hkv=16 D=128 bf16", olmoe, BF16_TOL),
             ("olmoe engine shape B=8 H=Hkv=16 D=128 67-page table bf16",
              olmoe_engine, BF16_TOL),
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
                                     ("_b1_16k", long1),
                                     ("_olmoe_engine", olmoe_engine)):
        n_tok, nbytes, flops, (b_ms, b_by) = k1_bound(q, kp, pt, sl)
        call = (lambda q=q, kp=kp, vp=vp, pt=pt, sl=sl:
                pa.paged_attention(q, kp, vp, pt, sl))
        ms_graph, ms = time_graph_ms(call), time_ms(call, iters=200)
        blocks = pa.paged_attention.last_blocks   # the grid launched
        timed.update({f"ms{tag}": ms, f"ms_graph{tag}": ms_graph,
                      f"blocks{tag}": blocks})
        if tag:
            timed[f"bound_ms{tag}"] = b_ms
            timed[f"plain_ms{tag}"] = time_ms(
                lambda q=q, kp=kp, vp=vp, pt=pt, sl=sl: ref.paged_attention(
                    q, kp, vp, pt, sl), iters=5)
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

    # -- K2: attention at the main paths' shapes ------------------------------
    def fa_case(B, H, Hkv, Sq, Skv, D, dtype):
        mk = lambda h, s: torch.randn(B, h, s, D, device="cuda").to(dtype)
        return mk(H, Sq), mk(Hkv, Skv), mk(Hkv, Skv)

    errs = []
    main = fa_case(1, 14, 2, 2048, 2048, 64, torch.bfloat16)
    zamba = fa_case(4, 32, 32, 1024, 1024, 64, torch.bfloat16)
    s1024 = fa_case(1, 14, 2, 1024, 1024, 64, torch.bfloat16)  # engine's
                                                               # longest
    # whisper-large-v3 (phase 10) at each shape its main paths give K2:
    # serving at batch 8 (the encoder over 1500 frames, a ragged key tail;
    # the decoder's causal self-attention over the prompt; cross-attention
    # in prefill and in every decode step, Sq = 1) and training at batch 2
    # (448 tokens); name: (timing tag, causal, (B, Sq, Skv))
    W, P, WT, T = (WHISPER_BATCH, WHISPER_PROMPT, WHISPER_TRAIN_BATCH,
                   WHISPER_TRAIN_SEQ)
    whisper_shapes = {
        "encoder B=8 S=1500": ("whisper_encoder", False, (W, 1500, 1500)),
        f"decoder self prefill B=8 S={P}": ("whisper_decoder_prefill", True,
                                            (W, P, P)),
        f"cross prefill B=8 Sq={P} Skv=1500": ("whisper_cross_prefill",
                                               False, (W, P, 1500)),
        "cross decode B=8 Sq=1 Skv=1500": ("whisper_cross_decode", False,
                                           (W, 1, 1500)),
        "training encoder B=2 S=1500": ("whisper_train_encoder", False,
                                        (WT, 1500, 1500)),
        f"training decoder self B=2 S={T}": ("whisper_train_decoder", True,
                                             (WT, T, T)),
        f"training cross B=2 Sq={T} Skv=1500": ("whisper_train_cross", False,
                                                (WT, T, 1500))}
    whisper = {w: fa_case(B, 20, 20, Sq, Skv, 64, torch.bfloat16)
               for w, (_, _, (B, Sq, Skv)) in whisper_shapes.items()}
    # qwen2-0.5b training's forward (phase 9): batch 8 x 1024, causal
    q_train = fa_case(TRAIN_BATCH, 14, 2, TRAIN_SEQ, TRAIN_SEQ, 64,
                      torch.bfloat16)
    # olmoe-1b-7b (phase 12), 16 heads of 128: the engine's longest
    # prompt (1024, one request a prefill) and the training forward (4 x
    # 1024)
    olmoe = {"olmoe_s1024": fa_case(1, 16, 16, 1024, 1024, 128,
                                    torch.bfloat16),
             "olmoe_train": fa_case(OLMOE_TRAIN_BATCH, 16, 16,
                                    OLMOE_TRAIN_SEQ, OLMOE_TRAIN_SEQ, 128,
                                    torch.bfloat16)}
    cases = [
        *((f"{tag} B={q.shape[0]} H=Hkv=16 S={q.shape[2]} D=128 bf16",
           (q, k, v), True, torch.float32, BF16_TOL)
          for tag, (q, k, v) in olmoe.items()),
        ("olmoe B=1 S=1024 D=128 compute_dtype=bf16", olmoe["olmoe_s1024"],
         True, torch.bfloat16, None),
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
        *(("whisper " + w, whisper[w], c, torch.float32, BF16_TOL)
          for w, (_, c, _) in whisper_shapes.items()),
        *((f"whisper {w} compute_dtype=bf16", whisper[w],
           whisper_shapes[w][1], torch.bfloat16, None)
          for w in ("encoder B=8 S=1500", "cross decode B=8 Sq=1 Skv=1500",
                    f"decoder self prefill B=8 S={P}")),
        ("qwen2 training B=8 S=1024 bf16", q_train, True, torch.float32,
         BF16_TOL),
        ("non-causal Skv=0: no key, zeros",
         fa_case(2, 4, 4, 5, 0, 64, torch.bfloat16), False, torch.float32,
         BF16_TOL),
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
        if k.shape[2] == 0:
            check(not got.any(), f"K2: a row with no key is not 0: {name}")
        errs.append(e)

    def k2_bound(q, k):
        B, H, S, D = q.shape
        flops, nbytes = cost.flash_attention(B, H, k.shape[1], S, S, D, True,
                                             q.element_size())
        print(f"[K2] timed: B={B} H={H} Hkv={k.shape[1]} S={S} D={D} "
              f"{q.dtype} causal, {nbytes} bytes, {flops:.0f} flops")
        return bound(nbytes, flops, q.dtype)

    def fa_ms(q, k, v, cdt=torch.float32):
        return time_ms(lambda: fa.flash_attention(
            q, k, v, causal=True, compute_dtype=cdt), iters=50)

    def sdpa_ms(q, k, v):
        return time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters=50)

    shape_t = {}
    for w, (tag, causal, _) in whisper_shapes.items():
        shape_t.update(k2_shape_times(tag, *whisper[w], causal))
    del whisper
    shape_t.update(k2_shape_times("qwen2_train", *q_train, True))
    shape_t.update(k2_shape_times("qwen2_s1024", *s1024, True))
    shape_t.update(k2_shape_times("zamba2_shape", *zamba, True))
    for tag, qkv in olmoe.items():
        shape_t.update(k2_shape_times(tag, *qkv, True))
    del q_train, olmoe

    q, k, v = main
    b_ms, b_by = k2_bound(q, k)
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
        library_ms_repeat=sdpa_ms(q, k, v), **shape_t)
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

    from repro_torch.kernels import cost
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
    flops, nbytes = cost.mamba2_scan(B, S, H, dh, ds, x.element_size())
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
        flops, nbytes = cost.rwkv6_scan(*r.shape, r.element_size(),
                                        state_in=s_in)
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
# phase 2c: the small-width routes (every reduced config's widths)
# ----------------------------------------------------------------------------

# the reduced configs' shapes the small-width routes run at: qwen2's engine
# (batch 4, 4 heads over 2 KV heads of 16, pages of 16 tokens, 96-token
# slots) and training (batch 4 x 128), rwkv6's (4 heads of 16) and
# zamba2's (16 ssm heads of 8, state 8) training batch of 2 x 70
SMALL_ATTN = dict(B=4, H=4, Hkv=2, D=16)
SMALL_TRAIN_SEQ = 128
SMALL_SCAN = dict(B=2, S=70)


def small_err(got, want, dtype) -> tuple[float, float]:
    """(max |got - want|, that over its bar): the kernels' bars
    (``K2_BWD_BARS``) times max(1, max |want|), for outputs and each
    gradient alike."""
    e = max_err(got, want)
    return e, e / (K2_BWD_BARS[str(dtype)]
                   * max(1.0, float(want.float().abs().max())))


def run_small_width_checks(report: dict) -> None:
    """Each small-width route against its plain version at the reduced
    configs' shapes, fp32 (their dtype) and bf16, its route checked per
    call; timed in fp32, eager (``ms``) and graph-replayed (``ms_graph``),
    beside the bound of its bytes and operations and the plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rw

    rng = np.random.default_rng(21)
    f32, bf = torch.float32, torch.bfloat16
    B, H, Hkv, D = (SMALL_ATTN[k] for k in ("B", "H", "Hkv", "D"))

    def held(tag, what, got, want, dtype, fn, route):
        e, r = small_err(got, want, dtype)
        kernel = getattr(fn, "last_kernel", None) or "paged_small_kernel"
        print(f"[small {tag}] {what} {dtype}: max_abs_err={e:.3e} "
              f"err/bar={r:.3f} route small: {kernel} ({route})")
        check(r <= 1, f"{tag} small-width route disagrees with its plain "
              f"version: {what} {dtype}")
        return e

    def routed(fn, n0):
        check(fn.routes.get("small", 0) == n0 + 1,
              f"{fn.__name__}: the call did not take the small-width route "
              f"({fn.routes})")

    def timed(tag, call, plain, nbytes, flops, dtype, library=None, **kw):
        b_ms, b_by = bound(nbytes, flops, dtype)
        r = dict(route="cuda", ms=time_ms(call), ms_graph=time_graph_ms(call),
                 plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
                 library_ms=time_ms(library) if library else None, **kw)
        r["kernel_ms"] = r["ms"]
        print(f"[small {tag}] timed fp32: ms={r['ms']:.5f} ms_graph="
              f"{r['ms_graph']:.5f} plain_ms={r['plain_ms']:.5f} bound_ms="
              f"{b_ms:.6f} ({b_by}, {nbytes} bytes, {flops:.0f} flops) "
              f"library_ms={r['library_ms']}")
        return r

    # -- K1: the reduced engine's decode step ---------------------------------
    errs = []
    for dtype in (f32, bf):
        lens = rng.integers(5, 96, size=B).astype(np.int32)
        lens[0] = 0                            # a free slot: no key
        case = paged_case(rng, B=B, H=H, Hkv=Hkv, D=D, page=16,
                          seq_lens=lens, dtype=dtype, max_pages=6)
        n0 = pa.paged_attention.routes.get("small", 0)
        got = pa.paged_attention(*case)
        routed(pa.paged_attention, n0)
        errs.append(held("K1", f"B={B} H={H} Hkv={Hkv} D={D} 6-page table",
                         got, ref.paged_attention(*case), dtype,
                         pa.paged_attention, "paged_small_kernel"))
        check(not got[0].any(), "K1 small: a row with no key is not 0")
    q, kp, vp, pt, sl = case = paged_case(
        rng, B=B, H=H, Hkv=Hkv, D=D, page=16,
        seq_lens=rng.integers(5, 96, size=B), dtype=f32, max_pages=6)
    _, nbytes, flops, _ = k1_bound(q, kp, pt, sl)
    report["paged_attention_small"] = dict(
        name="paged_attention_small",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:73",
        max_abs_err=max(errs), **timed(
            "K1", lambda: pa.paged_attention(*case),
            lambda: ref.paged_attention(*case), nbytes, flops, f32))

    # -- K2 and K2-bwd: the reduced qwen2's training shape --------------------
    S = SMALL_TRAIN_SEQ
    errs, errs_b = [], []
    for dtype in (f32, bf):
        g = torch.Generator().manual_seed(22)
        q, k, v, dout = (torch.randn(B, h, S, D, generator=g).to("cuda", dtype)
                         for h in (H, Hkv, Hkv, H))
        lse = torch.empty(B, H, S, device="cuda")
        n0 = fa.flash_attention.routes.get("small", 0)
        out = fa._forward(q, k, v, True, D ** -0.5, f32, lse)
        routed(fa.flash_attention, n0)
        errs.append(held("K2", f"B={B} H={H} Hkv={Hkv} S={S} D={D} causal",
                         out, ref.mha_attention(q, k, v, causal=True),
                         dtype, fa.flash_attention, "FMA kernel, 64 wide"))
        n0 = fa.flash_attention_bwd.routes.get("small", 0)
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse)
        routed(fa.flash_attention_bwd, n0)
        qr, kr, vr = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        ref.mha_attention(qr, kr, vr, causal=True).backward(dout)
        for nm, a, b in zip(("dq", "dk", "dv"), got,
                            (qr.grad, kr.grad, vr.grad)):
            errs_b.append(held("K2-bwd", f"{nm} at the same shape", a, b,
                               dtype, fa.flash_attention_bwd,
                               "FMA pair, 64 wide"))
    g = torch.Generator().manual_seed(23)
    q, k, v, dout = (torch.randn(B, h, S, D, generator=g).to("cuda")
                     for h in (H, Hkv, Hkv, H))
    pairs = attn_pairs(S, S, True)
    kg, vg = (t.repeat_interleave(H // Hkv, 1) for t in (k, v))
    report["flash_attention_small"] = dict(
        name="flash_attention_small",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:85",
        max_abs_err=max(errs), **timed(
            "K2", lambda: fa.flash_attention(q, k, v),
            lambda: ref.mha_attention(q, k, v, causal=True),
            4 * (2 * q.numel() + 2 * k.numel()), 4.0 * B * H * pairs * D,
            f32, library=lambda: F.scaled_dot_product_attention(
                q, kg, vg, is_causal=True)))
    lse = torch.empty(B, H, S, device="cuda")
    out = fa._forward(q, k, v, True, D ** -0.5, f32, lse)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, kg, vg))
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    _, _, nbytes, flops = k2_bwd_bound(q, k, True)
    report["flash_attention_bwd_small"] = dict(
        name="flash_attention_bwd_small",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:85",
        max_abs_err=max(errs_b), **timed(
            "K2-bwd", lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse),
            lambda: plain_attention_grads(q, k, v, dout, True, f32),
            nbytes, flops, f32, library=lambda: torch.autograd.grad(
                o_lib, (qs, ks, vs), dout, retain_graph=True)))

    # -- K3 and K3-bwd: the reduced zamba2's mixer ----------------------------
    Bs, Ss = SMALL_SCAN["B"], SMALL_SCAN["S"]
    from repro_torch import configs
    zc = configs.get_reduced("zamba2-1.2b")
    dh, ds = zc.ssm.head_dim, zc.ssm.d_state
    Hs = zc.ssm.expand * zc.d_model // dh
    errs, errs_b = [], []
    cases = {}
    for dtype in (f32, bf):
        g = torch.Generator().manual_seed(24)
        proj = torch.randn(Bs, Ss, Hs * dh + 2 * ds, generator=g).to(
            "cuda", dtype)
        x = proj[..., :Hs * dh].view(Bs, Ss, Hs, dh)
        Bm, Cm = proj[..., Hs * dh:Hs * dh + ds], proj[..., Hs * dh + ds:]
        dt = (torch.rand(Bs, Ss, Hs, generator=g) * 0.1 + 0.01).cuda()
        A = (-torch.rand(Hs, generator=g) * 2 - 0.1).cuda()
        Dv = torch.randn(Hs, generator=g).cuda()
        dy = torch.randn(Bs, Ss, Hs, dh, generator=g).to("cuda", dtype)
        cases[dtype] = (x, dt, A, Bm, Cm, Dv, dy)
        n0 = m2.mamba2_scan.routes.get("small", 0)
        y, h = m2.mamba2_scan(x, dt, A, Bm, Cm, Dv, return_state=True)
        routed(m2.mamba2_scan, n0)
        check(m2.mamba2_scan.last_kernel == "mamba2_scan_small_kernel",
              f"K3 small: took {m2.mamba2_scan.last_kernel}")
        y_w, h_w = ref.mamba2_scan_chunked(x, dt, A, Bm, Cm, Dv,
                                           return_state=True)
        errs.append(held("K3", f"B={Bs} S={Ss} H={Hs} dh={dh} ds={ds} "
                         "(the mixer's strided views)", y, y_w, dtype,
                         m2.mamba2_scan, "sequential, state in smem"))
        held("K3", "final state", h, h_w, dtype, m2.mamba2_scan,
             "sequential")
        n0 = m2.mamba2_scan_bwd.routes.get("small", 0)
        got = m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, Dv, dy)
        routed(m2.mamba2_scan_bwd, n0)
        want = ref.mamba2_scan_bwd(x, dt, A, Bm, Cm, Dv, dy)
        for nm, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got,
                            want):
            errs_b.append(held("K3-bwd", nm, a, b, dtype,
                               m2.mamba2_scan_bwd, "sequential, padded 64"))
    x, dt, A, Bm, Cm, Dv, dy = cases[f32]
    io = 4 * (2 * x.numel() + Bm.numel() + Cm.numel() + dt.numel())
    flops = 4.0 * Bs * Ss * Hs * ds * dh
    # the backward: x, dy in and dx out (scan_bwd_bound's vectors); B, C
    # in and dB, dC out; dt in and ddt out; A, D in and dA, dD out
    extra = 4 * (4 * Bm.numel() + 2 * dt.numel() + 4 * Hs)
    report["mamba2_scan_small"] = dict(
        name="mamba2_scan_small",
        source="src/repro_torch/kernels/csrc/mamba2_scan.cu",
        replaces="src/repro/kernels/mamba2_scan.py:69",
        max_abs_err=max(errs), **timed(
            "K3", lambda: m2.mamba2_scan(x, dt, A, Bm, Cm, Dv),
            lambda: ref.mamba2_scan_chunked(x, dt, A, Bm, Cm, Dv), io, flops,
            f32))
    report["mamba2_scan_bwd_small"] = dict(
        name="mamba2_scan_bwd_small",
        source="src/repro_torch/kernels/csrc/mamba2_scan_bwd.cu",
        replaces="src/repro/kernels/mamba2_scan.py:69",
        max_abs_err=max(errs_b), **timed(
            "K3-bwd", lambda: m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, Dv, dy),
            lambda: ref.mamba2_scan_bwd(x, dt, A, Bm, Cm, Dv, dy),
            *scan_bwd_bound(x, 2, 1, extra, f32)[2:], f32))

    # -- K4 and K4-bwd: the reduced rwkv6 (prefill, the S = 1 decode) --------
    rc = configs.get_reduced("rwkv6-1.6b")
    Hr, dr = rc.d_model // rc.resolved_head_dim, rc.resolved_head_dim
    errs, errs_b = [], []
    for dtype in (f32, bf):
        for S_ in (Ss, 1):
            g = torch.Generator().manual_seed(25 + S_)
            r, k, v, dy = (torch.randn(Bs, S_, Hr, dr, generator=g).to(
                "cuda", dtype) for _ in range(4))
            w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(
                Bs, S_, Hr, dr, generator=g))).to("cuda", dtype)
            u = (torch.randn(Hr, dr, generator=g) * 0.1).cuda()
            s0 = torch.randn(Bs, Hr, dr, dr, generator=g).cuda()
            n0 = rw.rwkv6_scan.routes.get("small", 0)
            y, s = rw.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
            routed(rw.rwkv6_scan, n0)
            check(rw.rwkv6_scan.last_kernel == "rwkv6_scan_small_kernel",
                  f"K4 small: took {rw.rwkv6_scan.last_kernel}")
            y_w, s_w = ref.rwkv6_scan_chunked(r, k, v, w, u, s0=s0,
                                              return_state=True)
            errs.append(held("K4", f"B={Bs} S={S_} H={Hr} dh={dr}", y, y_w,
                             dtype, rw.rwkv6_scan, "sequential"))
            held("K4", f"final state S={S_}", s, s_w, dtype, rw.rwkv6_scan,
                 "sequential")
            n0 = rw.rwkv6_scan_bwd.routes.get("small", 0)
            got = rw.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0)
            routed(rw.rwkv6_scan_bwd, n0)
            want = ref.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0)
            for nm, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                                want):
                errs_b.append(held("K4-bwd", f"{nm} S={S_}", a, b, dtype,
                                   rw.rwkv6_scan_bwd,
                                   "sequential, padded 64"))
    g = torch.Generator().manual_seed(26)
    r, k, v, dy = (torch.randn(Bs, Ss, Hr, dr, generator=g).cuda()
                   for _ in range(4))
    w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(
        Bs, Ss, Hr, dr, generator=g))).cuda()
    u = (torch.randn(Hr, dr, generator=g) * 0.1).cuda()
    r1, k1, v1, w1 = (t[:, :1].contiguous() for t in (r, k, v, w))
    s0 = torch.randn(Bs, Hr, dr, dr, generator=g).cuda()
    io = 4 * 5 * r.numel()
    flops = 4.0 * Bs * Ss * Hr * dr * dr
    b1 = bound(4 * (5 * r1.numel() + 2 * s0.numel()),
               4.0 * Bs * Hr * dr * dr, f32)
    decode = lambda: rw.rwkv6_scan(r1, k1, v1, w1, u, s0=s0,  # noqa: E731
                                   return_state=True)
    report["rwkv6_scan_small"] = dict(
        name="rwkv6_scan_small",
        source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:59",
        max_abs_err=max(errs),
        ms_decode=time_ms(decode), ms_graph_decode=time_graph_ms(decode),
        bound_ms_decode=b1[0], **timed(
            "K4", lambda: rw.rwkv6_scan(r, k, v, w, u),
            lambda: ref.rwkv6_scan_chunked(r, k, v, w, u), io, flops, f32))
    report["rwkv6_scan_bwd_small"] = dict(
        name="rwkv6_scan_bwd_small",
        source="src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:59",
        max_abs_err=max(errs_b), **timed(
            "K4-bwd", lambda: rw.rwkv6_scan_bwd(r, k, v, w, u, dy),
            lambda: ref.rwkv6_scan_bwd(r, k, v, w, u, dy),
            # r, k, v, w, dy in and dr, dk, dv, dw out; u in and du out
            *scan_bwd_bound(r, 5, 4, 2 * u.numel() * 4, f32)[2:], f32))
    r4 = report["rwkv6_scan_small"]
    print(f"[small K4] timed decode S=1 fp32: ms={r4['ms_decode']:.5f} "
          f"ms_graph={r4['ms_graph_decode']:.5f} bound_ms={b1[0]:.6f} "
          f"({b1[1]})")


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
    from repro_torch.kernels import adamw as ka
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rwkv6_scan as rw
    return {"paged_attention": pa.paged_attention,
            "flash_attention": fa.flash_attention,
            "flash_attention_lse": fa.flash_attention_lse,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "mamba2_scan": m2.mamba2_scan,
            "mamba2_scan_bwd": m2.mamba2_scan_bwd,
            "rwkv6_scan": rw.rwkv6_scan,
            "rwkv6_scan_split": rw.rwkv6_scan_split,
            "rwkv6_scan_bwd": rw.rwkv6_scan_bwd,
            "fused_adamw": ka.fused_adamw}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        fn.routes.clear()


def read_counts() -> dict:
    """Each wrapper's launches through its fast routes under its name, and
    through its small-width route under ``<name>_small``."""
    out = {}
    for name, fn in kernel_wrappers().items():
        small = fn.routes.get("small", 0)
        out[name] = fn.launches - small
        out[f"{name}_small"] = small
    return out


def read_routes() -> dict:
    """Each wrapper's launches by route (``fn.routes``), for the wrappers
    that launched."""
    return {name: dict(fn.routes) for name, fn in kernel_wrappers().items()
            if fn.routes}


def small_widths(cfg) -> set:
    """The wrappers whose small-width route ``cfg``'s widths take (heads
    other than 64 or 128 wide; scans other than 64 wide)."""
    out = set()
    if cfg.n_heads and cfg.resolved_head_dim not in (64, 128):
        out |= {"paged_attention", "flash_attention", "flash_attention_lse",
                "flash_attention_bwd"}
    if cfg.family == "rwkv6" and cfg.resolved_head_dim != 64:
        out |= {"rwkv6_scan", "rwkv6_scan_bwd"}
    if cfg.ssm is not None and (cfg.ssm.head_dim, cfg.ssm.d_state) \
            != (64, 64):
        out |= {"mamba2_scan", "mamba2_scan_bwd"}
    return out


def by_route(want: dict, cfg) -> dict:
    """Launches by wrapper as ``read_counts`` gives them for ``cfg``: a
    wrapper its widths send to the small-width route counts there."""
    small = small_widths(cfg)
    out = {}
    for name, n in want.items():
        out[name] = 0 if name in small else n
        out[f"{name}_small"] = n if name in small else 0
    return out


def through_plain(fn, *, oracle: bool = False, attention=None):
    """Run fn() with every kernel of ``ops`` swapped for its plain version
    (the CPU path's functions, here on the card's tensors); ``oracle``
    takes the scans' sequential oracles instead of their chunked forms,
    ``attention`` another plain version of K2's function."""
    from repro_torch.kernels import ops, ref
    plain = {"paged_attention": ref.paged_attention,
             "flash_attention": attention or ref.mha_attention,
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


def run_engine(cfg, params, *, chunked: bool, launches: dict,
               label: str = "engine") -> tuple[dict, dict]:
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
    routes = read_routes()
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
           "k1_launches": k1, "k2_launches": k2, "routes": routes,
           "stats": st}
    print(f"[{label} {mode}] {json.dumps(out)}")
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
    (torch.profiler, over the same number of calls), the device's busy
    share of the unprofiled wall time, and the host operators that take
    the most of the host's own time (under the profiler).  fn() must leave
    the state it reads as it found it (or rewrite the same rows), so the
    calls do not drift."""
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
    by_name: dict = {}
    for k, ms in rows:        # "(anonymous namespace)::name<...>(...)"
        short = k.split("::")[-1].split("<")[0].split("(")[0]
        if any(n in short for names in OUR_KERNELS.values() for n in names):
            by_name[short] = by_name.get(short, 0.0) + ms
    # host-side operators by their own time (a call's host cost where the
    # device waits), with their calls a step
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps,
                    e.count / steps) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: -r[1])
    return {"step_wall_ms": wall_ms,
            "step_wall_ms_under_profiler": prof_wall_ms,
            "host_ops_per_step": sum(n for _, _, n in host),
            "top_host_ms": [[k, ms, n] for k, ms, n in host[:8]],
            "device_ms": dev_ms if rows else "not measured",
            "device_busy_share": dev_ms / wall_ms if rows else "not measured",
            "our_kernels_device_ms": ours,
            "our_kernels_by_name": by_name,
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


def compare_with_cpu(name: str = "qwen2-0.5b") -> dict:
    """The reduced fp32 ``name`` of the CPU tests (head_dim 16: the
    kernels' small-width routes) served on the card and, from the same
    weights, on the CPU: same greedy tokens.  Returns the launches of the
    card's whole-prefill run: K1 and K2 on their small-width routes
    alone."""
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine, PagedLM
    cfg = configs.get_reduced(name)
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
            reset_counts()
            eng.run_to_completion()
            if dev == "cuda" and not chunked:
                counts = read_counts()
            outs[dev, chunked] = {r.rid: r.out_tokens for r in eng.finished}
    for chunked in (False, True):
        check(outs["cuda", chunked] == outs["cpu", chunked],
              f"reduced fp32 model: card and CPU tokens differ "
              f"(chunked={chunked})")
    launched = {k: v for k, v in counts.items() if v}
    check(set(launched) == {"paged_attention_small", "flash_attention_small"},
          f"reduced {name} (head_dim {cfg.resolved_head_dim}): launches "
          f"{launched}, expected K1's and K2's small-width routes alone")
    print(f"[compare] reduced fp32 {name} (head_dim "
          f"{cfg.resolved_head_dim}): card tokens == CPU tokens, whole and "
          f"chunked prefill; launches on the card (whole prefill) "
          f"{launched}")
    return counts


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

def expected_launches(cfg, decode_steps: int = DECODE_STEPS) -> dict:
    """The launches one prefill and ``decode_steps`` greedy decode steps
    must show, per kernel."""
    want = dict.fromkeys(kernel_wrappers(), 0)
    if cfg.family == "rwkv6":      # K4: every layer, prefill and decode
        want["rwkv6_scan"] = cfg.n_layers * (1 + decode_steps)
    if cfg.family == "zamba2":     # K3 every backbone layer, K2 every
        want["mamba2_scan"] = cfg.n_layers  # shared block, prefill only
        want["flash_attention"] = cfg.n_layers // cfg.attn_every
    if cfg.family == "mamba2":     # K3 every layer, prefill only
        want["mamba2_scan"] = cfg.n_layers
    if cfg.family == "encdec":     # K2: every encoder layer and every
        # decoder layer's self- and cross-attention in prefill; a decode
        # step's cross-attention (its self-attention is inline PyTorch)
        want["flash_attention"] = (cfg.n_enc_layers + 2 * cfg.n_layers
                                   + decode_steps * cfg.n_layers)
    return by_route(want, cfg)


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


def compare_recurrent_with_cpu() -> dict:
    """The reduced fp32 rwkv6, zamba2 and mamba2 of the CPU tests (head_dim
    16; ssm head_dim 8, d_state 8: the small-width routes), served on the
    card and, from the same weights, on the CPU: same greedy tokens, the
    launches exact.  Returns the card runs' launches, summed."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    cases = [("rwkv6-1.6b", None), ("zamba2-1.2b", None),
             ("zamba2-1.2b", "mamba2")]
    S, steps = 70, 8                       # 70: one chunk of 64 and a tail
    total: dict = {}
    for name, family in cases:
        cfg = configs.get_config(name)
        if family:
            cfg = dataclasses.replace(cfg, family=family)
        cfg = cfg.reduced()
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
                counts = read_counts()
        check(torch.equal(outs["cuda"], outs["cpu"]),
              f"reduced fp32 {cfg.family}: card and CPU tokens differ")
        want = expected_launches(cfg, decode_steps=steps)
        check(counts == want, f"reduced {cfg.family}: launches {counts}, "
              f"expected {want}")
        launched = {k: v for k, v in counts.items() if v}
        check(launched and all(k.endswith("_small") for k in launched),
              f"reduced {cfg.family}: a fast route ran ({launched})")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        print(f"[compare] reduced fp32 {cfg.family}: card tokens == CPU "
              f"tokens over {steps} decode steps; kernels launched on the "
              f"card: {launched}")
    return total


# ----------------------------------------------------------------------------
# phase 9: training (the fault-tolerant trainer, one rank, on the card)
# ----------------------------------------------------------------------------

# K2-bwd vs autograd through ref.mha_attention: max |got - want| <= bar *
# max |want| for each of dq, dk, dv (the ROADMAP's kernel bars)
K2_BWD_BARS = {"torch.float32": 3e-4, "torch.bfloat16": 6e-2}
# qwen2-0.5b training: bf16 (the config's dtype), seed-0 weights, batch 8 x
# 1024 tokens, remat, AdamW lr 3e-4 without warmup; every layer runs K2
# twice a step (the forward, and its recompute under remat) and K2-bwd once
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 10
# checkpoint-restart: depth cut to 4 layers, so a checkpoint (bf16 weights,
# fp32 moments) is ~1.6 GB instead of ~5 GB at 24
RESTART_LAYERS = 4
# GSPMD training on a 1 x 1 mesh (phase 9e): 3 steps of the same batch,
# beside single's; there, and in phase 12b, the clip norm is out of reach
# (scale 1), so single's kernel pair and GSPMD's eager update agree bit for
# bit (with clipping active the pair's norm, summed in another order, may
# differ in its last bits)
GSPMD_STEPS = 3
NO_CLIP = 1e9
# whisper-large-v3 training's attention shapes ((B, H, Hkv, Sq, Skv, D),
# causal), one for each third of its K2-bwd launches: the encoder over 1500
# frames, the 448-token decoder's causal self-attention, and its
# cross-attention against the frames
WHISPER_BWD_SHAPES = {
    "encoder B=2 S=1500": ((2, 20, 20, 1500, 1500, 64), False),
    "decoder self B=2 S=448": ((2, 20, 20, 448, 448, 64), True),
    "cross B=2 Sq=448 Skv=1500": ((2, 20, 20, 448, 1500, 64), False)}


def k2_bwd_case(B, H, Hkv, Sq, Skv, D, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda h, s: torch.randn(B, h, s, D, device="cuda",  # noqa: E731
                                  generator=g).to(dtype)
    return mk(H, Sq), mk(Hkv, Skv), mk(Hkv, Skv), mk(H, Sq)


def k2_bwd_bound(q, k, causal: bool):
    """K2-bwd's work (``kernels/cost.py``) at the bf16 dense peak: (bound
    ms, bound by, bytes, flops)."""
    import torch

    from repro_torch.kernels import cost
    B, H, Sq, D = q.shape
    flops, nbytes = cost.flash_attention_bwd(B, H, k.shape[1], Sq,
                                             k.shape[2], D, causal,
                                             q.element_size())
    return (*bound(nbytes, flops, torch.bfloat16), nbytes, flops)


def plain_attention_grads(q, k, v, dout, causal, cdt):
    """The plain version: autograd through ref.mha_attention."""
    from repro_torch.kernels import ref
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    ref.mha_attention(q, k, v, causal=causal,
                      compute_dtype=cdt).backward(dout)
    return q.grad, k.grad, v.grad


def run_k2_bwd_checks(report: dict) -> dict:
    """Phase 9a: K2-bwd vs the plain gradients at the training and prefill
    shapes and their edges; timed at the training step's shape."""
    import statistics

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # name, (B, H, Hkv, Sq, Skv, D), dtype, compute, causal
        ("qwen2 training B=8 S=1024 bf16", (8, 14, 2, 1024, 1024, 64), bf,
         f32, True),
        ("qwen2 training B=8 S=1024 bf16 compute_dtype=bf16",
         (8, 14, 2, 1024, 1024, 64), bf, bf, True),
        ("qwen2 prefill shape B=1 S=2048 bf16", (1, 14, 2, 2048, 2048, 64),
         bf, f32, True),
        ("qwen2 prefill shape B=1 S=2048 bf16 compute_dtype=bf16",
         (1, 14, 2, 2048, 2048, 64), bf, bf, True),
        ("ragged S=1000 bf16", (1, 14, 2, 1000, 1000, 64), bf, f32, True),
        ("ragged S=1000 fp32", (1, 14, 2, 1000, 1000, 64), f32, f32, True),
        ("fp32 B=8 S=1024", (8, 14, 2, 1024, 1024, 64), f32, f32, True),
        ("D=128 non-causal bf16 Sq=512 Skv=700", (1, 8, 2, 512, 700, 128),
         bf, f32, False),
        ("D=128 non-causal fp32 Sq=77 Skv=200", (1, 8, 1, 77, 200, 128), f32,
         f32, False),
        ("causal Sq=300 > Skv=100 bf16: empty rows",
         (1, 4, 4, 300, 100, 64), bf, f32, True),
        # zamba2-1.2b training (phase 11): the shared block, B=4, MHA
        ("zamba2 training B=4 H=32 S=1024 bf16",
         (REC_TRAIN_BATCH, 32, 32, REC_TRAIN_SEQ, REC_TRAIN_SEQ, 64), bf, f32,
         True),
        # olmoe-1b-7b training (phase 12b): D = 128, on its wgmma pair; the
        # other D = 128 layouts: starcoder2-3b's GQA 12:1 (24 / 2) and
        # deepseek-7b's MHA (32 / 32), at one sequence of 1024
        ("olmoe training B=4 H=16 S=1024 D=128 bf16", OLMOE_BWD_SHAPE, bf,
         f32, True),
        ("olmoe training B=4 H=16 S=1024 D=128 bf16 compute_dtype=bf16",
         OLMOE_BWD_SHAPE, bf, bf, True),
        *((f"{m} H={h} Hkv={hkv} S=1024 D=128 bf16{c}",
           (1, h, hkv, 1024, 1024, 128), bf, cdt, True)
          for m, h, hkv in (("starcoder2", 24, 2), ("deepseek", 32, 32))
          for c, cdt in (("", f32), (" compute_dtype=bf16", bf))),
        # whisper-large-v3 training (phase 10), on the wgmma pair
        *((f"whisper {w} bf16{c}", shape, bf, cdt, causal)
          for w, (shape, causal) in WHISPER_BWD_SHAPES.items()
          for c, cdt in (("", f32), (" compute_dtype=bf16", bf))),
    ]
    errs = []
    for i, (name, shape, dtype, cdt, causal) in enumerate(cases):
        q, k, v, dout = k2_bwd_case(*shape, dtype, seed=90 + i)
        lse = torch.empty(q.shape[:3], dtype=f32, device="cuda")
        out = fa._forward(q, k, v, causal, shape[-1] ** -0.5, cdt, lse)
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                     compute_dtype=cdt)
        # bf16 with D = 64 or 128 takes that width's wgmma pair, fp32 the
        # FMA pair
        route = fa.BWD_KERNELS[fa.BWD_WGMMA.get(shape[-1], 0)
                               if dtype == bf else 0]
        check(fa.flash_attention_bwd.last_kernel == route,
              f"K2-bwd {name}: launched {fa.flash_attention_bwd.last_kernel}"
              f", expected {route}")
        want = plain_attention_grads(q, k, v, dout, causal, cdt)
        torch.cuda.synchronize()
        bar = max(K2_BWD_BARS[str(dtype)], K2_BWD_BARS[str(cdt)])
        ratios, e_max = [], 0.0
        for gname, g, w in zip(("dq", "dk", "dv"), got, want):
            e = max_err(g, w)
            m = float(w.float().abs().max())
            ratios.append(e / (bar * m))
            e_max = max(e_max, e)
            check(bool(torch.isfinite(g).all()),
                  f"K2-bwd: non-finite {gname}: {name}")
        print(f"[K2-bwd] {name}: max_abs_err={e_max:.3e} err/bar (dq, dk, "
              f"dv) = {', '.join(f'{r:.3f}' for r in ratios)} (bar {bar:g} "
              f"max|want|); {' + '.join(route)}")
        check(max(ratios) <= 1, f"K2-bwd disagrees with the plain "
              f"gradients: {name}")
        if causal and shape[3] > shape[4]:
            check(not got[0][:, :, :shape[3] - shape[4]].any(),
                  f"K2-bwd: a row with no key has a gradient: {name}")
        errs.append(e_max)
        del q, k, v, dout, out, got, want

    # timed at the training step's shape (and prefill's, for reference)
    def timings(shape, dtype, cdt, causal=True, seed=0):
        q, k, v, dout = k2_bwd_case(*shape, dtype, seed=seed)
        lse = torch.empty(q.shape[:3], dtype=f32, device="cuda")
        out = fa._forward(q, k, v, causal, shape[-1] ** -0.5, cdt, lse)
        bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, out, dout, lse, causal=causal, compute_dtype=cdt)
        ms = time_ms(bwd, iters=10)
        ms_graph = time_graph_ms(bwd, iters=5, reps=3)
        # the plain version and the library: forward + backward, less the
        # forward alone, on the same inputs; the library's pair is taken
        # three times in turns and the medians kept (single differences
        # spread by 2-3x between calls)
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))

        def plain_fb():
            torch.autograd.grad(ref.mha_attention(
                qg, kg, vg, causal=causal, compute_dtype=cdt),
                (qg, kg, vg), dout)

        def plain_f():
            with torch.no_grad():
                ref.mha_attention(q, k, v, causal=causal, compute_dtype=cdt)

        def sdpa_fb():
            torch.autograd.grad(F.scaled_dot_product_attention(
                qg, kg, vg, is_causal=causal, enable_gqa=True),
                (qg, kg, vg), dout)

        def sdpa_f():
            with torch.no_grad():
                F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                               enable_gqa=True)

        plain = time_ms(plain_fb, iters=3, warmup=1) \
            - time_ms(plain_f, iters=3, warmup=1)
        fb, f = [], []
        for _ in range(3):
            fb.append(time_ms(sdpa_fb, iters=20, warmup=3))
            f.append(time_ms(sdpa_f, iters=20, warmup=3))
        lib = statistics.median(fb) - statistics.median(f)
        # the same difference in device time alone, from CUDA-graph
        # replays: the yardstick that the host does not move (profiler
        # rows undercount here once a process has run many profiles)
        lib_dev = time_graph_ms(sdpa_fb, iters=5, reps=3) \
            - time_graph_ms(sdpa_f, iters=5, reps=3)
        b_ms, b_by, nbytes, flops = k2_bwd_bound(q, k, causal)
        return {"ms": ms, "ms_graph": ms_graph, "plain_ms": plain,
                "library_ms": lib, "library_ms_graph": lib_dev,
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "flops": flops}

    whisper_t = {}
    for w, (shape, causal) in WHISPER_BWD_SHAPES.items():
        tag = "whisper_" + w.split()[0]
        t = timings(shape, bf, f32, causal=causal, seed=3)
        whisper_t.update({f"{k}_{tag}": t[k] for k in
                          ("ms", "ms_graph", "plain_ms", "library_ms",
                           "library_ms_graph", "bound_ms", "bound_by")})
        print(f"[K2-bwd] timed at whisper's {w} (B, H, Hkv, Sq, Skv, D) = "
              f"{shape} bf16 {'causal' if causal else 'non-causal'}, "
              f"{' + '.join(fa.BWD_KERNELS[1])}: "
              f"ms={t['ms']:.4f} ms_graph={t['ms_graph']:.4f}; plain "
              f"{t['plain_ms']:.3f}; SDPA fwd+bwd - fwd {t['library_ms']:.4f}"
              f" eager, {t['library_ms_graph']:.4f} graph-replayed; bound "
              f"{t['bound_ms']:.5f} ({t['bound_by']}, {t['flops']:.4g} "
              f"flops), {t['bound_ms'] / t['ms_graph']:.3f} of the bound")
    zamba_t = timings((REC_TRAIN_BATCH, 32, 32, REC_TRAIN_SEQ, REC_TRAIN_SEQ,
                       64), bf, f32, seed=4)
    print(f"[K2-bwd] timed at zamba2's training shape B={REC_TRAIN_BATCH} "
          f"H=Hkv=32 S={REC_TRAIN_SEQ} D=64 bf16 causal: ms="
          f"{zamba_t['ms']:.4f} ms_graph={zamba_t['ms_graph']:.4f}; plain "
          f"{zamba_t['plain_ms']:.3f}; SDPA fwd+bwd - fwd "
          f"{zamba_t['library_ms']:.4f} eager, "
          f"{zamba_t['library_ms_graph']:.4f} graph-replayed; bound "
          f"{zamba_t['bound_ms']:.5f} ({zamba_t['bound_by']})")
    olmoe_t = timings(OLMOE_BWD_SHAPE, bf, f32, seed=5)
    print(f"[K2-bwd] timed at olmoe's training shape (B, H, Hkv, Sq, Skv, D)"
          f" = {OLMOE_BWD_SHAPE} bf16 causal, "
          f"{' + '.join(fa.BWD_KERNELS[3])}: ms={olmoe_t['ms']:.4f} "
          f"ms_graph={olmoe_t['ms_graph']:.4f}; plain "
          f"{olmoe_t['plain_ms']:.3f}; SDPA fwd+bwd - fwd "
          f"{olmoe_t['library_ms']:.4f} eager, "
          f"{olmoe_t['library_ms_graph']:.4f} graph-replayed; bound "
          f"{olmoe_t['bound_ms']:.5f} ({olmoe_t['bound_by']}, "
          f"{olmoe_t['flops']:.4g} flops), "
          f"{olmoe_t['bound_ms'] / olmoe_t['ms_graph']:.3f} of the bound")
    train_t = timings((TRAIN_BATCH, 14, 2, TRAIN_SEQ, TRAIN_SEQ, 64), bf,
                      f32)
    pre_t = timings((1, 14, 2, 2048, 2048, 64), bf, f32, seed=1)
    cb_t = timings((TRAIN_BATCH, 14, 2, TRAIN_SEQ, TRAIN_SEQ, 64), bf, bf,
                   seed=2)
    r = dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:85",
             device_kernels=fa.BWD_KERNELS[1],
             device_kernels_olmoe=fa.BWD_KERNELS[3], max_abs_err=max(errs),
             **train_t, ms_compute_bf16=cb_t["ms"],
             ms_graph_compute_bf16=cb_t["ms_graph"],
             library_ms_graph_compute_bf16=cb_t["library_ms_graph"],
             **{f"{k}_prefill_shape": v for k, v in pre_t.items()
                if k != "bound_by"}, **whisper_t,
             **{f"{k}_zamba2": zamba_t[k] for k in
                ("ms", "ms_graph", "plain_ms", "library_ms",
                 "library_ms_graph", "bound_ms", "bound_by")},
             **{f"{k}_olmoe": olmoe_t[k] for k in
                ("ms", "ms_graph", "plain_ms", "library_ms",
                 "library_ms_graph", "bound_ms", "bound_by")})
    r["kernel_ms"] = r["ms"]
    print(f"[K2-bwd] timed at the training shape B={TRAIN_BATCH} H=14 Hkv=2 "
          f"S={TRAIN_SEQ} D=64 bf16 causal: ms={r['ms']:.4f} ms_graph="
          f"{r['ms_graph']:.4f} (compute_dtype=bf16 {r['ms_compute_bf16']:.4f}"
          f" / {r['ms_graph_compute_bf16']:.4f}); plain {r['plain_ms']:.3f}; "
          f"SDPA fwd+bwd - fwd {r['library_ms']:.4f} eager, "
          f"{r['library_ms_graph']:.4f} graph-replayed; bound "
          f"{r['bound_ms']:.5f} "
          f"({r['bound_by']}, {train_t['flops']:.4g} flops, "
          f"{train_t['bytes']} bytes), {r['bound_ms'] / r['ms_graph']:.3f} "
          f"of the bound; prefill shape B=1 S=2048: ms={pre_t['ms']:.4f} "
          f"ms_graph={pre_t['ms_graph']:.4f} SDPA {pre_t['library_ms']:.4f} "
          f"eager, {pre_t['library_ms_graph']:.4f} graph-replayed; bound "
          f"{pre_t['bound_ms']:.5f}")
    report["flash_attention_bwd"] = r
    return r


def train_phases(report: dict) -> dict:
    """Phase 9 (a)-(e); returns the launches of its main paths: the
    training run (b), the reduced qwen2 on the card (d), the GSPMD run
    (e)."""
    run_k2_bwd_checks(report)
    paths = {"qwen2_train": train_phase()}
    restart_phase()
    paths["reduced_qwen2_train"] = train_with_cpu()
    paths["qwen2_train_gspmd"] = phase("9e train gspmd", train_gspmd_phase)
    return paths


def free_port() -> int:
    """A free TCP port on this machine, for a one-rank process group."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_gspmd_phase() -> dict:
    """Phase 9e: qwen2-0.5b at full width trained through
    ``Trainer(comm="gspmd")`` on a 1 x 1 ("data", "model") mesh over NCCL
    (world size 1), and through ``comm="single"`` from the same weights, in
    this one call, clipping inactive (``NO_CLIP``): the same losses
    bitwise, K2 48 and K2-bwd 24 launches a step, and AdamW's kernel pair
    once a step in the single run, none in GSPMD's (its update is the eager
    one on the mesh's slices), and nothing else; each path's step ms and
    the device's busy share.  Returns the GSPMD run's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.trainer import Trainer

    cfg = configs.get_config("qwen2-0.5b")
    L = cfg.n_layers
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        runs, counts = {}, {}
        for comm in ("single", "gspmd"):   # both from the seed-0 weights
            torch.cuda.empty_cache()
            tr = Trainer(cfg, train_config(cfg, f"gspmd_{comm}", comm=comm,
                                           clip_norm=NO_CLIP),
                         mesh=mesh if comm == "gspmd" else None)
            reset_counts()
            ms = tr.train(GSPMD_STEPS)
            torch.cuda.synchronize()
            counts[comm] = read_counts()
            prof = device_profile(tr.train_step, 2)
            runs[comm] = {
                "losses": [m["loss"] for m in ms],
                "median_step_ms": float(np.median(
                    [m["step_time_s"] for m in ms])) * 1e3,
                "device_busy_share": prof["device_busy_share"],
                "device_ms": prof["device_ms"],
                "step_wall_ms": prof["step_wall_ms"]}
            del tr
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    a, b = runs["single"]["losses"], runs["gspmd"]["losses"]
    rel = float(np.max(np.abs(np.subtract(b, a)) / np.abs(a)))
    want = dict.fromkeys(counts["gspmd"], 0)
    want["flash_attention"] = 2 * L * GSPMD_STEPS
    want["flash_attention_bwd"] = L * GSPMD_STEPS
    wants = {"gspmd": want, "single": {**want, "fused_adamw": GSPMD_STEPS}}
    out = {"mesh": [1, 1], "backend": "nccl", "steps": GSPMD_STEPS,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "single": runs["single"],
           "gspmd": runs["gspmd"], "bitwise": a == b,
           "largest_relative_loss_gap": rel,
           "launches": {c: {k: v for k, v in n.items() if v}
                        for c, n in counts.items()},
           "card": gpu_name_power()}
    print(f"[train gspmd] {json.dumps(out)}")
    check(all(np.isfinite(b)), f"train gspmd: a loss is not finite: {b}")
    for comm, w in wants.items():
        check(counts[comm] == w, f"train gspmd ({comm}): launches "
              f"{counts[comm]}, expected {w} (K2 twice a layer a step under "
              "remat, K2-bwd once; AdamW's pair once a single step)")
    # one rank: every collective is the identity and every spec shards
    # nothing, so the step is single's; with clipping inactive the kernel
    # pair's update is the eager one's, bit for bit
    check(a == b, f"train gspmd: losses {b} differ from single's {a}")
    return counts["gspmd"]


def train_config(cfg, ckpt: str, clip_norm: float = 1.0, **kw):
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import TrainerConfig
    return TrainerConfig(**{
        "ckpt_dir": str(ROOT / "build" / "chip_smoke_ckpt" / ckpt),
        "ckpt_every": 0, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
        "remat": True, "comm": "single",
        "opt": AdamWConfig(lr=3e-4, warmup_steps=0, clip_norm=clip_norm),
        **kw})


def train_phase() -> dict:
    """Phase 9b: qwen2-0.5b at full width trained on the card through
    ``Trainer(comm="single")``; returns the kernels' launches of that run."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.runtime.trainer import Trainer

    cfg = configs.get_config("qwen2-0.5b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, train_config(cfg, "main"))
    torch.cuda.synchronize()
    print(f"[train] qwen2-0.5b: {tr.n_params} parameters, {cfg.dtype}, init "
          f"{time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, remat, AdamW lr 3e-4")
    reset_counts()                     # the main path's run starts here
    ms = tr.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()             # ... and ends here
    losses = [m["loss"] for m in ms]
    L = cfg.n_layers
    check(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = 2 * L * TRAIN_STEPS
    want["flash_attention_bwd"] = L * TRAIN_STEPS
    want["fused_adamw"] = TRAIN_STEPS
    check(counts == want, f"train: launches {counts}, expected {want} (K2 "
          "twice a layer a step under remat, K2-bwd once, AdamW's pair once; "
          "K1/K3/K4 never)")
    step_s = float(np.median([m["step_time_s"] for m in ms]))
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(tr.train_step, 2)
    out = {"losses": losses,
           "grad_norms": [m["grad_norm"] for m in ms],
           "lrs": [m["lr"] for m in ms], "median_step_ms": step_s * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "max_memory_allocated_bytes": peak,
           "launches": {k: v for k, v in counts.items() if v},
           "step_profile": prof, "card": gpu_name_power()}
    print(f"[train] {json.dumps(out)}")
    del tr
    torch.cuda.empty_cache()
    return counts


def restart_phase() -> None:
    """Phase 9c: checkpoint at step 3, a second trainer resumes from it on
    the card, and its steps 4-6 equal the first trainer's bitwise."""
    import dataclasses
    import shutil

    import torch

    from repro_torch import configs
    from repro_torch.runtime.trainer import Trainer

    cfg = dataclasses.replace(configs.get_config("qwen2-0.5b"),
                              n_layers=RESTART_LAYERS)
    ck = ROOT / "build" / "chip_smoke_ckpt" / "restart"
    shutil.rmtree(ck, ignore_errors=True)
    a = Trainer(cfg, train_config(cfg, "restart", ckpt_every=3,
                                  keep_last=1))
    a.train(3)                          # checkpoint @ step 3 (waited for)
    a.tcfg.ckpt_every = 0
    b = Trainer(cfg, train_config(cfg, "restart"))
    b.resume()
    check(b.data.step == 3, f"restart: resumed at step {b.data.step}")
    lb = [m["loss"] for m in b.train(3)]
    la = [m["loss"] for m in a.train(3)]
    print(f"[restart] {RESTART_LAYERS}-layer qwen2 at full width: steps 4-6 "
          f"of the first trainer {la}, of the resumed one {lb}")
    check(la == lb, "restart: the resumed trainer's losses differ")
    check(all(torch.equal(p, q) for p, q in zip(a.params.parameters(),
                                                b.params.parameters())),
          "restart: the resumed trainer's weights differ")
    del a, b
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()


def train_with_cpu(name: str = "qwen2-0.5b", steps: int = 5) -> dict:
    """Phase 9d (and 12c): the reduced fp32 ``name`` of the CPU tests
    (head_dim 16: K2's and K2-bwd's small-width routes) trained ``steps``
    steps on the card and, from the same weights, on the CPU: losses
    within rtol 1e-4 (TF32 off), the launches exact.  Returns the card
    run's launches."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.runtime.trainer import Trainer
    cfg = configs.get_reduced(name)
    init = api.get_model(cfg).init(torch.Generator().manual_seed(3))
    losses = {}
    for dev in ("cpu", "cuda"):
        tc = train_config(cfg, f"reduced_{dev}", batch=4,
                          seq_len=SMALL_TRAIN_SEQ)
        tr = Trainer(cfg, tc, device=dev, init_params=init)
        reset_counts()
        losses[dev] = [m["loss"] for m in tr.train(steps)]
        if dev == "cuda":
            counts = read_counts()
    want = dict.fromkeys(kernel_wrappers(), 0)
    want["flash_attention"] = 2 * cfg.n_layers * steps
    want["flash_attention_bwd"] = cfg.n_layers * steps
    want["fused_adamw"] = steps
    want = by_route(want, cfg)
    check(counts == want, f"reduced {name} training: launches {counts}, "
          f"expected {want}")
    rel = float(np.max(np.abs(np.subtract(losses["cuda"], losses["cpu"]))
                       / np.abs(losses["cpu"])))
    print(f"[compare] reduced fp32 {name} training (head_dim "
          f"{cfg.resolved_head_dim}): card {losses['cuda']} vs CPU "
          f"{losses['cpu']}, largest relative gap {rel:.3e} (tol 1e-4); "
          f"launches { {k: v for k, v in counts.items() if v} }")
    check(rel <= 1e-4, "reduced fp32 training: card and CPU losses differ")
    return counts


# ----------------------------------------------------------------------------
# phase 10: the encoder-decoder family (whisper-large-v3), served and trained
# ----------------------------------------------------------------------------

def whisper_batch(cfg, B: int, S: int, seed: int, device="cuda") -> dict:
    """Stub-frontend frames (seeded normal, fp32) and prompt tokens."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.n_frames, cfg.d_model),
                                 dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(B, S))
    return {"frames": torch.from_numpy(frames).to(device),
            "tokens": torch.from_numpy(tokens).to(device)}


def blocked_attention(q, k, v, *, causal: bool = True, scale=None,
                      compute_dtype=None, block: int = 256):
    """A second plain version of K2's function (compute fp32): the keys in
    blocks of ``block``, each block's exponentials summed against the
    running maximum and combined by rescaling, in fp32 — the function of
    ``ref.mha_attention``, summed in another order."""
    import torch
    check(compute_dtype in (None, torch.float32),
          "blocked_attention: compute fp32 only")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(H // Hkv, 1)
    vf = v.float().repeat_interleave(H // Hkv, 1)
    qi = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    m = torch.full((B, H, Sq, 1), float("-inf"), device=q.device)
    den = torch.zeros((B, H, Sq, 1), device=q.device)
    acc = torch.zeros((B, H, Sq, D), device=q.device)
    for k0 in range(0, Skv, block):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + block])
        if causal:
            ki = torch.arange(k0, min(Skv, k0 + block), device=q.device)
            s = s.masked_fill(ki[None] > qi, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(torch.isfinite(m_new), m_new,
                           torch.zeros_like(m_new))
        p = torch.exp(s - base)
        alpha = torch.exp(m - base)
        den = den * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                         vf[:, :, k0:k0 + block])
        m = m_new
    return (acc / torch.where(den == 0, torch.ones_like(den), den)) \
        .to(q.dtype)


def whisper_first_logits(model, params, batch, kw, *, plain=None):
    """Last-token logits of the prefill and of one decode step from the
    kernels' prefill state (each call rewrites the same cache row), through
    the kernels or, with ``plain``, through that plain version of K2."""
    run = (lambda f: f()) if plain is None else \
        (lambda f: through_plain(f, attention=plain))
    lk, state = model.prefill(params, batch, **kw)
    tok = lk[:, -1].argmax(-1)[:, None]
    pre = run(lambda: model.prefill(params, batch, **kw))[0]
    dec = run(lambda: model.decode_step(params, tok, state,
                                        WHISPER_PROMPT))[0]
    return pre[:, -1].float(), dec[:, -1].float()


def compare_whisper_paths(cfg, model, params, batch, kw) -> None:
    """Prefill and first decode logits through the kernels vs through the
    plain version: in bf16 (the served weights) against the spread of two
    plain versions, and in fp32 (the same weights, upcast) tightly."""
    import dataclasses

    import torch

    from repro_torch.kernels import ref
    from repro_torch.models import api
    kern = whisper_first_logits(model, params, batch, kw)
    plain = whisper_first_logits(model, params, batch, kw,
                                 plain=ref.mha_attention)
    blocked = whisper_first_logits(model, params, batch, kw,
                                   plain=blocked_attention)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = type(params)(cfg32, device="cuda")
    p32.load_state_dict(params.state_dict())
    m32 = api.get_model(cfg32)
    kern32 = whisper_first_logits(m32, p32, batch, kw)
    plain32 = whisper_first_logits(m32, p32, batch, kw,
                                   plain=ref.mha_attention)
    del p32
    torch.cuda.synchronize()
    for i, what in enumerate(("prefill", "decode")):
        k, p, o = kern[i], plain[i], blocked[i]
        spread = max_err(p, o)
        tol = max(REC_SPREAD_FACTOR * spread, LOGIT_TOL)
        e = max_err(k, p)
        top2 = p.topk(2, dim=-1).values
        gaps = top2[:, 0] - top2[:, 1]
        same = k.argmax(-1) == p.argmax(-1)
        clear = gaps > tol
        print(f"[compare whisper] bf16 {what} logits: max_abs_err={e:.3e} "
              f"max|logit|={float(p.abs().max()):.3f}; two plain versions "
              f"(ref vs key blocks) {spread:.3e} apart, tol {tol:.3e}; "
              f"argmax agreement {int(same.sum())}/{len(same)}, on the "
              f"{int(clear.sum())} rows with a top-2 gap above tol "
              f"{int(same[clear].sum())}")
        check(e <= tol, f"whisper: bf16 {what} logits of the kernels and "
              f"the plain version differ by {e:.3e} > {tol:.3e}")
        check(bool(same[clear].all()),
              f"whisper: bf16 {what} argmax differs on a row whose top-2 "
              f"gap exceeds {tol:.3e}")
        k, p = kern32[i], plain32[i]
        e = max_err(k, p)
        agree = int((k.argmax(-1) == p.argmax(-1)).sum())
        print(f"[compare whisper] fp32 {what} logits: max_abs_err={e:.3e} "
              f"max|logit|={float(p.abs().max()):.3f} argmax agreement "
              f"{agree}/{k.shape[0]} (tol {FP32_LOGIT_TOL})")
        check(e <= FP32_LOGIT_TOL and agree == k.shape[0],
              f"whisper: fp32 {what} logits of the kernels and the plain "
              f"version disagree ({e:.3e}, argmax {agree}/{k.shape[0]})")


def serve_whisper() -> dict:
    """whisper-large-v3 at full width through ``api.get_model``: prefill
    WHISPER_BATCH x (1500 frames + WHISPER_PROMPT tokens), then
    WHISPER_STEPS greedy decode steps; returns the kernels' launches of
    that run."""
    import torch

    from repro_torch import configs
    from repro_torch.models import api, encdec
    cfg = configs.get_config("whisper-large-v3")
    model = api.get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    print(f"[whisper] {cfg.name}: {n_par} parameters ({n_par * 2 / 1e9:.2f} "
          f"GB bf16), init {time.perf_counter() - t0:.1f} s")
    batch = whisper_batch(cfg, WHISPER_BATCH, WHISPER_PROMPT, seed=5)
    kw = {"max_len": WHISPER_PROMPT + WHISPER_STEPS}
    model.prefill(params, batch, **kw)         # warm: cuBLAS, first launches
    torch.cuda.synchronize()

    reset_counts()                             # the main path's run
    t0 = time.perf_counter()
    logits, state = model.prefill(params, batch, **kw)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre_counts = read_counts()
    tok = logits[:, -1].argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(WHISPER_STEPS):
        logits, state = model.decode_step(params, tok, state,
                                          WHISPER_PROMPT + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    counts = read_counts()                     # ... ends here
    want = expected_launches(cfg, decode_steps=0)
    check(pre_counts == want, f"whisper prefill: launches {pre_counts}, "
          f"expected {want}")
    want = expected_launches(cfg, decode_steps=WHISPER_STEPS)
    check(counts == want, f"whisper: launches {counts}, expected {want}")
    toks = torch.cat(out, 1).cpu().numpy()
    check(tuple(logits.shape) == (WHISPER_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "whisper: decode logits not finite or of the wrong shape")
    check(toks.shape == (WHISPER_BATCH, WHISPER_STEPS + 1)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "whisper: a token lies outside the vocabulary")
    enc_ms = time_ms(lambda: encdec.encode(cfg, params, batch["frames"]),
                     iters=3, warmup=1)
    res = {"model": cfg.name, "segments": WHISPER_BATCH,
           "frames": cfg.n_frames, "prompt_len": WHISPER_PROMPT,
           "decode_steps": WHISPER_STEPS, "prefill_ms": pre_s * 1e3,
           "encoder_ms": enc_ms,
           "decoder_prefill_ms (prefill - encoder)": pre_s * 1e3 - enc_ms,
           "decode_ms_per_step": dec_s * 1e3 / WHISPER_STEPS,
           "generated_tokens_per_s": WHISPER_BATCH * WHISPER_STEPS / dec_s,
           "launches_prefill": {k: v for k, v in pre_counts.items() if v},
           "launches": {k: v for k, v in counts.items() if v},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": gpu_name_power()}
    print(f"[serve whisper] {json.dumps(res)}")

    compare_whisper_paths(cfg, model, params, batch, kw)
    _, state = model.prefill(params, batch, **kw)
    tok = logits[:, -1].argmax(-1)[:, None]
    prof = {"prefill": device_profile(
        lambda: model.prefill(params, batch, **kw), 1),
        "decode step": device_profile(
        lambda: model.decode_step(params, tok, state, WHISPER_PROMPT), 3)}
    for what, p in prof.items():
        print(f"[profile whisper {what}] {json.dumps(p)}")
    del params, state
    torch.cuda.empty_cache()
    return counts


def compare_whisper_with_cpu() -> dict:
    """The reduced fp32 whisper of the CPU tests (head_dim 16: K2's
    small-width route; 8 frames) served on the card and, from the same
    weights, on the CPU: the same tokens, logits within rtol 1e-4, the
    launches exact.  Returns the card run's launches."""
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    cfg = configs.get_reduced("whisper-large-v3")
    model = api.get_model(cfg)
    params = model.init(torch.Generator(device="cpu").manual_seed(3))
    batch = whisper_batch(cfg, 2, 24, seed=7, device="cpu")
    S, steps = 24, 8
    toks, logits_by = {}, {}
    for dev in ("cpu", "cuda"):
        p = type(params)(cfg, device=dev)
        p.load_state_dict(params.state_dict())
        reset_counts()
        logits, state = model.prefill(
            p, {k: v.to(dev) for k, v in batch.items()}, max_len=S + steps)
        seq, lg = [], [logits.cpu()]
        for i in range(steps):
            tok = logits[:, -1].argmax(-1)[:, None]
            seq.append(tok.cpu())
            logits, state = model.decode_step(p, tok, state, S + i)
            lg.append(logits.cpu())
        toks[dev], logits_by[dev] = torch.cat(seq, 1), torch.cat(lg, 1)
        if dev == "cuda":
            launched = read_counts()
    want = expected_launches(cfg, decode_steps=steps)
    check(launched == want, f"reduced whisper: launches {launched}, "
          f"expected {want}")
    check(torch.equal(toks["cuda"], toks["cpu"]),
          "reduced fp32 whisper: card and CPU tokens differ")
    rel = float(((logits_by["cuda"] - logits_by["cpu"]).abs()
                 / (logits_by["cpu"].abs() + 1e-4)).max())
    check(torch.allclose(logits_by["cuda"], logits_by["cpu"], rtol=1e-4,
                         atol=1e-4),
          f"reduced fp32 whisper: card and CPU logits differ ({rel:.3e})")
    print(f"[compare] reduced fp32 whisper (head_dim "
          f"{cfg.resolved_head_dim}, {cfg.n_frames} frames): card tokens == "
          f"CPU tokens over {steps} decode steps, logits within rtol 1e-4 "
          f"(largest |diff| / (|cpu| + 1e-4) {rel:.3e}); kernels launched "
          f"on the card: { {k: v for k, v in launched.items() if v} }")
    return launched


def train_whisper() -> dict:
    """whisper-large-v3 at full width trained on the card through
    ``Trainer(comm="single")``; returns the kernels' launches of that run."""
    import copy

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.runtime.trainer import Trainer

    cfg = configs.get_config("whisper-large-v3")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, train_config(cfg, "whisper", batch=WHISPER_TRAIN_BATCH,
                                   seq_len=WHISPER_TRAIN_SEQ))
    torch.cuda.synchronize()
    print(f"[train whisper] {tr.n_params} parameters, {cfg.dtype}, init "
          f"{time.perf_counter() - t0:.1f} s; batch {WHISPER_TRAIN_BATCH} x "
          f"({cfg.n_frames} frames + {WHISPER_TRAIN_SEQ} tokens), remat, "
          "AdamW lr 3e-4")
    reset_counts()                     # the main path's run starts here
    ms = tr.train(WHISPER_TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()             # ... and ends here
    losses = [m["loss"] for m in ms]
    check(all(np.isfinite(losses)), f"whisper train: a loss is not finite: "
          f"{losses}")
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = 2 * n_attn * WHISPER_TRAIN_STEPS
    want["flash_attention_bwd"] = n_attn * WHISPER_TRAIN_STEPS
    want["fused_adamw"] = WHISPER_TRAIN_STEPS
    check(counts == want, f"whisper train: launches {counts}, expected "
          f"{want} (K2 {2 * n_attn}, K2-bwd {n_attn} and AdamW's pair once "
          "a step)")
    step_s = float(np.median([m["step_time_s"] for m in ms]))
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(tr.train_step, 1)
    probe = copy.deepcopy(tr.data)     # the host's batch, on its own
    t0 = time.perf_counter()
    probe.next_batch()
    batch_ms = (time.perf_counter() - t0) * 1e3
    out = {"losses": losses,
           "grad_norms": [m["grad_norm"] for m in ms],
           "step_ms": [m["step_time_s"] * 1e3 for m in ms],
           "host_batch_ms": batch_ms,
           "median_step_ms": step_s * 1e3,
           "tokens_per_s": WHISPER_TRAIN_BATCH * WHISPER_TRAIN_SEQ / step_s,
           "frames_per_s": WHISPER_TRAIN_BATCH * cfg.n_frames / step_s,
           "launches_per_step": {k: v // WHISPER_TRAIN_STEPS
                                 for k, v in counts.items() if v},
           "max_memory_allocated_bytes": peak, "step_profile": prof,
           "card": gpu_name_power()}
    print(f"[train whisper] {json.dumps(out)}")
    del tr
    torch.cuda.empty_cache()
    return counts


def train_whisper_with_cpu() -> dict:
    """Phase 10d: the reduced fp32 whisper of phase 10b trained 3 steps on
    the card and, from the same weights, on the CPU: losses within rtol
    1e-4 (TF32 off), K2 twice and K2-bwd once an attention a step, on
    their small-width routes.  Returns the card run's launches."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.runtime.trainer import Trainer
    cfg = configs.get_reduced("whisper-large-v3")
    init = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    steps, n_attn = 3, cfg.n_enc_layers + 2 * cfg.n_layers
    losses = {}
    for dev in ("cpu", "cuda"):
        tc = train_config(cfg, f"whisper_reduced_{dev}", batch=2, seq_len=40)
        tr = Trainer(cfg, tc, device=dev, init_params=init)
        reset_counts()
        losses[dev] = [m["loss"] for m in tr.train(steps)]
        if dev == "cuda":
            launched = read_counts()
    want = dict.fromkeys(kernel_wrappers(), 0)
    want["flash_attention"] = 2 * n_attn * steps
    want["flash_attention_bwd"] = n_attn * steps
    want["fused_adamw"] = steps
    want = by_route(want, cfg)
    check(launched == want, f"reduced whisper training: launches "
          f"{launched}, expected {want}")
    rel = float(np.max(np.abs(np.subtract(losses["cuda"], losses["cpu"]))
                       / np.abs(losses["cpu"])))
    print(f"[compare] reduced fp32 whisper training (head_dim "
          f"{cfg.resolved_head_dim}, {cfg.n_frames} frames): card "
          f"{losses['cuda']} vs CPU {losses['cpu']}, largest relative gap "
          f"{rel:.3e} (tol 1e-4)")
    check(all(np.isfinite(losses["cuda"])) and rel <= 1e-4,
          "reduced fp32 whisper training: card and CPU losses differ")
    return launched


def whisper_phases() -> dict:
    """Phase 10; returns the launches of its two main paths."""
    paths = {"whisper_serve": phase("10a whisper serving", serve_whisper)}
    paths["reduced_whisper_serve"] = phase(
        "10b reduced whisper card vs CPU", compare_whisper_with_cpu)
    paths["whisper_train"] = phase("10c whisper training", train_whisper)
    paths["reduced_whisper_train"] = phase(
        "10d reduced whisper training card vs CPU", train_whisper_with_cpu)
    return paths


# ----------------------------------------------------------------------------
# phase 11: the recurrent families trained (K3-bwd, K4-bwd)
# ----------------------------------------------------------------------------

# K3-bwd and K4-bwd vs the plain backward (autograd through the chunked
# forms): max |got - want| <= bar * max |want| for each gradient, the
# ROADMAP's kernel bars
SCAN_BWD_BARS = {"torch.float32": 3e-4, "torch.bfloat16": 6e-2}
# rwkv6-1.6b and zamba2-1.2b training: bf16 (the configs' dtype), seed-0
# weights, batch 4 x 1024 tokens, remat, AdamW lr 3e-4 without warmup, 3
# steps; per step, rwkv6 runs K4 twice a layer (the forward and its
# recompute) and K4-bwd once, zamba2 K3 twice and K3-bwd once a mamba layer
# and K2 and K2-bwd once an application of its shared block (not
# recomputed, as in JAX)
REC_TRAIN_BATCH, REC_TRAIN_SEQ, REC_TRAIN_STEPS = 4, 1024, 3


def rwkv_bwd_case(B, S, H, dtype, *, state: bool, seed: int,
                  floor: bool = False):
    """K4-bwd's inputs: rwkv_case's, the output gradient, and with
    ``state`` s0 and the final state's gradient; ``floor`` puts w = 0 and a
    bf16/fp32 denormal (under the plain version's 1e-30 floor) in every few
    entries."""
    import torch
    r, k, v, w, u, s0 = rwkv_case(B, S, H, dtype, s0=state, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    if floor:
        w = w.clone()
        w.view(-1)[::7] = 0.0
        w.view(-1)[3::11] = 1e-39
    dy = torch.randn(r.shape, device="cuda", generator=g).to(dtype)
    ds_out = (torch.randn(B, H, 64, 64, device="cuda", generator=g)
              if state else None)
    return r, k, v, w, u, s0, dy, ds_out


def mamba_bwd_case(B, S, H, dtype, *, state: bool, seed: int,
                   views: bool = False):
    """K3-bwd's inputs: mamba_case's (as the mixer's strided views with
    ``views``), the output gradient, and with ``state`` h0 and the final
    state's gradient."""
    import torch
    case = mamba_case(B, S, H, dtype, h0=state, seed=seed)
    if views:
        case = mixer_views(case)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    dy = torch.randn(B, S, H, 64, device="cuda", generator=g).to(dtype)
    dh_out = (torch.randn(B, H, 64, 64, device="cuda", generator=g)
              if state else None)
    return (*case, dy, dh_out)


def scan_bwd_bound(x, n_vec_in, n_vec_out, extra_bytes, dtype):
    """The least time for a scan's gradient (``kernels/cost.py``'s
    ``scan_bwd``: ``n_vec_in`` (B,S,H,dh) inputs read and ``n_vec_out``
    written once, plus ``extra_bytes``), at the inputs' type's peak: (bound
    ms, bound by, bytes, flops)."""
    from repro_torch.kernels import cost
    flops, nbytes = cost.scan_bwd(*x.shape, x.element_size(), n_vec_in,
                                  n_vec_out, extra_bytes)
    return (*bound(nbytes, flops, dtype), nbytes, flops)


def run_scan_bwd_checks(report: dict) -> None:
    """Phase 11a: K4-bwd and K3-bwd vs the plain backward at the training
    shapes and their edges (S = 1, S = 37, a state in and its gradient
    out, the mixer's strided views, w under the floor), every edge in bf16
    (the chunk-parallel route) and fp32 (the sequential route), each call's
    route checked; reruns bitwise; timed at the training shapes."""
    import torch

    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rw

    bf, f32 = torch.bfloat16, torch.float32

    def held(tag, name, got, want, names, dtype):
        bar = SCAN_BWD_BARS[str(dtype)]
        ratios, e_max = [], 0.0
        for gname, g, w in zip(names, got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{tag} {name}: {gname} is {g.dtype} {tuple(g.shape)}, the "
                  f"plain version's {w.dtype} {tuple(w.shape)}")
            check(bool(torch.isfinite(g).all()),
                  f"{tag}: non-finite {gname}: {name}")
            e = max_err(g, w)
            ratios.append(e / (bar * float(w.float().abs().max())))
            e_max = max(e_max, e)
        print(f"[{tag}] {name}: max_abs_err={e_max:.3e} err/bar "
              f"({', '.join(names)}) = {', '.join(f'{r:.3f}' for r in ratios)}"
              f" (bar {bar:g} max|want|)")
        check(max(ratios) <= 1, f"{tag} disagrees with the plain backward: "
              f"{name}")
        return e_max

    def route(mod, dtype):
        """the kernel each dtype's route reports: fp32 the sequential
        kernel, bf16 the chunk-parallel one"""
        return mod.BWD_KERNELS[int(dtype == bf)]

    # -- K4-bwd: rwkv6 training B=4 S=1024 H=32; every edge in both dtypes
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    edges = [("rwkv6 training B=4 S=1024 H=32", (4, 1024, 32), False, False),
             ("S=1, s0 and ds_out", (4, 1, 32), True, False),
             ("S=37, s0 and ds_out", (2, 37, 8), True, False),
             ("S=1024, s0 and ds_out", (2, 1024, 8), True, False),
             ("B=2 S=300 H=8, s0 and ds_out", (2, 300, 8), True, False),
             ("S=37", (2, 37, 8), False, False),
             ("w under the floor (0, 1e-39) S=200, s0 and ds_out",
              (2, 200, 8), True, True),
             ("w under the floor (0, 1e-39) S=200", (2, 200, 8), False, True)]
    errs = []
    for i, (label, (B, S, H), state, floor) in enumerate(edges):
        for dtype in (bf, f32):
            name = f"{label} {'bf16' if dtype == bf else 'fp32'}"
            r, k, v, w, u, s0, dy, ds_out = rwkv_bwd_case(
                B, S, H, dtype, state=state, seed=60 + i, floor=floor)
            got = rw.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
            check(rw.rwkv6_scan_bwd.last_kernel == route(rw, dtype),
                  f"K4-bwd {name}: launched {rw.rwkv6_scan_bwd.last_kernel}")
            want = ref.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0,
                                      ds_out=ds_out)
            torch.cuda.synchronize()
            errs.append(held("K4-bwd", name, got, want, names, dtype))
            if floor:
                under = w.float() < 1e-30
                check(bool(under.any()) and not got[3][under].any(),
                      f"K4-bwd: a gradient of w under the floor: {name}")
            del got, want
    # the timed shape, bf16 (the chunk-parallel route), and in fp32 (the
    # sequential route) beside it
    r, k, v, w, u, s0, dy, ds_out = rwkv_bwd_case(4, 1024, 32, bf,
                                                  state=False, seed=60)
    call = lambda: rw.rwkv6_scan_bwd(r, k, v, w, u, dy,  # noqa: E731
                                     need_ds0=False)
    a, b = call(), call()
    check(all(torch.equal(x, y) for x, y in zip(a[:5], b[:5])),
          "K4-bwd: two runs at the training shape differ")
    del a, b
    B, S, H, dh = r.shape
    b_ms, b_by, nbytes, flops = scan_bwd_bound(r, 5, 4, 2 * H * dh * 4, bf)
    report["rwkv6_scan_bwd"] = dict(
        name="rwkv6_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv6_scan_bwd_chunk.cu",
        source_fp32_route="src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:59",
        device_kernels=list(rw.BWD_KERNELS), max_abs_err=max(errs),
        ms=time_ms(call, iters=10, warmup=2),
        ms_graph=time_graph_ms(call, iters=10, reps=3),
        plain_ms=time_ms(lambda: ref.rwkv6_scan_bwd(r, k, v, w, u, dy),
                         iters=2, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=nbytes,
        flops=flops)
    r32, k32, v32, w32, u32, _, dy32, _ = rwkv_bwd_case(4, 1024, 32, f32,
                                                        state=False, seed=60)
    call = lambda: rw.rwkv6_scan_bwd(r32, k32, v32, w32, u32,  # noqa: E731
                                     dy32, need_ds0=False)
    report["rwkv6_scan_bwd"].update(
        ms_fp32_route=time_ms(call, iters=5, warmup=1),
        ms_graph_fp32_route=time_graph_ms(call, iters=3, reps=3),
        bound_ms_fp32_route=scan_bwd_bound(r32, 5, 4, 2 * H * dh * 4,
                                           f32)[0])
    del r32, k32, v32, w32, dy32

    # -- K3-bwd: zamba2 training B=4 S=1024 H=64, the mixer's views --------
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
    edges = [("zamba2 training B=4 S=1024 H=64, the mixer's strided views",
              (4, 1024, 64), False, True),
             ("S=1, h0 and dh_out", (4, 1, 64), True, False),
             ("S=37, h0 and dh_out", (2, 37, 8), True, False),
             ("S=1024, h0 and dh_out, strided views", (2, 1024, 8), True,
              True),
             ("B=2 S=300 H=8, h0 and dh_out", (2, 300, 8), True, False),
             ("S=37, strided views", (2, 37, 8), False, True)]
    errs = []
    for i, (label, (B, S, H), state, views) in enumerate(edges):
        for dtype in (bf, f32):
            name = f"{label} {'bf16' if dtype == bf else 'fp32'}"
            x, dt, A, Bm, Cm, D, h0, dy, dh_out = mamba_bwd_case(
                B, S, H, dtype, state=state, seed=70 + i, views=views)
            got = m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0,
                                     dh_out=dh_out)
            check(m2.mamba2_scan_bwd.last_kernel == route(m2, dtype),
                  f"K3-bwd {name}: launched {m2.mamba2_scan_bwd.last_kernel}")
            want = ref.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0,
                                       dh_out=dh_out)
            torch.cuda.synchronize()
            want = tuple(t.contiguous() for t in want)
            errs.append(held("K3-bwd", name, got, want, names, dtype))
            del got, want
    x, dt, A, Bm, Cm, D, h0, dy, dh_out = mamba_bwd_case(
        4, 1024, 64, bf, state=False, seed=70, views=True)
    call = lambda: m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy,  # noqa: E731
                                      need_dh0=False)
    a, b = call(), call()
    check(all(torch.equal(p, q) for p, q in zip(a[:6], b[:6])),
          "K3-bwd: two runs at the training shape differ")
    del a, b
    B, S, H, dh = x.shape
    # x, dy in and dx out; B, C in and dB, dC out; dt in and ddt out
    extra = 4 * B * S * 64 * x.element_size() + 2 * B * S * H * 4 + 4 * H * 4
    b_ms, b_by, nbytes, flops = scan_bwd_bound(x, 2, 1, extra, bf)
    report["mamba2_scan_bwd"] = dict(
        name="mamba2_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/mamba2_scan_bwd_chunk.cu",
        source_fp32_route="src/repro_torch/kernels/csrc/mamba2_scan_bwd.cu",
        replaces="src/repro/kernels/mamba2_scan.py:69",
        device_kernels=list(m2.BWD_KERNELS), max_abs_err=max(errs),
        ms=time_ms(call, iters=10, warmup=2),
        ms_graph=time_graph_ms(call, iters=10, reps=3),
        plain_ms=time_ms(lambda: ref.mamba2_scan_bwd(x, dt, A, Bm, Cm, D,
                                                     dy),
                         iters=2, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=nbytes,
        flops=flops)
    c32 = mamba_bwd_case(4, 1024, 64, f32, state=False, seed=70, views=True)
    call = lambda: m2.mamba2_scan_bwd(*c32[:6], c32[7],  # noqa: E731
                                      need_dh0=False)
    extra32 = 4 * B * S * 64 * 4 + 2 * B * S * H * 4 + 4 * H * 4
    report["mamba2_scan_bwd"].update(
        ms_fp32_route=time_ms(call, iters=5, warmup=1),
        ms_graph_fp32_route=time_graph_ms(call, iters=3, reps=3),
        bound_ms_fp32_route=scan_bwd_bound(c32[0], 2, 1, extra32, f32)[0])
    del c32
    for key in ("rwkv6_scan_bwd", "mamba2_scan_bwd"):
        r_ = report[key]
        r_["kernel_ms"] = r_["ms"]
        print(f"[{key}] timed at the training shape: bf16 route ms="
              f"{r_['ms']:.4f} ms_graph={r_['ms_graph']:.4f} plain_ms="
              f"{r_['plain_ms']:.3f} bound_ms={r_['bound_ms']:.5f} "
              f"({r_['bound_by']}; {r_['bytes']} bytes, {r_['flops']:.4g} "
              f"operations), {r_['bound_ms'] / r_['ms_graph']:.4f} of the "
              f"bound; fp32 route ms={r_['ms_fp32_route']:.4f} ms_graph="
              f"{r_['ms_graph_fp32_route']:.4f} (its bound "
              f"{r_['bound_ms_fp32_route']:.5f}); library: none (no single "
              "PyTorch call computes the scan's gradient)")


def train_recurrent(name: str) -> dict:
    """Phase 11b/c: ``name`` at full width trained REC_TRAIN_STEPS steps on
    the card through ``Trainer(comm="single")``; returns the kernels'
    launches of that run."""
    import gc

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import hybrid
    from repro_torch.runtime.trainer import Trainer

    cfg = configs.get_config(name)
    gc.collect()                       # earlier phases' tensors, not ours
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, train_config(cfg, name, batch=REC_TRAIN_BATCH,
                                   seq_len=REC_TRAIN_SEQ))
    torch.cuda.synchronize()
    print(f"[train {name}] {tr.n_params} parameters, {cfg.dtype}, init "
          f"{time.perf_counter() - t0:.1f} s; batch {REC_TRAIN_BATCH} x "
          f"{REC_TRAIN_SEQ}, remat, AdamW lr 3e-4")
    reset_counts()                     # the main path's run starts here
    ms = tr.train(REC_TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()             # ... and ends here
    losses = [m["loss"] for m in ms]
    check(all(np.isfinite(losses)), f"{name} train: a loss is not finite: "
          f"{losses}")
    n = REC_TRAIN_STEPS
    want = dict.fromkeys(counts, 0)
    want["fused_adamw"] = n
    if cfg.family == "rwkv6":
        want["rwkv6_scan"] = 2 * cfg.n_layers * n
        want["rwkv6_scan_bwd"] = cfg.n_layers * n
    else:
        apps = hybrid.n_shared_applications(cfg)
        want["mamba2_scan"] = 2 * cfg.n_layers * n
        want["mamba2_scan_bwd"] = cfg.n_layers * n
        want["flash_attention"] = apps * n
        want["flash_attention_bwd"] = apps * n
    check(counts == want, f"{name} train: launches {counts}, expected "
          f"{want}")
    step_s = float(np.median([m["step_time_s"] for m in ms]))
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(tr.train_step, 1)
    out = {"losses": losses,
           "grad_norms": [m["grad_norm"] for m in ms],
           "step_ms": [m["step_time_s"] * 1e3 for m in ms],
           "median_step_ms": step_s * 1e3,
           "tokens_per_s": REC_TRAIN_BATCH * REC_TRAIN_SEQ / step_s,
           "launches_per_step": {k: v // n for k, v in counts.items() if v},
           "max_memory_allocated_bytes": peak, "step_profile": prof,
           "card": gpu_name_power()}
    print(f"[train {name}] {json.dumps(out)}")
    del tr
    torch.cuda.empty_cache()
    return counts


def train_recurrent_with_cpu() -> dict:
    """Phase 11d: the reduced fp32 rwkv6, mamba2 and zamba2 of the CPU tests
    (head_dim 16; ssm head_dim 8, d_state 8: the small-width routes)
    trained 3 steps on the card and, from the same weights, on the CPU:
    losses within rtol 1e-4 (TF32 off), the scans and their backward
    kernels on every layer.  Returns the card runs' launches, summed."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api, hybrid
    from repro_torch.runtime.trainer import Trainer
    cases = [("rwkv6-1.6b", None), ("zamba2-1.2b", "mamba2"),
             ("zamba2-1.2b", None)]
    steps = 3
    total: dict = {}
    for name, family in cases:
        cfg = configs.get_config(name)
        if family:
            cfg = dataclasses.replace(cfg, family=family)
        cfg = cfg.reduced()
        init = api.get_model(cfg).init(torch.Generator().manual_seed(0))
        losses = {}
        for dev in ("cpu", "cuda"):
            tc = train_config(cfg, f"{cfg.family}_reduced_{dev}", batch=2,
                              seq_len=70)
            tr = Trainer(cfg, tc, device=dev, init_params=init)
            reset_counts()
            losses[dev] = [m["loss"] for m in tr.train(steps)]
            if dev == "cuda":
                launched = read_counts()
        L = cfg.n_layers
        want = dict.fromkeys(kernel_wrappers(), 0)
        want["fused_adamw"] = steps
        if cfg.family == "rwkv6":
            want.update(rwkv6_scan=2 * L * steps, rwkv6_scan_bwd=L * steps)
        else:
            want.update(mamba2_scan=2 * L * steps, mamba2_scan_bwd=L * steps)
        if cfg.family == "zamba2":
            apps = hybrid.n_shared_applications(cfg)
            want.update(flash_attention=apps * steps,
                        flash_attention_bwd=apps * steps)
        want = by_route(want, cfg)
        check(launched == want, f"reduced {cfg.family} training: launches "
              f"{launched}, expected {want}")
        total = {k: total.get(k, 0) + v for k, v in launched.items()}
        rel = float(np.max(np.abs(np.subtract(losses["cuda"], losses["cpu"]))
                           / np.abs(losses["cpu"])))
        print(f"[compare] reduced fp32 {cfg.family} training (kernel "
              f"shapes): card {losses['cuda']} vs CPU {losses['cpu']}, "
              f"largest relative gap {rel:.3e} (tol 1e-4); launches "
              f"{ {k: v for k, v in launched.items() if v} }")
        check(all(np.isfinite(losses["cuda"])) and rel <= 1e-4,
              f"reduced fp32 {cfg.family} training: card and CPU losses "
              "differ")
    return total


def recurrent_train_phases(report: dict) -> dict:
    """Phase 11; returns the launches of its two main paths."""
    phase("11a scan backward kernels vs plain", run_scan_bwd_checks, report)
    paths = {}
    for name, path in (("rwkv6-1.6b", "rwkv6_train"),
                       ("zamba2-1.2b", "zamba2_train")):
        paths[path] = phase(f"11 {name} training", train_recurrent, name)
    paths["reduced_recurrent_train"] = phase(
        "11d reduced recurrent training card vs CPU",
        train_recurrent_with_cpu)
    return paths


# ----------------------------------------------------------------------------
# phase 12: the MoE family (olmoe-1b-7b), served and trained
# ----------------------------------------------------------------------------

def routed(fn):
    """fn() with every MoE dispatch's top-k expert choices recorded:
    (fn's result, [one (T, K) tensor of sorted expert ids a dispatch, in
    the order the layers ran])."""
    from repro_torch.models import moe
    calls, dispatch = [], moe._local_dispatch

    def record(cfg, xt, router, K, E, C):
        out = dispatch(cfg, xt, router, K, E, C)
        calls.append(out[3].reshape(-1, K).sort(-1).values)
        return out

    moe._local_dispatch = record
    try:
        return fn(), calls
    finally:
        moe._local_dispatch = dispatch


def route_flips(a: list, b: list) -> tuple[int, int]:
    """Between two runs' recorded dispatches: (the tokens whose layer-0
    top-k expert set differs, the (token, layer) pairs whose set differs
    in any layer)."""
    check(len(a) == len(b) and all(x.shape == y.shape for x, y in zip(a, b)),
          "route_flips: the runs dispatched differently shaped blocks")
    differ = [int(((x[:, :, None] == y[:, None, :]).any(-1).sum(-1)
                   < x.shape[1]).sum()) for x, y in zip(a, b)]
    return differ[0], sum(differ)


def held_layerwise(fn, names=("paged_attention", "flash_attention")):
    """fn() with every call of the ``ops`` wrappers ``names`` (K1 and K2 by
    default; K3, K4 and K4's split-key route besides) also run through its
    plain version on the kernel path's own inputs, and held there: the
    attention kernels at phase 2's bars (BF16_TOL for bf16 outputs,
    FP32_TOL for fp32; compute dtype fp32), the scans' outputs and final
    states at phase 2's scan bars, the split route's fp32 outputs at
    FP32_TOL (as 15a holds it); K2's LSE route (``return_lse``) under
    ``flash_attention_lse``, its output at the attention bar and its fp32
    LSE at FP32_TOL.  Returns (fn's result, {wrapper: [calls, largest
    err/tol]})."""
    import torch

    from repro_torch.kernels import ops, ref

    def attention(got, want):
        return tol_ratio(got, want, BF16_TOL if got.dtype == torch.bfloat16
                         else FP32_TOL)

    def scan(got, want):
        bars = ((SCAN_OUT_REL, SCAN_OUT_ABS),
                (SCAN_STATE_REL, SCAN_STATE_ABS))
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        return max(tol_ratio(g, w, scan_tol(w, *b))
                   for g, w, b in zip(got, want, bars))

    def split(got, want):
        return max(tol_ratio(g, w, FP32_TOL) for g, w in zip(got, want))

    def lse(got, want):      # (out, fp32 LSE): no key seen, +inf on both
        (o, g), (wo, w) = got, want
        if not torch.equal(torch.isinf(g), torch.isinf(w)):
            return float("inf")
        seen = torch.isfinite(w)
        return max(attention(o, wo), tol_ratio(g[seen], w[seen], FP32_TOL)
                   if bool(seen.any()) else 0.0)

    plain = {"paged_attention": (ref.paged_attention, attention),
             "flash_attention": (ref.mha_attention, attention),
             "mamba2_scan": (ref.mamba2_scan_chunked, scan),
             "rwkv6_scan": (ref.rwkv6_scan_chunked, scan),
             "rwkv6_scan_split": (ref.rwkv6_scan_split, split)}
    real = {k: getattr(ops, k) for k in names}
    worst = {k: [0, 0.0] for k in names}

    def wrap(name):
        def call(*a, **kw):
            if plain[name][1] is attention:
                cdt = kw.get("compute_dtype", torch.float32)
                check(cdt == torch.float32, f"held_layerwise: {name} under "
                      f"compute_dtype {cdt}")
            got = real[name](*a, **kw)
            want = plain[name][0](*a, **kw)
            key, bar = name, plain[name][1]
            if kw.get("return_lse"):       # K2's LSE route, counted apart
                key, bar = "flash_attention_lse", lse
                worst.setdefault(key, [0, 0.0])
            worst[key][0] += 1
            worst[key][1] = max(worst[key][1], bar(got, want))
            return got
        return call

    for k in names:
        setattr(ops, k, wrap(k))
    try:
        return fn(), worst
    finally:
        for k, f in real.items():
            setattr(ops, k, f)


def compare_moe_paths(cfg, params) -> dict:
    """Phase 12a's kernel checks on the engine's state: 4 whole prefills
    and one decode step of 8 prefilled slots, every K1 and K2 call of
    every layer held to its plain version on its own inputs
    (``held_layerwise``).  End to end, the bf16 model through the kernels
    and through the plain versions can route a token to other experts at
    a near-tie (top-k is discontinuous), after which their logits part for
    a reason that is not the kernels': the logit gap is reported beside the
    tokens whose layer-0 top-8 set differs, not held.  Returns the
    per-request prefill times and the profiled decode step."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import PagedLM

    lm = PagedLM(cfg, params, max_batch=8, max_seq=1024 + 64,
                 page_tokens=16, device="cuda")
    reqs = make_requests(cfg, 8, 128, 1024, 8, seed=2)
    held = {"paged_attention": [0, 0.0], "flash_attention": [0, 0.0]}

    def hold(fn):
        out, w = held_layerwise(fn)
        for k, (n, s) in w.items():
            held[k] = [held[k][0] + n, max(held[k][1], s)]
        return out

    pre = {"logit_gap": [], "max_logit": [], "layer0_flips": [],
           "flips_any_layer": [], "argmax_same": [], "tokens": []}
    for r in reqs[:4]:
        slot = lm.claim_slot(len(r.prompt), 1)
        run = lambda: lm._prefill_logits(slot, r.prompt)  # noqa: E731
        kern, rk = routed(lambda: hold(run))
        pl, rp = routed(lambda: through_plain(run))
        lm.free_slot(slot)
        flips = route_flips(rk, rp)
        pre["logit_gap"].append(max_err(kern, pl))
        pre["max_logit"].append(float(pl.float().abs().max()))
        pre["layer0_flips"].append(flips[0])
        pre["flips_any_layer"].append(flips[1])
        pre["argmax_same"].append(int(kern.argmax()) == int(pl.argmax()))
        pre["tokens"].append(len(r.prompt))

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
    print(f"[olmoe prefill] per request ms: {[round(x, 3) for x in pre_ms]} "
          f"(prompts {[len(r.prompt) for r in reqs]}; "
          f"{pre_tps:.1f} prompt tokens/s)")
    tokens = np.array([r.out_tokens[-1] for r in reqs], np.int32)
    active = np.ones((8,), bool)
    k_save, v_save = lm.k_pool.clone(), lm.v_pool.clone()
    kern, rk = routed(lambda: hold(lambda: lm.decode_logits(tokens,
                                                            active)))
    lm.k_pool.copy_(k_save)
    lm.v_pool.copy_(v_save)
    pl, rp = routed(lambda: through_plain(
        lambda: lm.decode_logits(tokens, active)))
    flips = route_flips(rk, rp)
    dec = {"logit_gap": max_err(kern, pl),
           "max_logit": float(pl.float().abs().max()),
           "layer0_flips": flips[0],
           "flips_any_layer": flips[1],
           "argmax_same": int((kern.argmax(-1) == pl.argmax(-1)).sum()),
           "rows": len(tokens)}
    L = cfg.n_layers
    print(f"[compare olmoe] every layer's K1 / K2 call held to its plain "
          f"version on its own inputs: K2 {held['flash_attention'][0]} calls"
          f", largest err/tol {held['flash_attention'][1]:.3f}; K1 "
          f"{held['paged_attention'][0]} calls, largest err/tol "
          f"{held['paged_attention'][1]:.3f} (tol {BF16_TOL[0]:.3g}|want| + "
          f"{BF16_TOL[1]:.3g}). End to end, kernels vs plain (not held: a "
          f"near-tie in the router moves a token to other experts): "
          f"prefill logit gap per prompt {pre['logit_gap']} (max|logit| "
          f"{pre['max_logit']}) with "
          f"{pre['layer0_flips']} of {pre['tokens']} tokens whose layer-0 "
          f"top-8 set differs ({pre['flips_any_layer']} (token, layer) "
          f"pairs in any of the {L} layers), argmax same "
          f"{pre['argmax_same']}; decode logit gap "
          f"{dec['logit_gap']:.4f} (max|logit| {dec['max_logit']:.3f}), "
          f"layer-0 flips {dec['layer0_flips']} of "
          f"8 rows ({dec['flips_any_layer']} in any layer), argmax same "
          f"{dec['argmax_same']}/8")
    check(held["flash_attention"][0] == 4 * L
          and held["paged_attention"][0] == L,
          f"olmoe: the layerwise hold saw {held} calls, expected K2 4 x {L} "
          f"and K1 {L}")
    check(held["flash_attention"][1] <= 1 and held["paged_attention"][1] <= 1,
          f"olmoe: a kernel disagrees with its plain version on its own "
          f"inputs: {held}")
    return {"held_layerwise": held, "prefill_end_to_end": pre,
            "decode_end_to_end": dec, "prefill_ms": pre_ms,
            "prompt_tokens_per_s": pre_tps,
            "decode_step": profile_decode(lm, tokens, active)}


def serve_olmoe() -> dict:
    """Phase 12a: olmoe-1b-7b at full width and depth (16 layers, 16
    heads of 128, 64 experts top-8) served through the paged engine: 16
    requests, max_batch 8, pages of 16, whole and chunked prefill; K1
    exactly decode steps x 16 on its split-K route, K2 16 a request
    (whole prefill) on its ``mma`` route; prefill and decode ms, tokens/s,
    busy share, peak memory; then the kernels held layer by layer.  Frees
    the card.  Returns the whole-prefill run's launches."""
    import torch

    from repro_torch import configs
    from repro_torch.models import api

    cfg = configs.get_config(OLMOE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    print(f"[olmoe] {cfg.name}: {n_par} parameters ({n_par * 2 / 1e9:.2f} "
          f"GB bf16; {api.active_param_count(cfg)} active a token), init "
          f"{time.perf_counter() - t0:.1f} s")
    launches: dict = {}
    runs = {}
    for chunked in (False, True):
        toks, runs[chunked] = run_engine(cfg, params, chunked=chunked,
                                         launches=launches,
                                         label="olmoe engine")
        runs[chunked]["tokens_by_request"] = toks
    for mode, run in (("whole", runs[False]), ("chunked", runs[True])):
        want = {"paged_attention": {"split_k": run["k1_launches"]}}
        if run["k2_launches"]:
            want["flash_attention"] = {"mma": run["k2_launches"]}
        check(run["routes"] == want, f"olmoe {mode}: launches by route "
              f"{run['routes']}, expected {want} (D = 128)")
    same = sum(runs[False]["tokens_by_request"][i]
               == runs[True]["tokens_by_request"][i]
               for i in runs[False]["tokens_by_request"])
    peak = torch.cuda.max_memory_allocated()
    paths = compare_moe_paths(cfg, params)
    out = {"model": cfg.name, "params": n_par,
           "active_params": api.active_param_count(cfg),
           "tokens_per_s": runs[False]["tokens_per_s"],
           "median_decode_step_ms": runs[False]["median_step_ms"],
           "chunked_tokens_per_s": runs[True]["tokens_per_s"],
           "chunked_median_decode_step_ms": runs[True]["median_step_ms"],
           "whole_vs_chunked_same_tokens": f"{same}/16",
           "prefill_ms": paths["prefill_ms"],
           "prompt_tokens_per_s": paths["prompt_tokens_per_s"],
           "decode_step_device_ms": paths["decode_step"]["device_ms"],
           "decode_step_busy_share":
               paths["decode_step"]["device_busy_share"],
           "max_memory_allocated_bytes": peak,
           "launches": {k: v for k, v in launches["whole"].items() if v},
           "routes": runs[False]["routes"],
           "held_layerwise": paths["held_layerwise"],
           "prefill_end_to_end": paths["prefill_end_to_end"],
           "decode_end_to_end": paths["decode_end_to_end"],
           "card": gpu_name_power()}
    print(f"[serve olmoe] {json.dumps(out)}")
    del params
    torch.cuda.empty_cache()
    return launches["whole"]


def train_olmoe() -> dict:
    """Phase 12b: olmoe-1b-7b at full width, depth cut to 4 layers,
    trained 3 steps (batch 4 x 1024, remat, AdamW lr 3e-4) through
    ``Trainer(comm="single")`` and then through ``Trainer(comm="gspmd")``
    on a 1 x 1 ("data", "model") mesh over NCCL, from the same seed,
    clipping inactive (``NO_CLIP``): on one rank ``tp = 1``, so both take
    JAX's fallback to the global dispatch, and single's kernel pair updates
    as GSPMD's eager update does, so the losses are equal bitwise; each run
    K2 8 and K2-bwd 4 a step exactly (K2 on its ``mma`` route, K2-bwd at
    bf16 D = 128 on its ``wgmma128`` pair), the single run AdamW's pair
    once a step, and nothing else; step ms, tokens/s, busy share, peak
    memory, tokens/s x 6 x the active parameters.  Returns the two runs'
    launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.runtime.trainer import Trainer

    cfg = dataclasses.replace(configs.get_config(OLMOE),
                              n_layers=OLMOE_TRAIN_LAYERS)
    n, L = OLMOE_TRAIN_STEPS, cfg.n_layers
    runs, counts = {}, {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for comm in ("single", "gspmd"):   # both from the seed-0 weights
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr = Trainer(cfg, train_config(
                cfg, f"olmoe_{comm}", batch=OLMOE_TRAIN_BATCH,
                seq_len=OLMOE_TRAIN_SEQ, comm=comm, clip_norm=NO_CLIP),
                mesh=mesh if comm == "gspmd" else None)
            torch.cuda.synchronize()
            reset_counts()             # the main path's run starts here
            ms = tr.train(n)
            torch.cuda.synchronize()
            counts[comm] = read_counts()   # ... and ends here
            routes = read_routes()
            peak = torch.cuda.max_memory_allocated()
            n_par = tr.n_params
            prof = device_profile(tr.train_step, 1)
            step_s = float(np.median([m["step_time_s"] for m in ms]))
            tps = OLMOE_TRAIN_BATCH * OLMOE_TRAIN_SEQ / step_s
            active = api.active_param_count(cfg)
            runs[comm] = {
                "losses": [m["loss"] for m in ms],
                "grad_norms": [m["grad_norm"] for m in ms],
                "step_ms": [m["step_time_s"] * 1e3 for m in ms],
                "median_step_ms": step_s * 1e3, "tokens_per_s": tps,
                "active_flops_per_s": tps * 6 * active,
                "max_memory_allocated_bytes": peak, "routes": routes,
                "device_busy_share": prof["device_busy_share"],
                "device_ms": prof["device_ms"], "step_profile": prof}
            del tr
        dist.barrier()
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    a, b = runs["single"]["losses"], runs["gspmd"]["losses"]
    out = {"layers": L, "params": n_par, "active_params": active,
           "batch": [OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ], "steps": n,
           "mesh": [1, 1], "backend": "nccl", "bitwise": a == b,
           **runs, "card": gpu_name_power()}
    print(f"[train olmoe] {json.dumps(out)}")
    want = dict.fromkeys(counts["single"], 0)
    want["flash_attention"] = 2 * L * n
    want["flash_attention_bwd"] = L * n
    want_routes = {"flash_attention": {"mma": 2 * L * n},
                   "flash_attention_bwd": {"wgmma128": L * n}}
    wants = {"single": ({**want, "fused_adamw": n},
                        {**want_routes, "fused_adamw": {"fused": n}}),
             "gspmd": (want, want_routes)}
    for comm, r in runs.items():
        w, w_routes = wants[comm]
        check(all(np.isfinite(r["losses"])), f"olmoe train {comm}: a loss "
              f"is not finite: {r['losses']}")
        check(counts[comm] == w, f"olmoe train {comm}: launches "
              f"{counts[comm]}, expected {w} (K2 twice a layer a step "
              "under remat, K2-bwd once, AdamW's pair once a single step)")
        check(r["routes"] == w_routes, f"olmoe train {comm}: routes "
              f"{r['routes']}, expected {w_routes}")
    # one rank: tp = 1 takes JAX's fallback to the global dispatch, every
    # collective is the identity and every spec shards nothing
    check(a == b, f"olmoe train: GSPMD's losses {b} differ from single's "
          f"{a}")
    return counts


def moe_phases() -> dict:
    """Phase 12; returns the launches of its main paths: olmoe served
    (a), trained single and GSPMD (b), the reduced olmoe on the card
    (c)."""
    paths = {"olmoe_engine": phase("12a olmoe serving", serve_olmoe)}
    train = phase("12b olmoe training", train_olmoe)
    paths["olmoe_train"] = train["single"]
    paths["olmoe_train_gspmd"] = train["gspmd"]
    paths["reduced_olmoe_serve"] = phase(
        "12c reduced olmoe card vs CPU", compare_with_cpu, OLMOE)
    paths["reduced_olmoe_train"] = phase(
        "12c reduced olmoe training card vs CPU", train_with_cpu, OLMOE, 3)
    return paths


# ----------------------------------------------------------------------------
# phase 13: the dry run (launch/dryrun.py) held against the card
# ----------------------------------------------------------------------------

# 13b: production cells traced on meta, the first with the JAX dry run's
# own bars (tests/test_dryrun.py)
DRYRUN_CELLS = (("smollm-135m", "train_4k", "multipod"),
                ("deepseek-7b", "train_4k", "pod"),
                ("olmoe-1b-7b", "decode_32k", "pod"),
                ("rwkv6-1.6b", "long_500k", "pod"),
                # tensor-parallel serving on the pod (phase 14): split over
                # "model"; the three decode cells fit 80 GB a rank
                ("deepseek-7b", "decode_32k", "pod"),
                ("internvl2-76b", "decode_32k", "pod"),
                ("moonshot-v1-16b-a3b", "decode_32k", "pod"),
                ("qwen2-0.5b", "prefill_32k", "pod"),
                ("deepseek-7b", "prefill_32k", "pod"))
# the serving cells the rank programs must split, and those that must fit
SERVE_TP_CELLS = {c for c in DRYRUN_CELLS if c[1] != "train_4k"
                  and c[0] != "rwkv6-1.6b"}
SERVE_TP_FIT = {c for c in SERVE_TP_CELLS if c[1] == "decode_32k"}
# 13c: the single-device examples and the kernels each must launch
EXAMPLES = {"quickstart_torch.py": ("flash_attention", "flash_attention_bwd"),
            "paged_serving_torch.py": ("paged_attention", "flash_attention"),
            "cluster_serving_torch.py": ("paged_attention",
                                         "flash_attention")}


def dryrun_vs_card(tag: str, cfg, batch: int, seq: int) -> dict:
    """Phase 13a: one training step of ``cfg`` (batch x seq, remat, AdamW)
    through the GSPMD trainer's rank program on a 1 x 1 mesh (an abstract
    one: on one rank every collective is the identity), traced on meta and
    then run on the card, each inside the analyzer
    (``launch/op_analysis.py``).  Holds: the FLOPs equal as integers; each
    kernel's reported launches equal to its launch counter on the card
    (and to meta's); the roofline's max(compute, memory) at most the
    step's measured device time; the predicted peak live bytes within
    [0.5, 2] of the card's (its growth above the step's arguments, plus
    the arguments).  Prints the ratio, the device ms, the roofline terms
    and tokens/s x 6 x the active parameters over the bf16 peak."""
    import gc

    import torch

    from repro_torch.core import hw
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import api

    mesh = Mesh((1, 1), ("data", "model"), [0], abstract_rank=0)
    shape = api.ShapeCfg(tag, seq, batch, "train")
    variant = dryrun.Variant(name="card", remat=True)
    step, args, _ = dryrun.build_train(cfg, mesh, variant)(shape)
    meta, t_trace = dryrun.analyze_step(step, args)
    del step, args
    terms = dryrun.roofline(meta.flops, meta.bytes, meta.link_bytes)
    gc.collect()
    torch.cuda.empty_cache()
    step, args, _ = dryrun.build_train(cfg, mesh, variant,
                                       device="cuda")(shape)
    step()                             # warm: set-up is not the step's
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    card, t_card = dryrun.analyze_step(step, args)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    counts = read_counts()
    launched = {n: counts[n] + counts[f"{n}_small"] for n in kernel_wrappers()
                if counts[n] + counts[f"{n}_small"]}
    prof = device_profile(step, 1)
    del step, args
    gc.collect()
    torch.cuda.empty_cache()
    measured_peak = card.arg_bytes + grew
    device_ms = prof["device_ms"]
    roof_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    tps = batch * seq / (prof["step_wall_ms"] / 1e3)
    active = api.active_param_count(cfg)
    out = {"model": cfg.name, "layers": cfg.n_layers, "batch": [batch, seq],
           "flops_meta": meta.flops, "flops_card": card.flops,
           "bytes_meta": meta.bytes, "bytes_card": card.bytes,
           "kernels_meta": meta.kernels, "kernels_card": card.kernels,
           "launch_counters": launched,
           "roofline": terms, "roofline_ms": roof_ms,
           "device_ms": device_ms, "step_wall_ms": prof["step_wall_ms"],
           "device_busy_share": prof["device_busy_share"],
           "roofline_share_of_device_ms": roof_ms / device_ms,
           "peak_predicted_bytes": meta.peak_live_bytes,
           "peak_card_analyzer_bytes": card.peak_live_bytes,
           "peak_measured_bytes": measured_peak,
           "peak_ratio": meta.peak_live_bytes / measured_peak,
           "arg_bytes": meta.arg_bytes, "active_params": active,
           "active_flops_share_of_peak":
               tps * 6 * active / hw.H100_SXM.peak_flops_bf16,
           "t_trace_meta_s": t_trace, "t_analyzed_step_card_s": t_card,
           "card": gpu_name_power()}
    print(f"[dryrun vs card] {json.dumps(out)}")
    check(meta.flops == card.flops, f"13a {tag}: FLOPs on meta "
          f"{meta.flops} differ from the card's {card.flops}")
    for name in set(launched) | set(card.kernels) | set(meta.kernels):
        n = launched.get(name, 0)
        check(card.kernels.get(name, {}).get("count", 0) == n
              and meta.kernels.get(name, {}).get("count", 0) == n,
              f"13a {tag}: {name} launched {n} times, reported "
              f"{card.kernels.get(name)} on the card, "
              f"{meta.kernels.get(name)} on meta")
    check(roof_ms <= device_ms, f"13a {tag}: the roofline ({roof_ms:.2f} "
          f"ms) exceeds the measured device time ({device_ms:.2f} ms)")
    check(0.5 <= out["peak_ratio"] <= 2.0, f"13a {tag}: predicted peak "
          f"{meta.peak_live_bytes} is {out['peak_ratio']:.3f} of the "
          f"measured {measured_peak}")
    return out


def dryrun_cells() -> dict:
    """Phase 13b: production cells traced on meta (the CPU's work: nothing
    is allocated); the smollm multipod cell held to the JAX dry run's bars
    (``tests/test_dryrun.py``)."""
    from repro_torch.launch import dryrun

    out = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        r = dryrun.run_cell(arch, shape, mesh, dryrun.get_variant("baseline"))
        mem = r["memory_analysis"]
        out[f"{arch} {shape} {mesh}"] = row = {
            "flops_per_device": r["flops_per_device"],
            "bytes_per_device": r["bytes_per_device"],
            "link_bytes_per_device": r["link_bytes_per_device"],
            "live_bytes_per_device": mem["live_bytes_per_device"],
            "fits_hbm": mem["fits_hbm"], "partitioned": r["partitioned"],
            "bottleneck": r["roofline"]["bottleneck"],
            "roofline": r["roofline"],
            "useful_flop_ratio_attn": r["useful_flop_ratio_attn"],
            "t_trace_s": r["t_trace_s"]}
        print(f"[dryrun cell] {arch} {shape} {mesh}: {json.dumps(row)}")
        if (arch, mesh) == ("smollm-135m", "multipod"):
            check(r["chips"] == 512 and r["flops_per_device"] > 0
                  and r["link_bytes_per_device"] > 0
                  and r["roofline"]["bottleneck"] in (
                      "compute_s", "memory_s", "collective_s")
                  and 0.01 <= r["useful_flop_ratio_attn"] <= 3.0
                  and r["useful_flop_ratio"] <= r["useful_flop_ratio_attn"]
                  and "live_bytes_per_device" in mem,
                  f"13b: the smollm multipod cell misses the dry run's "
                  f"bars: {row}")
        if (arch, shape, mesh) in SERVE_TP_CELLS:
            check(r["partitioned"] and (
                mem["fits_hbm"] or (arch, shape, mesh) not in SERVE_TP_FIT),
                f"13b: {arch} {shape} {mesh} is not split over 'model', "
                f"or does not fit: {row}")
    return out


def run_examples() -> dict:
    """Phase 13c: the single-device examples on the card, each in a
    process of its own: each exits 0 and launches the kernels it must."""
    out = {}
    for name, must in EXAMPLES.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                           capture_output=True, text=True, timeout=600,
                           cwd=ROOT)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"13c {name} exited {r.returncode}: "
              f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
        line = next(ln for ln in r.stdout.splitlines()
                    if ln.startswith("kernel launches:"))
        counts = json.loads(line.split(":", 1)[1])
        print(f"[example] {name} ({wall:.1f} s):")
        for ln in r.stdout.strip().splitlines():
            print(f"    {ln}")
        check(all(counts[k] > 0 for k in must), f"13c {name}: a kernel it "
              f"must run never launched: {counts}")
        out[name] = {"wall_s": wall,
                     "launches": {k: v for k, v in counts.items() if v}}
    return out


def autotune_phase() -> dict:
    """Phase 13d: one short fabric-autotuner search on the host
    (``serving_replay(16)``, the genetic agent, 12 steps, seed 0):
    printed only."""
    from repro_torch.core import fabric

    env = fabric.FabricEnv(fabric.ConfigSpace(16), fabric.serving_replay(16))
    t0 = time.perf_counter()
    res = fabric.search(env, fabric.GeneticAgent(), steps=12, seed=0)
    out = {"wall_s": time.perf_counter() - t0,
           "best_objective_ms": res.best_objective_s * 1e3,
           "winner": res.best_config.to_jsonable()}
    print(f"[autotune] {json.dumps(out)}")
    return out


def dryrun_phases() -> dict:
    """Phase 13: (a) the dry run held against the card for qwen2-0.5b at
    phase 9's training shape and olmoe-1b-7b at phase 12b's (4 layers),
    with the active-parameter count checked against the per-layer
    arithmetic at 16 and 4 layers; (b) production cells on meta; (c) the
    single-device examples on the card; (d) an autotuner search."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api

    olmoe = configs.get_config(OLMOE)
    for L in (olmoe.n_layers, OLMOE_TRAIN_LAYERS):
        c = dataclasses.replace(olmoe, n_layers=L)
        m = c.moe
        by_hand = api.param_count(c) - L * (m.n_experts - m.top_k) \
            * 3 * c.d_model * m.d_expert
        check(api.active_param_count(c) == by_hand, f"13a: olmoe at {L} "
              f"layers: {api.active_param_count(c)} active parameters, "
              f"{by_hand} by the per-layer arithmetic")
        print(f"[dryrun vs card] olmoe at {L} layers: {by_hand} active "
              "parameters both ways")
    out = {"qwen2": phase("13a qwen2 dry run vs card", dryrun_vs_card,
                          "qwen2_train", configs.get_config("qwen2-0.5b"),
                          TRAIN_BATCH, TRAIN_SEQ),
           "olmoe": phase("13a olmoe dry run vs card", dryrun_vs_card,
                          "olmoe_train", dataclasses.replace(
                              olmoe, n_layers=OLMOE_TRAIN_LAYERS),
                          OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ)}
    out["cells"] = phase("13b production cells on meta", dryrun_cells)
    out["examples"] = phase("13c examples on the card", run_examples)
    out["autotune"] = phase("13d autotuner search", autotune_phase)
    return out


# ----------------------------------------------------------------------------
# phase 14: tensor-parallel serving (models/transformer.py's rank programs)
# ----------------------------------------------------------------------------

SERVE_TP_MODELS = ("qwen2-0.5b", OLMOE)
SERVE_TP_BATCH, SERVE_TP_PROMPT, SERVE_TP_STEPS = 8, 1024, 32
# 14b: internvl2-76b decode_32k's rank on the pod ("seq" layout: batch 128
# over 16 "data" ranks, the 32768-deep sequence over 16 "model" ranks)
SEQ_ROWS, SEQ_DEPTH, SEQ_SLICES = 8, 32768, 16
# 14c: deepseek-7b prefill_32k's rank on the pod ("heads": 32 rows over 16
# "data" ranks, 32 heads over 16 "model" ranks)
K2_RANK = dict(B=2, H=2, D=128)


def serve_tp_model(name: str, mesh) -> dict:
    """Phase 14a for one model at full width and depth, bf16, seeded
    weights: 8 prompts of 1024 tokens prefilled, then 32 greedy decode
    steps through ``api.get_model(cfg).prefill`` / ``decode_step``, with
    no mesh and then under ``mesh`` (1 x 1, NCCL) with the parameters cut
    by ``param_specs`` and the rows by ``batch_specs``, as a rank of a
    partitioned server: tokens and logits equal bitwise, K2 exactly L
    launches a prefill, each path's decode step ms and busy share.  On
    a "model" axis of one rank ``prefill`` and ``decode_step`` take the
    plain path: the two runs are one code path, and their decode walls
    its spread.  Returns the mesh run's launches."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api, transformer
    from repro_torch.parallel import sharding
    from repro_torch.runtime.trainer import shard_params

    cfg = configs.get_config(name)
    model = api.get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_TP_BATCH, SERVE_TP_PROMPT))).cuda()
    P, L = SERVE_TP_PROMPT, cfg.n_layers
    runs, launches = {}, None
    for path in ("plain", "mesh"):
        pspec = tspec = None
        if path == "mesh":
            shard_params(cfg, params, mesh)
            pspec = sharding.batch_specs(cfg, {"t": tokens}, mesh)["t"]
            tspec = sharding.batch_specs(transformer.serving_cfg(cfg), {
                "t": tokens[:, :1]}, mesh)["t"]
        torch.cuda.empty_cache()
        sharding.set_runtime_mesh(mesh if pspec else None, pspec)
        try:
            with torch.no_grad():
                reset_counts()
                t0 = time.perf_counter()
                logits, cache = model.prefill(params, {"tokens": tokens},
                                              max_len=P + SERVE_TP_STEPS)
                torch.cuda.synchronize()
                prefill_ms = (time.perf_counter() - t0) * 1e3
                k2 = read_counts()["flash_attention"]
                sharding.set_runtime_mesh(mesh if pspec else None, tspec)
                lgs, toks = [logits], []
                t0 = time.perf_counter()
                for i in range(SERVE_TP_STEPS):
                    t = lgs[-1][:, -1].argmax(-1, keepdim=True)
                    toks.append(t)
                    logits, cache = model.decode_step(params, t, cache,
                                                      P + i)
                    lgs.append(logits)
                torch.cuda.synchronize()
                decode_ms = (time.perf_counter() - t0) * 1e3 / SERVE_TP_STEPS
                counts = read_counts()
                # the last step again (it rewrites its own row)
                prof = device_profile(lambda: model.decode_step(
                    params, toks[-1], cache, P + SERVE_TP_STEPS - 1), 3)
        finally:
            sharding.set_runtime_mesh(None)
        runs[path] = {"logits": torch.cat(lgs, 1), "tokens": torch.cat(
            toks, 1), "k2_prefill": k2, "prefill_ms": prefill_ms,
            "decode_step_ms": decode_ms,
            "decode_step_wall_ms": prof["step_wall_ms"],
            "decode_device_ms": prof["device_ms"],
            "decode_busy_share": prof["device_busy_share"]}
        if path == "mesh":
            launches = counts
        del cache
    a, b = runs["plain"], runs["mesh"]
    same_tokens = torch.equal(a["tokens"], b["tokens"])
    same_logits = torch.equal(a["logits"], b["logits"])
    out = {"model": name, "layers": L, "mesh": [1, 1], "backend": "nccl",
           "batch": SERVE_TP_BATCH, "prompt": P, "steps": SERVE_TP_STEPS,
           "tokens_equal": same_tokens, "logits_bitwise": same_logits,
           "finite": bool(torch.isfinite(b["logits"]).all()),
           "launches": {k: v for k, v in launches.items() if v},
           "card": gpu_name_power(),
           "paths": {p: {k: v for k, v in r.items()
                         if k not in ("logits", "tokens")}
                     for p, r in runs.items()}}
    print(f"[serve tp] {json.dumps(out)}")
    check(out["finite"], f"14a {name}: a logit is not finite")
    check(same_tokens and same_logits, f"14a {name}: the 1 x 1 mesh's "
          "tokens or logits differ from the plain path's")
    check(a["k2_prefill"] == b["k2_prefill"] == L, f"14a {name}: K2 "
          f"launched {a['k2_prefill']} / {b['k2_prefill']} times a "
          f"prefill, not {L}")
    del params
    torch.cuda.empty_cache()
    return launches


def serve_tp_entry_points() -> dict:
    """Phase 14a: qwen2-0.5b and olmoe-1b-7b served through the entry
    points with no mesh and on a 1 x 1 ("data", "model") mesh over NCCL
    (world size 1: one card cannot host two NCCL ranks)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        paths = {f"{n}_serve_tp": serve_tp_model(n, mesh)
                 for n in SERVE_TP_MODELS}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return paths


def seq_combine_check() -> dict:
    """Phase 14b: the "seq" layout's combine at internvl2-76b's decode_32k
    rank shape (8 rows, 64 heads and 8 KV heads of 128, bf16): the 16 key
    slices' partials of a 32768-deep cache (``attention.decode_partials``)
    combined by ``attention.combine_partials``, against the whole
    sequence's attention (``attention.attend_decode``, what ``attn_decode``
    runs), with pos inside the first slice (15 slices empty) and at the
    end, at phase 2's bf16 bar."""
    import torch

    from repro_torch import configs
    from repro_torch.models import attention

    cfg = configs.get_config("internvl2-76b")
    B, H, Hkv, D = SEQ_ROWS, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(B, SEQ_DEPTH, Hkv, D, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    n = SEQ_DEPTH // SEQ_SLICES
    out = {"shape": {"B": B, "H": H, "Hkv": Hkv, "D": D, "S": SEQ_DEPTH,
                     "slices": SEQ_SLICES}, "attn_dtype": cfg.attn_dtype}
    for pos in (n // 2, SEQ_DEPTH - 1):
        visible = torch.arange(SEQ_DEPTH, device="cuda") <= pos
        with torch.no_grad():
            whole = attention.attend_decode(cfg, q, k, v, visible)

            def split():
                parts = [attention.decode_partials(
                    cfg, q, k[:, i:i + n], v[:, i:i + n], visible[i:i + n])
                    for i in range(0, SEQ_DEPTH, n)]
                return attention.combine_partials(
                    *(torch.stack(t) for t in zip(*parts)))

            got = split()
            torch.cuda.synchronize()
            row = {"max_abs_err": max_err(got, whole),
                   "err_over_tol": tol_ratio(got, whole, BF16_TOL),
                   "finite": bool(torch.isfinite(got).all()),
                   "empty_slices": int(sum(i > pos for i in
                                           range(0, SEQ_DEPTH, n))),
                   "ms_whole": time_ms(lambda: attention.attend_decode(
                       cfg, q, k, v, visible), iters=5, warmup=1),
                   "ms_slices_and_combine": time_ms(split, iters=5,
                                                    warmup=1)}
        out[f"pos_{pos}"] = row
        print(f"[seq combine] pos {pos}: {json.dumps(row)}")
        check(row["finite"] and row["err_over_tol"] <= 1, f"14b: the "
              f"combine at pos {pos} is off its bar: {row}")
    out["card"] = gpu_name_power()
    return out


def k2_rank_shape(report: dict) -> dict:
    """Phase 14c: K2 at a head-parallel rank's shape, deepseek-7b
    prefill_32k on the pod (2 rows, 2 of its 32 heads of 128, causal):
    held to its plain version at S = 4096 in both compute dtypes, timed
    (eager and graph-replayed) at S = 32768 beside SDPA; the times join
    K2's report (``*_deepseek_rank_s32k``)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, H, D = K2_RANK["B"], K2_RANK["H"], K2_RANK["D"]

    def qkv(S):
        g = torch.Generator(device="cuda").manual_seed(S)
        return tuple(torch.randn(B, H, S, D, generator=g, device="cuda")
                     .to(torch.bfloat16) for _ in range(3))

    q, k, v = qkv(4096)
    out = {}
    for cdt in (torch.float32, torch.bfloat16):
        got = fa.flash_attention(q, k, v, causal=True, compute_dtype=cdt)
        want = ref.mha_attention(q, k, v, causal=True, compute_dtype=cdt)
        tol = BF16_TOL
        if cdt == torch.bfloat16:         # see BF16_COMPUTE_PV
            pv = ref.mha_attention(q, k, v.abs(), causal=True,
                                   compute_dtype=cdt).float()
            tol = (BF16_COMPUTE_REL, BF16_COMPUTE_PV * pv + 1e-5)
        torch.cuda.synchronize()
        tag = "fp32" if cdt == torch.float32 else "bf16"
        out[f"err_over_tol_{tag}"] = s = tol_ratio(got, want, tol)
        out[f"max_abs_err_{tag}"] = max_err(got, want)
        print(f"[K2 rank shape] deepseek B={B} H=Hkv={H} S=4096 D={D} "
              f"compute {tag}: max_abs_err={out[f'max_abs_err_{tag}']:.3e} "
              f"err/tol={s:.3f}")
        check(s <= 1, f"14c: K2 at deepseek's rank shape (compute {tag}) "
              "disagrees with its plain version")
    del q, k, v, got, want
    torch.cuda.empty_cache()
    times = k2_shape_times("deepseek_rank_s32k", *qkv(32768), True)
    # and 14a's prefill shapes (8 x 1024, causal), for the ranking
    for name in SERVE_TP_MODELS:
        cfg = configs.get_config(name)
        g = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn(SERVE_TP_BATCH, h, SERVE_TP_PROMPT,
                               cfg.resolved_head_dim, generator=g,
                               device="cuda").to(torch.bfloat16)
                   for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        times.update(k2_shape_times(f"{name}_serve_tp", q, k, v, True))
    report["flash_attention"].update(times)
    out.update(times)
    out["card"] = gpu_name_power()
    torch.cuda.empty_cache()
    return out


def dryrun_decode_vs_card() -> dict:
    """Phase 14d: 13a extended by one serving cell, qwen2-0.5b's decode
    step (batch 8 against a 1056-deep cache) on a 1 x 1 mesh, traced on
    meta and run on the card inside the analyzer: FLOPs equal as
    integers."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import api

    cfg = configs.get_config("qwen2-0.5b")
    mesh = Mesh((1, 1), ("data", "model"), [0], abstract_rank=0)
    shape = api.ShapeCfg("qwen2_decode", SERVE_TP_PROMPT + SERVE_TP_STEPS,
                         SERVE_TP_BATCH, "decode")
    variant = dryrun.get_variant("production")
    step, args, _ = dryrun.build_decode(cfg, mesh, variant)(shape)
    meta, _ = dryrun.analyze_step(step, args)
    del step, args
    step, args, _ = dryrun.build_decode(cfg, mesh, variant,
                                        device="cuda")(shape)
    step()                                  # warm
    torch.cuda.synchronize()
    card, _ = dryrun.analyze_step(step, args)
    torch.cuda.synchronize()
    del step, args
    torch.cuda.empty_cache()
    out = {"model": cfg.name, "batch": SERVE_TP_BATCH,
           "depth": shape.seq_len, "flops_meta": meta.flops,
           "flops_card": card.flops, "bytes_meta": meta.bytes,
           "bytes_card": card.bytes, "peak_predicted_bytes":
               meta.peak_live_bytes, "card": gpu_name_power()}
    print(f"[dryrun decode vs card] {json.dumps(out)}")
    check(meta.flops == card.flops, f"14d: the decode step's FLOPs on "
          f"meta {meta.flops} differ from the card's {card.flops}")
    return out


def serve_tp_phases(report: dict) -> dict:
    """Phase 14; returns the launches of 14a's main paths."""
    paths = phase("14a serve tp entry points", serve_tp_entry_points)
    phase("14b seq combine", seq_combine_check)
    phase("14c K2 at a head-parallel rank", k2_rank_shape, report)
    phase("14d dry run decode vs card", dryrun_decode_vs_card)
    return paths


# ----------------------------------------------------------------------------
# phase 15: partitioned serving of the recurrent families (the rank programs
# of models/rwkv.py, ssm.py and hybrid.py) and K4's split-key route
# ----------------------------------------------------------------------------

REC_TP_MODELS = ("rwkv6-1.6b", "zamba2-1.2b")
# 15a: rwkv6-1.6b decode_32k's rank on the pod: 128 rows over 16 "data"
# ranks, the wkv state's 64 keys of each of 32 heads over 16 "model" ranks
SPLIT_POD = dict(B=8, H=32, dk=4, dv=64)
# 15b: a prefill rank's heads on the pod (16 "model" ranks): rwkv6 2 of its
# 32 wkv heads, zamba2 4 of its 64 SSM heads, at phase 5's prompts; beside
# the whole heads
REC_RANK_HEADS = {"rwkv6_scan": (2, 32), "mamba2_scan": (4, 64)}
# 15c: phase 5's prompts (4 x 1024) and REC_TP_STEPS greedy steps.  15d:
# the rank programs run whole on REC_RANKS gloo ranks (processes) sharing
# the card, mesh (1, REC_RANKS), 4 prompts cut to REC_TP_PROMPT tokens
# (gloo stages every collective's parts in host memory, and a prefill's
# gathers grow with the prompt), REC_TP_STEPS decode steps fed the plain
# path's greedy tokens (a full run's 15d took 138.5 s at 8 steps, 2.4 s
# a rank's decode step)
REC_RANKS, REC_TP_PROMPT, REC_TP_STEPS = 4, 256, 4
# 15d's bf16 logits at full depth with random weights are chaotic: the
# bf16 plain path itself is 0.67 (rwkv6) and 2.05 (zamba2) from the fp32
# truth at |logit| ~5 (H100), so the 3x bar cannot tell a fault.  The
# models are also run REC_TP_CUT_LAYERS deep (zamba2: one shared block)
# and held there besides: the bf16 rank program nearer the bf16 plain
# path than that path is to the truth (partitioning moves the logits
# less than bf16 rounding does; H100: 0.148 vs 0.212, 0.180 vs 0.738).
REC_TP_CUT_LAYERS = 6


def split_route_checks(report: dict) -> dict:
    """Phase 15a: K4's split-key route (``rw.rwkv6_scan_split``) at the
    pod rank's decode shape (8 rows, 32 heads, 4 of 64 keys, fp32 state),
    in fp32 and bf16: each of the 16 key slices held to its plain version
    (``ref.rwkv6_scan_split``; fp32 outputs, FP32_TOL), and the sum of
    the 16 slices' readout parts held to K4's full-state S = 1 route
    (``rwkv6_scan_decode_kernel``) at phase 2's bars, the slices' state
    rows to its state.  Timed in bf16 (``ms``, ``ms_graph``) beside the
    plain version, the bound from ``cost.rwkv6_scan_split`` and the full
    route at the same rows and heads; also at 15d's rank shape (4 rows,
    16 of 64 keys: ``*_ranks``)."""
    import torch

    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import rwkv6_scan as rw

    B, H, dk, dv = (SPLIT_POD[k] for k in ("B", "H", "dk", "dv"))
    errs, out = [], {"shape": dict(SPLIT_POD)}

    def slices(r, k, v, w, u, s0, dk):
        for i in range(dv // dk):
            keys = slice(i * dk, (i + 1) * dk)
            yield (r[..., keys].contiguous(), k[..., keys].contiguous(), v,
                   w[..., keys].contiguous(), u[:, keys].contiguous(),
                   s0[:, :, keys].contiguous())

    for dtype in (torch.float32, torch.bfloat16):
        case = rwkv_case(B, 1, H, dtype, s0=True, seed=50)
        y_full, s_full = rw.rwkv6_scan(*case[:5], s0=case[5],
                                       return_state=True)
        check(rw.rwkv6_scan.last_kernel == "rwkv6_scan_decode_kernel",
              f"15a: the full-state step took {rw.rwkv6_scan.last_kernel}")
        ys, ss, worst = [], [], 0.0
        for i, args in enumerate(slices(*case, dk)):
            n0 = rw.rwkv6_scan_split.launches
            y, st = rw.rwkv6_scan_split(*args)
            check(rw.rwkv6_scan_split.launches == n0 + 1,
                  "15a: the split route did not count its launch")
            y_w, s_w = ref.rwkv6_scan_split(*args)
            torch.cuda.synchronize()
            ratio = max(tol_ratio(y, y_w, FP32_TOL),
                        tol_ratio(st, s_w, FP32_TOL))
            errs.append(max(max_err(y, y_w), max_err(st, s_w)))
            worst = max(worst, ratio)
            check(ratio <= 1, f"15a: key slice {i} ({dtype}) disagrees "
                  f"with its plain version: err/tol {ratio:.3f}")
            ys.append(y)
            ss.append(st)
        summed = sum(ys).to(dtype)
        tol = FP32_TOL if dtype == torch.float32 else scan_tol(
            y_full, SCAN_OUT_REL, SCAN_OUT_ABS)
        states = torch.cat(ss, 2)
        row = {"slices_err_over_tol": worst,
               "sum_vs_full_max_abs_err": max_err(summed, y_full),
               "sum_vs_full_err_over_tol": tol_ratio(summed, y_full, tol),
               "state_vs_full_max_abs_err": max_err(states, s_full),
               "state_bitwise_full": bool(torch.equal(states, s_full))}
        tag = "fp32" if dtype == torch.float32 else "bf16"
        out[tag] = row
        print(f"[split route] {tag}: {json.dumps(row)}")
        check(row["sum_vs_full_err_over_tol"] <= 1
              and tol_ratio(states, s_full, FP32_TOL) <= 1,
              f"15a: the {dv // dk} slices' sum ({tag}) disagrees with the "
              f"full-state route: {row}")
    # timed in bf16 (the pod's dtype), one slice's inputs
    args = next(slices(*case, dk))
    split = lambda: rw.rwkv6_scan_split(*args)          # noqa: E731
    full = lambda: rw.rwkv6_scan(*case[:5], s0=case[5],  # noqa: E731
                                 return_state=True)
    flops, nbytes = cost.rwkv6_scan_split(B, H, dk, dv, 2)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    res = dict(name="rwkv6_scan_split", route="cuda",
               source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
               replaces="src/repro/kernels/rwkv6_scan.py:59",
               max_abs_err=max(errs), ms=time_ms(split, iters=50),
               ms_graph=time_graph_ms(split),
               plain_ms=time_ms(lambda: ref.rwkv6_scan_split(*args),
                                iters=50),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               shape=f"B={B} H={H} dk={dk} dv={dv} bf16, fp32 state in and "
                     "out",
               ms_full_route=time_ms(full, iters=50),
               ms_graph_full_route=time_graph_ms(full))
    # 15d's rank shape: phase 5's 4 rows, 32 heads, 64 / REC_RANKS keys
    case = rwkv_case(N_PROMPTS, 1, H, torch.bfloat16, s0=True, seed=51)
    args_r = next(slices(*case, dv // REC_RANKS))
    ranks = lambda: rw.rwkv6_scan_split(*args_r)        # noqa: E731
    flops, nbytes = cost.rwkv6_scan_split(N_PROMPTS, H, dv // REC_RANKS,
                                          dv, 2)
    res.update(ms_ranks=time_ms(ranks, iters=50),
               ms_graph_ranks=time_graph_ms(ranks),
               bound_ms_ranks=bound(nbytes, flops, torch.bfloat16)[0])
    res["kernel_ms"] = res["ms"]
    print(f"[rwkv6_scan_split] ms={res['ms']:.5f} ms_graph="
          f"{res['ms_graph']:.5f} plain_ms={res['plain_ms']:.4f} bound_ms="
          f"{b_ms:.6f} ({b_by}); full route ms={res['ms_full_route']:.5f} "
          f"ms_graph={res['ms_graph_full_route']:.5f}; library: none (no "
          "single PyTorch call computes the step)")
    report["rwkv6_scan_split"] = res
    out["card"] = gpu_name_power()
    return out


def prefill_rank_heads(report: dict) -> dict:
    """Phase 15b: K4 and K3 at a prefill rank's heads on the pod (rwkv6 2
    of 32 wkv heads, zamba2 4 of 64 SSM heads, x / B / C the mixer's
    strided views) and at the whole heads, phase 5's 4 x 1024 prompts,
    bf16, state out: each held to its plain version at phase 2's scan
    bars, timed (``ms``, ``ms_graph``) beside its bound.  The rank's rows
    join K4's and K3's reports (``*_prefill_rank``)."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rw

    bf, out = torch.bfloat16, {}
    for name, heads in REC_RANK_HEADS.items():
        for H in heads:
            if name == "rwkv6_scan":
                r, k, v, w, u, _ = rwkv_case(N_PROMPTS, PROMPT_LEN, H, bf,
                                             s0=False, seed=60 + H)
                fn = lambda: rw.rwkv6_scan(r, k, v, w, u,  # noqa: E731
                                           return_state=True)
                plain = lambda: ref.rwkv6_scan_chunked(  # noqa: E731
                    r, k, v, w, u, return_state=True)
                flops, nbytes = cost.rwkv6_scan(N_PROMPTS, PROMPT_LEN, H,
                                                64, 2, state_in=False)
            else:
                x, dt, A, Bm, Cm, D, _ = mixer_views(mamba_case(
                    N_PROMPTS, PROMPT_LEN, H, bf, h0=False, seed=70 + H))
                fn = lambda: m2.mamba2_scan(  # noqa: E731
                    x, dt, A, Bm, Cm, D, return_state=True)
                plain = lambda: ref.mamba2_scan_chunked(  # noqa: E731
                    x, dt, A, Bm, Cm, D, return_state=True)
                flops, nbytes = cost.mamba2_scan(N_PROMPTS, PROMPT_LEN, H,
                                                 64, 64, 2, state_in=False)
            (gy, gs), (wy, ws) = fn(), plain()
            torch.cuda.synchronize()
            ry = tol_ratio(gy, wy, scan_tol(wy, SCAN_OUT_REL, SCAN_OUT_ABS))
            rs = tol_ratio(gs, ws, scan_tol(ws, SCAN_STATE_REL,
                                            SCAN_STATE_ABS))
            b_ms, b_by = bound(nbytes, flops, bf)
            row = {"heads": H, "err_over_tol_out": ry,
                   "err_over_tol_state": rs, "max_abs_err": max_err(gy, wy),
                   "ms": time_ms(fn), "ms_graph": time_graph_ms(fn, iters=20),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "kernel": (rw.rwkv6_scan if name == "rwkv6_scan"
                              else m2.mamba2_scan).last_kernel}
            out[f"{name}_{H}h"] = row
            print(f"[rank heads] {name} B={N_PROMPTS} S={PROMPT_LEN} H={H} "
                  f"bf16: {json.dumps(row)}")
            check(ry <= 1 and rs <= 1, f"15b: {name} at {H} heads "
                  f"disagrees with its plain version: {row}")
            if H == heads[0]:
                report[name].update({"ms_prefill_rank": row["ms"],
                                     "ms_graph_prefill_rank": row["ms_graph"],
                                     "bound_ms_prefill_rank": b_ms,
                                     "heads_prefill_rank": H})
    out["card"] = gpu_name_power()
    return out


def rec_model(name: str, dtype=None, prompt: int = PROMPT_LEN,
              layers: int | None = None):
    """(cfg, model, seeded params on the card, phase 5's prompts cut to
    ``prompt`` tokens, the prefill's keywords) for ``name`` at full width
    and depth (or ``layers`` deep), in ``dtype`` (default the
    config's)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    cfg = configs.get_config(name)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = api.get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(N_PROMPTS, PROMPT_LEN))[:, :prompt]).cuda()
    kw = ({"max_len": prompt + REC_TP_STEPS}
          if cfg.family == "zamba2" else {})
    return cfg, model, params, tokens, kw


def serve_steps(model, params, batch, kw, steps, feed=None, *, mesh=None,
                cfg=None):
    """Prefill ``batch`` (the prefill's keywords ``kw``) and take ``steps``
    decode steps (fed ``feed``, the tokens to decode, else greedy); under
    ``mesh`` as its rank, the rows cut by ``batch_specs``.  Returns (the
    logits of every step (B, 1 + steps, V), the tokens decoded, the final
    state, prefill ms, decode ms a step)."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.parallel import sharding, spmd
    P = batch["tokens"].shape[1]
    pspec = tspec = None
    if mesh is not None:
        bspec = sharding.batch_specs(cfg, batch, mesh)
        tspec = sharding.batch_specs(transformer.serving_cfg(cfg), {
            "t": batch["tokens"][:, :1]}, mesh)["t"]
        batch = {k: spmd.shard(v, bspec[k], mesh) for k, v in batch.items()}
        pspec = bspec["tokens"]
    sharding.set_runtime_mesh(mesh, pspec)
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, state = model.prefill(params, batch, **kw)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
            sharding.set_runtime_mesh(mesh, tspec)
            lgs, toks = [logits[:, -1]], []
            t0 = time.perf_counter()
            for i in range(steps):
                t = lgs[-1].argmax(-1)[:, None] if feed is None \
                    else feed[:, i:i + 1]
                toks.append(t)
                logits, state = model.decode_step(params, t, state, P + i)
                lgs.append(logits[:, -1])
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        sharding.set_runtime_mesh(None)
    return (torch.stack(lgs, 1), torch.cat(toks, 1), state, pre_ms,
            dec_ms)


def rec_serve(model, params, tokens, kw, feed=None, *, mesh=None, cfg=None):
    """``serve_steps`` of ``tokens`` for REC_TP_STEPS decode steps."""
    return serve_steps(model, params, {"tokens": tokens}, kw, REC_TP_STEPS,
                       feed, mesh=mesh, cfg=cfg)


def rec_tp_one_rank() -> dict:
    """Phase 15c, a gate: rwkv6-1.6b and zamba2-1.2b through the entry
    points with no mesh and on a 1 x 1 ("data", "model") mesh over NCCL
    (world size 1), the parameters cut by ``param_specs``: logits and
    tokens bitwise the plain path's (a "model" line of one rank runs the
    plain path: no rank program)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.trainer import shard_params

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for name in REC_TP_MODELS:
            cfg, model, params, tokens, kw = rec_model(name)
            a = rec_serve(model, params, tokens, kw)
            shard_params(cfg, params, mesh)
            b = rec_serve(model, params, tokens, kw, mesh=mesh, cfg=cfg)
            out[name] = {"logits_bitwise": bool(torch.equal(a[0], b[0])),
                         "tokens_equal": bool(torch.equal(a[1], b[1]))}
            print(f"[rec tp 1x1] {name}: {json.dumps(out[name])}")
            check(out[name]["logits_bitwise"] and out[name]["tokens_equal"],
                  f"15c {name}: the 1 x 1 mesh's logits or tokens differ "
                  "from the plain path's")
            del params, a, b
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def rec_tp_runs(name: str, mesh, layers: int | None = None) -> dict:
    """15d's runs of one model on this rank: the seed's bf16 weights, and
    the same values in fp32; the fp32 plain path (the truth) decodes
    greedily, and every other run is fed its tokens: the bf16 plain path,
    then, with the parameters cut by ``param_specs``, the fp32 rank
    program (at full depth) and the bf16 one through the entry points.
    At full depth (``layers`` None) the bf16 rank run is the main path:
    its launches counted, every kernel call held to its plain version on
    its own inputs (``held_layerwise``).  Each run's logits against the
    truth's, the rank programs' state shards against
    ``decode_state_specs``."""
    import copy

    import torch

    from repro_torch.models import api
    from repro_torch.parallel import sharding
    from repro_torch.runtime.trainer import shard_params

    main = layers is None
    cfg, model, params, tokens, kw = rec_model(
        name, torch.bfloat16, REC_TP_PROMPT, layers)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = api.get_model(cfg32)
    params32 = copy.deepcopy(params).float()
    truth = rec_serve(model32, params32, tokens, kw)
    feed = truth[1]
    plain = rec_serve(model, params, tokens, kw, feed)
    runs = {}
    if main:
        shard_params(cfg32, params32, mesh)
        runs["fp32"] = rec_serve(model32, params32, tokens, kw, feed,
                                 mesh=mesh, cfg=cfg32)
    del params32
    torch.cuda.empty_cache()
    shard_params(cfg, params, mesh)
    kernels = ("flash_attention", "mamba2_scan", "rwkv6_scan",
               "rwkv6_scan_split")
    if main:
        reset_counts()                       # the main path's run ...
    runs["bf16"], held = held_layerwise(lambda: rec_serve(
        model, params, tokens, kw, feed, mesh=mesh, cfg=cfg),
        kernels if main else ())
    counts = read_counts() if main else None   # ... ends here
    layout = sharding.state_layout(
        cfg, mesh, N_PROMPTS, model.init_decode_state(
            N_PROMPTS, kw.get("max_len"), device="meta"))
    t = truth[0].float()
    top2 = t.topk(2, -1).values
    row = {"layers": cfg.n_layers, "max_abs_logit": float(t.abs().max()),
           "plain_prefill_ms": plain[3], "plain_decode_ms": plain[4]}
    for tag, run in runs.items():
        try:
            sharding.check_state_shards(layout, run[2], mesh)
            shards = True
        except ValueError:
            shards = False
        b = run[0].float()
        row[tag] = {"max_abs_err": max_err(b, t),
                    "argmax_equal_share": float(
                        (b.argmax(-1) == t.argmax(-1)).float().mean()),
                    "finite": bool(torch.isfinite(b).all()),
                    "shards_as_specs": shards,
                    "rank_prefill_ms": run[3], "rank_decode_ms": run[4]}
    bf = row["bf16"]
    bf["plain_max_abs_err"] = max_err(plain[0], t)
    bf["vs_plain_max_abs_err"] = max_err(runs["bf16"][0], plain[0])
    bf["bar"] = max(REC_SPREAD_FACTOR * bf["plain_max_abs_err"], LOGIT_TOL)
    clear = (top2[..., 0] - top2[..., 1]) > 2 * bf["bar"]
    bf["clear_rows"] = int(clear.sum())
    bf["argmax_equal_on_clear_rows"] = bool(
        (runs["bf16"][0].float().argmax(-1) == t.argmax(-1))[clear].all())
    if main:
        bf["held"] = held
        bf["launches"] = counts
    del params, truth, plain, runs
    torch.cuda.empty_cache()
    return row


def rec_tp_rank(rank: int, where: str) -> int:
    """One of 15d's REC_RANKS gloo ranks (a process of its own on the
    card): ``rec_tp_runs`` of each model on mesh (1, REC_RANKS) at full
    depth and REC_TP_CUT_LAYERS deep.  Writes ``rank<r>.json`` under
    ``where``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{where}/store",
                            rank=rank, world_size=REC_RANKS)
    res = {}
    try:
        mesh = make_mesh((1, REC_RANKS), ("data", "model"))
        for name in REC_TP_MODELS:
            res[name] = rec_tp_runs(name, mesh)
            res[f"{name}_cut"] = rec_tp_runs(name, mesh, REC_TP_CUT_LAYERS)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def rec_tp_ranks() -> dict:
    """Phase 15d: the recurrent rank programs run whole on the card, as
    REC_RANKS gloo ranks in processes of their own sharing it (NCCL takes
    one rank a card; the collectives stage their parts in host memory):
    rwkv6-1.6b and zamba2-1.2b at full width and depth on mesh (1,
    REC_RANKS), 4 prompts of REC_TP_PROMPT tokens and REC_TP_STEPS decode
    steps (``rec_tp_rank``).
    Holds every rank's runs against the fp32 plain path on the same
    weight values (the truth): the fp32 rank program at FP32_LOGIT_TOL
    with the same argmax on every row; the bf16 one (the main path), at
    full depth and REC_TP_CUT_LAYERS deep, within REC_SPREAD_FACTOR times
    the bf16 plain path's own distance from the truth (never below
    LOGIT_TOL), with the truth's argmax on every row whose top-2 gap
    exceeds twice that; REC_TP_CUT_LAYERS deep also nearer the bf16 plain
    path than that path is to the truth; at full depth each of its
    kernel calls within its plain version's bar (``held_layerwise``).
    Every state its ``decode_state_specs`` shard; the bf16 run's
    launches: K4 at the rank's heads once a layer in prefill and the
    split-key route once a layer a decode step (rwkv6); K3 once a layer
    and K2 once a shared block in prefill (zamba2), each launch held.
    Returns each model's launches, summed over the ranks."""
    import shutil
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    where = tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=root)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         "--tp-dir", where], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(REC_RANKS)]
    logs, failed = [], False
    try:
        for p in procs:
            log, _ = p.communicate(timeout=600)
            logs.append(log)
            failed |= p.returncode != 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise AssertionError("15d: a rank failed:\n" + "\n".join(
            f"--- rank {r}: exit {p.returncode}\n{log[-3000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    ranks = []
    for r in range(REC_RANKS):
        with open(os.path.join(where, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(where, ignore_errors=True)
    from repro_torch import configs
    paths, out = {}, {"ranks": REC_RANKS, "mesh": [1, REC_RANKS],
                      "backend": "gloo", "steps": REC_TP_STEPS}
    for name in REC_TP_MODELS:
        cfg = configs.get_config(name)
        want = dict.fromkeys(kernel_wrappers(), 0)
        if cfg.family == "rwkv6":
            want["rwkv6_scan"] = cfg.n_layers
            want["rwkv6_scan_split"] = cfg.n_layers * REC_TP_STEPS
        else:
            want["mamba2_scan"] = cfg.n_layers
            want["flash_attention"] = cfg.n_layers // cfg.attn_every
        held_want = {k: n for k, n in want.items() if n}
        want = by_route(want, cfg)
        total = dict.fromkeys(want, 0)
        for r, res in enumerate(ranks):
            row = res[name]
            bf, fp = row["bf16"], row["fp32"]
            check(bf.pop("launches") == want, f"15d {name} rank {r}: "
                  f"launches differ from {want}")
            for k in total:
                total[k] += want[k]
            held = bf["held"]
            check(all(held[k][0] == n and held[k][1] <= 1
                      for k, n in held_want.items()),
                  f"15d {name} rank {r}: a kernel call off its plain "
                  f"version, or not held ({held_want} calls): {held}")
            for tag, run in (("bf16", bf), ("fp32", fp)):
                check(run["finite"] and run["shards_as_specs"],
                      f"15d {name} {tag} rank {r}: {run}")
            check(fp["max_abs_err"] <= FP32_LOGIT_TOL
                  and fp["argmax_equal_share"] == 1.0,
                  f"15d {name} fp32 rank {r}: logits off the truth's: {fp}")
            for key in (name, f"{name}_cut"):
                b = res[key]["bf16"]
                check(b["finite"] and b["shards_as_specs"]
                      and b["max_abs_err"] <= b["bar"]
                      and b["argmax_equal_on_clear_rows"],
                      f"15d {key} bf16 rank {r}: logits off the truth's by "
                      f"more than {REC_SPREAD_FACTOR} times the bf16 plain "
                      f"path's: {b}")
            cut = res[f"{name}_cut"]["bf16"]
            check(cut["vs_plain_max_abs_err"] <= cut["plain_max_abs_err"],
                  f"15d {name}_cut bf16 rank {r}: the rank program parts "
                  f"from the bf16 plain path by more than that path parts "
                  f"from the truth: {cut}")
        out[name] = {"rank0": ranks[0][name],
                     "rank0_cut": ranks[0][f"{name}_cut"],
                     "launches_all_ranks": {k: v for k, v in total.items()
                                            if v}}
        paths[f"{name}_tp_ranks"] = total
        print(f"[rec tp ranks] {name}: {json.dumps(out[name])}")
    out["card"] = gpu_name_power()
    return paths


def serve_rec_tp_phases(report: dict) -> dict:
    """Phase 15; returns the launches of 15d's main paths."""
    phase("15a K4 split-key route", split_route_checks, report)
    phase("15b scans at a prefill rank's heads", prefill_rank_heads, report)
    phase("15c recurrent 1 x 1 mesh gate", rec_tp_one_rank)
    return phase("15d recurrent rank programs on gloo ranks", rec_tp_ranks)


# ----------------------------------------------------------------------------
# phase 16: partitioned serving of the encoder-decoder family (the rank
# programs of models/encdec.py) and K2's LSE route
# ----------------------------------------------------------------------------

WHISPER = "whisper-large-v3"
# 16b: a rank's slice of whisper-large-v3's decode cross-attention on the
# frames: 8 rows, 20 heads of 64, one query against 4 slices of 375 of the
# 1500 frames, bf16 (compute fp32, whisper's attn_dtype)
LSE_SLICE = dict(B=8, H=20, D=64, F=1500, slices=4)
# 16a, 16c: 2 segments of 1500 frames, phase 10's 224-token prompt cut to
# 64 (gloo stages every collective in host memory, and 8 ranks share the
# card), 4 decode steps fed the plain path's tokens, the self K/V
# WHISPER_TP_MAX_LEN deep: a multiple of 8 and of 3, so that both meshes
# put the sequence over "model"
WHISPER_TP_BATCH, WHISPER_TP_PROMPT, WHISPER_TP_STEPS = 2, 64, 4
WHISPER_TP_MAX_LEN = 72
# 16c: (1, 8) gives the pod's layouts (the self K/V on the sequence, the
# cross K/V on the layers, 4 a rank); (1, 3), on ranks 0-2, the cross K/V
# on the frames (500 a rank: K2's LSE route) and the encoder on its frames
WHISPER_TP_RANKS = 8
WHISPER_TP_MESHES = ((1, 8), (1, 3))


def whisper_tp_model(seed: int = 0):
    """(cfg, model, bf16 params on the card from ``seed``, the batch: 16a's
    and 16c's frames and prompts) for whisper-large-v3 at full width and
    depth."""
    import torch

    from repro_torch import configs
    from repro_torch.models import api
    cfg = configs.get_config(WHISPER)
    model = api.get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    batch = whisper_batch(cfg, WHISPER_TP_BATCH, WHISPER_TP_PROMPT, seed=5)
    return cfg, model, params, batch


def fp32_copy(cfg, params):
    """(fp32 config, model, params): ``params``' values in fp32, each
    parameter's spec (``shard_params``) kept."""
    import copy

    import torch

    from repro_torch.models import api
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = copy.deepcopy(params).float()
    for a, b in zip(p32.parameters(), params.parameters()):
        if hasattr(b, "spec"):
            a.spec = b.spec
    return cfg32, api.get_model(cfg32), p32


def whisper_serve(model, params, batch, feed=None, *, mesh=None, cfg=None):
    """``serve_steps`` of ``batch`` into a WHISPER_TP_MAX_LEN-deep state
    for WHISPER_TP_STEPS decode steps."""
    return serve_steps(model, params, batch, {"max_len": WHISPER_TP_MAX_LEN},
                       WHISPER_TP_STEPS, feed, mesh=mesh, cfg=cfg)


def whisper_tp_one_rank() -> dict:
    """Phase 16a, a gate: whisper-large-v3 at full width and depth through
    the entry points with no mesh and on a 1 x 1 ("data", "model") mesh
    over NCCL (world size 1), the parameters cut by ``param_specs``:
    logits, tokens and every state leaf bitwise the plain path's (a
    "model" line of one rank runs the plain path: no rank program)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.trainer import shard_params

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg, model, params, batch = whisper_tp_model()
        a = whisper_serve(model, params, batch)
        shard_params(cfg, params, mesh)
        b = whisper_serve(model, params, batch, mesh=mesh, cfg=cfg)
        leaves = sorted(a[2])
        out = {"model": cfg.name,
               "logits_bitwise": bool(torch.equal(a[0], b[0])),
               "tokens_equal": bool(torch.equal(a[1], b[1])),
               "state_leaves": leaves,
               "state_bitwise": sorted(b[2]) == leaves and all(
                   torch.equal(a[2][k], b[2][k]) for k in leaves),
               "finite": bool(torch.isfinite(b[0]).all()),
               "card": gpu_name_power()}
        print(f"[whisper tp 1x1] {json.dumps(out)}")
        check(out["logits_bitwise"] and out["tokens_equal"]
              and out["state_bitwise"] and out["finite"],
              "16a: the 1 x 1 mesh's logits, tokens or state differ from "
              "the plain path's")
        del params, a, b
        torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def lse_route_checks(report: dict) -> dict:
    """Phase 16b: K2's LSE route (``fa.flash_attention_lse``) at a rank's
    frames slice of whisper-large-v3's decode cross-attention (8 rows, 20
    heads of 64, Sq = 1, 4 slices of 375 of 1500 frames, bf16, compute
    fp32): each slice's output against its plain version at phase 2's
    bf16 bar and its fp32 LSE at FP32_TOL; the slices combined by their
    LSE (``attention.combine_lse``) against K2 over all 1500 frames at
    the bf16 bar.  Timed (``ms``, ``ms_graph``) beside the bound
    (``cost.flash_attention`` with the LSE), the plain version, SDPA (the
    output alone: no single PyTorch call returns the LSE) and K2 over the
    whole frames; also at 16c's (1, 3) rank shape (2 rows, 500 frames:
    ``*_frames_rank``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    cfg = configs.get_config(WHISPER)
    cdt = attention.compute_dtype(cfg)
    B, H, D, Fr, n = (LSE_SLICE[k] for k in ("B", "H", "D", "F", "slices"))
    m = Fr // n
    g = torch.Generator(device="cuda").manual_seed(16)
    q = torch.randn(B, H, 1, D, generator=g, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn(B, H, Fr, D, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    slices = [tuple(t[:, :, i * m:(i + 1) * m].contiguous() for t in (k, v))
              for i in range(n)]
    outs, lses, errs, worst = [], [], [], 0.0
    for i, (ks, vs) in enumerate(slices):
        n0, n1 = fa.flash_attention_lse.launches, fa.flash_attention.launches
        o, lse = fa.flash_attention_lse(q, ks, vs, causal=False,
                                        compute_dtype=cdt)
        check(fa.flash_attention_lse.launches == n0 + 1
              and fa.flash_attention.launches == n1,
              "16b: the LSE route did not count its launch apart")
        check(fa.flash_attention_lse.last_kernel
              == "flash_attention_mma_kernel",
              f"16b: the LSE route took {fa.flash_attention_lse.last_kernel}")
        wo, wl = ref.mha_attention(q, ks, vs, causal=False,
                                   compute_dtype=cdt, return_lse=True)
        torch.cuda.synchronize()
        ratio = max(tol_ratio(o, wo, BF16_TOL), tol_ratio(lse, wl, FP32_TOL))
        errs.append(max(max_err(o, wo), max_err(lse, wl)))
        worst = max(worst, ratio)
        check(ratio <= 1, f"16b: frames slice {i} disagrees with its plain "
              f"version: err/tol {ratio:.3f}")
        outs.append(o)
        lses.append(lse)
    whole = fa.flash_attention(q, k, v, causal=False, compute_dtype=cdt)

    def combine():
        return attention.combine_lse(torch.stack(outs),
                                     torch.stack(lses)).to(q.dtype)

    def slices_and_combine():
        for ks, vs in slices:
            fa.flash_attention_lse(q, ks, vs, causal=False,
                                   compute_dtype=cdt)
        return combine()

    got = combine()
    torch.cuda.synchronize()
    row = {"slices_err_over_tol": worst,
           "combine_vs_whole_max_abs_err": max_err(got, whole),
           "combine_vs_whole_err_over_tol": tol_ratio(got, whole, BF16_TOL),
           "finite": bool(torch.isfinite(got).all())}
    print(f"[lse route] {json.dumps(row)}")
    check(row["finite"] and row["combine_vs_whole_err_over_tol"] <= 1,
          f"16b: the {n} slices' combine disagrees with K2 over all {Fr} "
          f"frames: {row}")
    ks, vs = slices[0]
    call = lambda: fa.flash_attention_lse(  # noqa: E731
        q, ks, vs, causal=False, compute_dtype=cdt)
    flops, nbytes = cost.flash_attention(B, H, H, 1, m, D, False, 2,
                                         lse=True)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    res = dict(name="flash_attention_lse", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:85",
               max_abs_err=max(errs), ms=time_ms(call, iters=50),
               ms_graph=time_graph_ms(call),
               plain_ms=time_ms(lambda: ref.mha_attention(
                   q, ks, vs, causal=False, compute_dtype=cdt,
                   return_lse=True), iters=20),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   q, ks, vs), iters=50),
               shape=f"B={B} H=Hkv={H} Sq=1 Skv={m} (1 of {n} slices of "
                     f"{Fr} frames) D={D} bf16, compute fp32, fp32 LSE",
               ms_whole_frames_k2=time_ms(lambda: fa.flash_attention(
                   q, k, v, causal=False, compute_dtype=cdt), iters=50),
               ms_slices_and_combine=time_ms(slices_and_combine, iters=20),
               **row)
    # 16c's (1, 3) rank: 2 rows, 500 of the 1500 frames
    Br, mr = WHISPER_TP_BATCH, Fr // WHISPER_TP_MESHES[1][1]
    qr = q[:Br].contiguous()
    kr, vr = (t[:Br, :, :mr].contiguous() for t in (k, v))
    rank = lambda: fa.flash_attention_lse(  # noqa: E731
        qr, kr, vr, causal=False, compute_dtype=cdt)
    flops, nbytes = cost.flash_attention(Br, H, H, 1, mr, D, False, 2,
                                         lse=True)
    res.update(ms_frames_rank=time_ms(rank, iters=50),
               ms_graph_frames_rank=time_graph_ms(rank),
               bound_ms_frames_rank=bound(nbytes, flops,
                                          torch.bfloat16)[0])
    res["kernel_ms"] = res["ms"]
    print(f"[flash_attention_lse] ms={res['ms']:.5f} ms_graph="
          f"{res['ms_graph']:.5f} plain_ms={res['plain_ms']:.4f} bound_ms="
          f"{b_ms:.6f} ({b_by}) SDPA {res['library_ms']:.5f}; K2 over the "
          f"{Fr} frames {res['ms_whole_frames_k2']:.5f}, the {n} slices "
          f"and their combine {res['ms_slices_and_combine']:.5f}")
    report["flash_attention_lse"] = res
    out = dict(row, card=gpu_name_power())
    del q, k, v, slices
    torch.cuda.empty_cache()
    return out


def whisper_tp_want(cfg, tp: int) -> dict:
    """The launches of one rank's prefill and WHISPER_TP_STEPS decode
    steps on mesh (1, tp): K2 on every encoder layer and every decoder
    layer's self- and cross-attention in prefill; in a decode step (the
    self-attention inline PyTorch) the cross-attention by its layout: K2's
    LSE route on every layer (the frames split), K2 on the layers the rank
    holds (the layers split), else K2 on every layer."""
    from repro_torch.models import encdec
    from repro_torch.parallel import sharding
    lay = sharding.encdec_layout(
        cfg, sharding.abstract_mesh((1, tp), ("data", "model")),
        WHISPER_TP_BATCH, WHISPER_TP_MAX_LEN)
    cross = encdec._cross_spec_layout(lay["cross_k"][0])
    L, steps = cfg.n_layers, WHISPER_TP_STEPS
    want = dict.fromkeys(kernel_wrappers(), 0)
    want["flash_attention"] = cfg.n_enc_layers + 2 * L
    if cross == "frames":
        want["flash_attention_lse"] = L * steps
    else:
        want["flash_attention"] += (L // tp if cross == "layers" else L) \
            * steps
    return by_route(want, cfg)


def whisper_tp_truth(where: str) -> None:
    """16c's truth, on rank 0 before the others start: the fp32 plain path
    on the seed's bf16 weight values, greedy, and the bf16 plain path fed
    its tokens; saved to ``where``/truth.pt."""
    import torch

    cfg, model, params, batch = whisper_tp_model()
    _, model32, p32 = fp32_copy(cfg, params)
    truth = whisper_serve(model32, p32, batch)
    del p32
    torch.cuda.empty_cache()
    plain = whisper_serve(model, params, batch, truth[1])
    torch.save({"logits": truth[0].cpu(), "tokens": truth[1].cpu(),
                "plain_bf16": plain[0].cpu(), "plain_prefill_ms": plain[3],
                "plain_decode_ms": plain[4]},
               os.path.join(where, "truth.pt"))
    del params, truth, plain
    torch.cuda.empty_cache()


def whisper_tp_runs(mesh, truth: dict) -> dict:
    """16c's runs on this rank of ``mesh``: the seed's weights cut by
    ``param_specs``, fed the truth's tokens; the fp32 rank program (the
    same values in fp32), then the bf16 one, the main path: its launches
    counted, every K2 call (either route) held to its plain version on its
    own inputs (``held_layerwise``).  Each run's logits against the truth,
    its state against ``decode_state_specs`` (``sharding.encdec_layout``)."""
    import torch

    from repro_torch.parallel import sharding
    from repro_torch.runtime.trainer import shard_params

    cfg, model, params, batch = whisper_tp_model()
    shard_params(cfg, params, mesh)
    torch.cuda.empty_cache()
    feed = truth["tokens"].cuda()
    cfg32, model32, p32 = fp32_copy(cfg, params)
    runs = {"fp32": whisper_serve(model32, p32, batch, feed, mesh=mesh,
                                  cfg=cfg32)}
    del p32
    torch.cuda.empty_cache()
    reset_counts()                           # the main path's run ...
    runs["bf16"], held = held_layerwise(lambda: whisper_serve(
        model, params, batch, feed, mesh=mesh, cfg=cfg),
        ("flash_attention",))
    counts = read_counts()                   # ... ends here
    layout = sharding.encdec_layout(cfg, mesh, WHISPER_TP_BATCH,
                                    WHISPER_TP_MAX_LEN)
    t = truth["logits"].cuda().float()
    row = {"mesh": list(mesh.shape.values()),
           "max_abs_logit": float(t.abs().max()),
           "layout": {k: [list(e) if isinstance(e, tuple) else e
                          for e in spec] for k, (spec, _) in layout.items()}}
    for tag, run in runs.items():
        try:
            sharding.check_state_shards(layout, run[2], mesh)
            shards = True
        except ValueError:
            shards = False
        b = run[0].float()
        row[tag] = {"max_abs_err": max_err(b, t),
                    "argmax_equal_share": float(
                        (b.argmax(-1) == t.argmax(-1)).float().mean()),
                    "finite": bool(torch.isfinite(b).all()),
                    "shards_as_specs": shards,
                    "max_len_carried": run[2].get("max_len"),
                    "rank_prefill_ms": run[3], "rank_decode_ms": run[4]}
    bf = row["bf16"]
    plain = truth["plain_bf16"].cuda()
    bf["plain_max_abs_err"] = max_err(plain, t)
    bf["vs_plain_max_abs_err"] = max_err(runs["bf16"][0], plain)
    bf["held"] = held
    bf["launches"] = counts
    del params, runs
    torch.cuda.empty_cache()
    return row


def whisper_tp_rank(rank: int, where: str) -> int:
    """One of 16c's WHISPER_TP_RANKS gloo ranks (a process of its own on
    the card): rank 0 makes the truth (``whisper_tp_truth``); then every
    rank runs ``whisper_tp_runs`` on mesh (1, 8), and ranks 0-2 on (1,
    3).  Writes ``rank<r>.json`` under ``where``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{where}/store",
                            rank=rank, world_size=WHISPER_TP_RANKS)
    res = {}
    try:
        if rank == 0:
            whisper_tp_truth(where)
        dist.barrier()
        truth = torch.load(os.path.join(where, "truth.pt"))
        res["truth"] = {k: v for k, v in truth.items() if "ms" in k}
        for shape in WHISPER_TP_MESHES:
            if rank < shape[0] * shape[1]:
                mesh = make_mesh(shape, ("data", "model"))
                res[f"{shape[0]}x{shape[1]}"] = whisper_tp_runs(mesh, truth)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(where, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def whisper_tp_ranks() -> dict:
    """Phase 16c: whisper's rank programs run whole on the card, as
    WHISPER_TP_RANKS gloo ranks in processes of their own sharing it: at
    full width and depth, 2 segments of 1500 frames, a 64-token prompt,
    4 decode steps fed the fp32 plain path's tokens, on mesh (1, 8) (the
    pod's layouts) and, on ranks 0-2, (1, 3) (the cross K/V on the
    frames).  Holds every rank's runs: the fp32 rank program within
    FP32_LOGIT_TOL of the fp32 plain path (the truth) with the same argmax
    on every row; the bf16 one (the main path) with every K2 call within
    its plain version's bar (``held_layerwise``) and its launches exactly
    ``whisper_tp_want``'s; every state the rank's ``decode_state_specs``
    shard, carrying its depth.  Returns each mesh's launches, summed over
    its ranks."""
    import shutil
    import tempfile

    from repro_torch import configs
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    where = tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=root)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         "--tp-dir", where, "--tp-job", "whisper"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for r in range(WHISPER_TP_RANKS)]
    logs, failed = [], False
    try:
        for p in procs:
            log, _ = p.communicate(timeout=600)
            logs.append(log)
            failed |= p.returncode != 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise AssertionError("16c: a rank failed:\n" + "\n".join(
            f"--- rank {r}: exit {p.returncode}\n{log[-3000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    ranks = []
    for r in range(WHISPER_TP_RANKS):
        with open(os.path.join(where, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(where, ignore_errors=True)
    cfg = configs.get_config(WHISPER)
    paths, out = {}, {"backend": "gloo", "batch": WHISPER_TP_BATCH,
                      "prompt": WHISPER_TP_PROMPT,
                      "steps": WHISPER_TP_STEPS,
                      "max_len": WHISPER_TP_MAX_LEN,
                      "truth": ranks[0]["truth"]}
    for shape in WHISPER_TP_MESHES:
        key, tp = f"{shape[0]}x{shape[1]}", shape[0] * shape[1]
        want = whisper_tp_want(cfg, tp)
        held_want = {k: n for k, n in want.items() if n}
        total = dict.fromkeys(want, 0)
        for r in range(tp):
            row = ranks[r][key]
            bf, fp = row["bf16"], row["fp32"]
            check(bf.pop("launches") == want, f"16c {key} rank {r}: "
                  f"launches differ from {want}")
            for k in total:
                total[k] += want[k]
            held = bf["held"]
            check(all(held.get(k, [0])[0] == n and held[k][1] <= 1
                      for k, n in held_want.items()),
                  f"16c {key} rank {r}: a K2 call off its plain version, "
                  f"or not held ({held_want} calls): {held}")
            for tag, run in (("bf16", bf), ("fp32", fp)):
                check(run["finite"] and run["shards_as_specs"]
                      and run["max_len_carried"] == WHISPER_TP_MAX_LEN,
                      f"16c {key} {tag} rank {r}: {run}")
            check(fp["max_abs_err"] <= FP32_LOGIT_TOL
                  and fp["argmax_equal_share"] == 1.0,
                  f"16c {key} fp32 rank {r}: logits off the truth's: {fp}")
        out[key] = {"rank0": ranks[0][key], "launches_all_ranks": {
            k: v for k, v in total.items() if v}}
        paths["whisper_tp_ranks" if tp == WHISPER_TP_RANKS
              else "whisper_tp_frames"] = total
    out["card"] = gpu_name_power()
    print(f"[whisper tp ranks] {json.dumps(out)}")
    return paths


def serve_encdec_tp_phases(report: dict) -> dict:
    """Phase 16; returns the launches of 16c's main paths."""
    phase("16a whisper 1 x 1 mesh gate", whisper_tp_one_rank)
    phase("16b K2's LSE route at a frames slice", lse_route_checks, report)
    return phase("16c whisper rank programs on gloo ranks",
                 whisper_tp_ranks)


# ----------------------------------------------------------------------------
# --engine-ab / --scan-ab: two checkouts of the port, on one card
# ----------------------------------------------------------------------------

ADAMW_SHAPES = {"olmoe-1b-7b": 4, "deepseek-7b": 6}   # config: layers


def adamw_leaves(name: str, layers: int):
    """(cfg, model, {leaf: [tensors]}, {"m", "v", "step"}) at ``name``'s
    widths cut to ``layers``: the model's own tensors, each with a random
    gradient of its dtype (the last leaf's last tensor with none), and
    random fp32 moments of the stacked leaves' shapes, as after a step."""
    import torch

    from repro_torch import configs, weights
    from repro_torch.models import api
    cfg = dataclasses.replace(configs.get_config(name), n_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.get_model(cfg).init(gen)
    leaves = weights.jax_leaves(cfg, params)
    state = {"m": {}, "v": {}, "step": torch.ones((), dtype=torch.int32,
                                                  device="cuda")}
    for k, ps in leaves.items():
        shape = ((len(ps),) if weights.is_stacked(cfg, k) else ()) \
            + tuple(ps[0].shape)
        for mom, scale in (("m", 1e-3), ("v", 1e-6)):
            t = torch.randn(shape, generator=gen, device="cuda")
            state[mom][k] = t.abs_() * scale if mom == "v" else t * scale
        for p in ps:
            p.requires_grad_(False)
            p.grad = torch.randn(p.shape, generator=gen, device="cuda",
                                 dtype=p.dtype) * 1e-4
    ps[-1].grad = None        # the last leaf's last tensor: no gradient
    return cfg, params, leaves, state


def adamw_phase() -> dict:
    """Phase 17: the AdamW kernel pair at olmoe-l4's and deepseek-l6's leaf
    shapes; returns its row for the kernels' table."""
    import ctypes

    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import adamw as ka
    from repro_torch.optim import AdamWConfig, adamw_update_, \
        adamw_update_plain_
    row = {"name": "fused_adamw", "route": "adamw_norm_kernel + "
           "adamw_update_kernel", "source": "src/repro_torch/kernels/csrc/"
           "adamw.cu", "replaces": "none (the JAX package leaves AdamW to "
           "XLA); the port's eager update over stacked copies",
           "bound_by": "bytes", "library_ms": "none"}
    cfg_opt = AdamWConfig(lr=4e-4, warmup_steps=0, clip_norm=1e9)
    for name, layers in ADAMW_SHAPES.items():
        tag = f"{name}-l{layers}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, params, leaves, state = adamw_leaves(name, layers)
        tensors = [p for ps in leaves.values() for p in ps]
        n = sum(p.numel() for p in tensors)
        # bytes the step must move: the parameter read and written, its
        # gradient read by each pass, each fp32 moment read and written
        nbytes = sum(p.numel() * (4 * p.element_size() + 16)
                     for p in tensors)
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        # (a) one step against the plain version, leaf by leaf (clipping
        # off: every leaf's step is its own), from copies of the state
        before = {k: ([p.clone() for p in ps], state["m"][k].clone(),
                      state["v"][k].clone()) for k, ps in leaves.items()}
        step0 = state["step"].clone()
        want_sq = sum(float(p.grad.double().square().sum())
                      for p in tensors if p.grad is not None)
        n0 = ka.fused_adamw.launches
        got = adamw_update_(cfg_opt, leaves, state)
        torch.cuda.synchronize()
        check(ka.fused_adamw.launches == n0 + 1, f"{tag}: launches")
        worst = 0
        for k, ps in leaves.items():
            ref, m, v = before.pop(k)
            for r, p in zip(ref, ps):
                r.grad = p.grad
            one = {"m": {k: m}, "v": {k: v}, "step": step0.clone()}
            adamw_update_plain_(cfg_opt, {k: ref}, one, arch=cfg)
            same = all(torch.equal(a, b) for a, b in zip(ps, ref)) \
                and torch.equal(m, state["m"][k]) \
                and torch.equal(v, state["v"][k])
            check(same, f"{tag}: leaf {k} differs from the plain version")
            del ref, m, v, one
        norm = float(got["grad_norm"])
        norm_rel = abs(norm - want_sq ** 0.5) / want_sq ** 0.5
        check(norm_rel <= 2 ** -22, f"{tag}: norm {norm} against the fp64 "
              f"norm {want_sq ** 0.5}")
        torch.cuda.empty_cache()
        # (b) times: the entry point eagerly, the kernel pair in a graph,
        # the kernels under the profiler, the plain version
        ms = time_ms(lambda: adamw_update_(cfg_opt, leaves, state), 20, 3)
        table, n_chunks, _ = ka._records(leaves, state["m"], state["v"],
                                         torch.device("cuda", 0), True)
        recs = torch.from_numpy(table.view(np.uint8)).cuda()
        scal = torch.tensor([4e-4, 0.5, 0.25, 0.0], device="cuda")
        lr, bc1, bc2, norm_out = (scal.data_ptr() + 4 * i for i in range(4))
        partial = torch.empty(ka.MAX_BLOCKS, dtype=torch.float64,
                              device="cuda")
        blocks = (ctypes.c_int * 2)()
        fn, f = _build.load("adamw"), ctypes.c_float

        def launch():
            err = fn(recs.data_ptr(), len(table), n_chunks,
                     partial.data_ptr(), ka.MAX_BLOCKS, lr, bc1, bc2,
                     norm_out, f(0.9), f(1 - 0.9), f(0.95),
                     f(1 - 0.95), f(1e-8), f(0.1), f(1e9), blocks,
                     _build.raw_stream(scal.device))
            check(err == 0, f"{tag}: adamw_launch returned {err}")
        ms_graph = time_graph_ms(launch, iters=10, reps=3)
        prof = device_profile(lambda: adamw_update_(cfg_opt, leaves, state),
                              3)
        kernel_ms = prof["our_kernels_device_ms"].get("AdamW", 0.0)
        plain_ms = time_ms(
            lambda: adamw_update_plain_(cfg_opt, leaves, state, arch=cfg),
            3, 1)
        peak = torch.cuda.max_memory_allocated()
        out = {"parameters": n, "tensors": len(tensors),
               "records": len(table), "chunks": n_chunks,
               "grids": list(ka.fused_adamw.last_blocks),
               "bytes": nbytes, "bound_ms": bound_ms, "ms": ms,
               "ms_graph": ms_graph, "kernel_ms": kernel_ms,
               # "(anonymous namespace)::<name>(<arguments>)"
               "kernels_by_name": {k.split("(")[1].split("::")[-1]: t
                                   for k, t in prof["top_device_ms"]
                                   if "adamw_" in k},
               "plain_ms": plain_ms, "bound_share_graph": bound_ms / ms_graph,
               "norm_rel_to_fp64": norm_rel,
               "max_memory_allocated_bytes": peak}
        print(f"[adamw {tag}] {json.dumps(out)}")
        sfx = "_" + name.split("-")[0]
        row.update({k + sfx: out[k] for k in ("ms", "ms_graph", "kernel_ms",
                                              "plain_ms", "bound_ms")})
        del params, leaves, state, tensors, recs, partial, before
        torch.cuda.empty_cache()
    first = "_" + next(iter(ADAMW_SHAPES)).split("-")[0]
    row.update({k: row[k + first] for k in ("ms", "ms_graph", "kernel_ms",
                                            "plain_ms", "bound_ms")})
    row["max_abs_err"] = 0.0         # bitwise against the plain version
    return row


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


# K2-bwd's timed shapes for --bwd-ab: (label, (B, H, Hkv, Sq, Skv, D),
# compute_dtype name), bf16 inputs, causal
BWD_AB_SHAPES = [
    ("training", (TRAIN_BATCH, 14, 2, TRAIN_SEQ, TRAIN_SEQ, 64), "float32"),
    ("training", (TRAIN_BATCH, 14, 2, TRAIN_SEQ, TRAIN_SEQ, 64), "bfloat16"),
    ("prefill", (1, 14, 2, 2048, 2048, 64), "float32"),
    ("prefill", (1, 14, 2, 2048, 2048, 64), "bfloat16"),
    ("olmoe training", OLMOE_BWD_SHAPE, "float32"),
    ("olmoe training", OLMOE_BWD_SHAPE, "bfloat16")]


def bwd_only(src: str) -> None:
    """K2-bwd's ``ms`` and ``ms_graph`` at BWD_AB_SHAPES with the port under
    ``src``, and the kernels each call launched: one ``[bwd-ab]`` line."""
    sys.path.insert(0, src)
    import torch

    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    _build.build_all(("flash_attention", "flash_attention_bwd"))
    res: dict = {"package": str(Path(repro_torch.__file__).parent)}
    for i, (label, shape, cname) in enumerate(BWD_AB_SHAPES):
        cdt = getattr(torch, cname)
        q, k, v, dout = k2_bwd_case(*shape, torch.bfloat16, seed=i)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
        out = fa._forward(q, k, v, True, shape[-1] ** -0.5, cdt, lse)
        bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, out, dout, lse, causal=True, compute_dtype=cdt)
        bwd()
        res[f"{label} compute {cname}"] = {
            "kernel": fa.flash_attention_bwd.last_kernel,
            "ms": time_ms(bwd, iters=10),
            "ms_graph": time_graph_ms(bwd, iters=5, reps=3)}
    print(f"[bwd-ab] {json.dumps(res)}")


def scan_bwd_only(src: str) -> None:
    """K3-bwd's and K4-bwd's ``ms`` and ``ms_graph`` at their training
    shapes (bf16; zamba2's x/B/C as the mixer's views), with the port under
    ``src``, and the device kernel each reports: one ``[scan-bwd-ab]``
    line."""
    sys.path.insert(0, src)
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as rw
    import torch
    _build.build_all(tuple(n for n in _build.KERNELS if "scan_bwd" in n))
    bf = torch.bfloat16
    res: dict = {"package": str(Path(repro_torch.__file__).parent)}
    r, k, v, w, u, _, dy, _ = rwkv_bwd_case(4, 1024, 32, bf, state=False,
                                            seed=60)
    call = lambda: rw.rwkv6_scan_bwd(r, k, v, w, u, dy,  # noqa: E731
                                     need_ds0=False)
    call()
    res["rwkv6_scan_bwd"] = {
        "kernel": rw.rwkv6_scan_bwd.last_kernel,
        "ms": time_ms(call, iters=10, warmup=2),
        "ms_graph": time_graph_ms(call, iters=10, reps=3)}
    del r, k, v, w, dy
    x, dt, A, Bm, Cm, D, _, dy, _ = mamba_bwd_case(4, 1024, 64, bf,
                                                   state=False, seed=70,
                                                   views=True)
    call = lambda: m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy,  # noqa: E731
                                      need_dh0=False)
    call()
    res["mamba2_scan_bwd"] = {
        "kernel": m2.mamba2_scan_bwd.last_kernel,
        "ms": time_ms(call, iters=10, warmup=2),
        "ms_graph": time_graph_ms(call, iters=10, reps=3)}
    print(f"[scan-bwd-ab] {json.dumps(res)}")


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


def bwd_ab(parent: str) -> None:
    """K2-bwd's times for PARENT's port and this one, on one card."""
    for label, r in ab_runs(parent, "bwd-only", "bwd-ab"):
        print(f"[bwd-ab {label}] " + "; ".join(
            f"{k} ({' + '.join(v['kernel'])}): ms {v['ms']:.5f} ms_graph "
            f"{v['ms_graph']:.5f}" for k, v in r.items() if k != "package"))


def scan_bwd_ab(parent: str) -> None:
    """K3-bwd's and K4-bwd's times for PARENT's port and this one, on one
    card."""
    for label, r in ab_runs(parent, "scan-bwd-only", "scan-bwd-ab"):
        print(f"[scan-bwd-ab {label}] " + "; ".join(
            f"{k} ({v['kernel']}): ms {v['ms']:.5f} ms_graph "
            f"{v['ms_graph']:.5f}" for k, v in r.items() if k != "package"))


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


def kernel_ranking(report: dict, paths: dict) -> dict:
    """Each kernel's cost on the main paths: launches x (ms - bound) summed
    over the paths, each path's calls at the shape timed for them (eager
    ``ms``; ``ms_graph``, the device alone, in ``excess_ms_graph``).  The
    engine's and the cluster's K1 calls take the engine's batch of 8, and
    their K2 calls its longest prompt (S = 1024; prompts are 128-1024
    tokens), so K2's is an upper estimate there.  A path's calls at no
    timed shape are counted apart, not measured."""
    from repro_torch import configs
    wh = configs.get_config("whisper-large-v3")
    E, L = wh.n_enc_layers, wh.n_layers
    rw = configs.get_config("rwkv6-1.6b").n_layers
    fw = 2 * WHISPER_TRAIN_STEPS          # K2 twice a layer a step (remat)
    # kernel -> path -> {timed shape's key suffix: launches (None: all)}
    split = {
        "paged_attention": {"qwen2_engine": {"_engine_shape": None},
                            "qwen2_cluster": {"_engine_shape": None}},
        "flash_attention": {
            "qwen2_engine": {"_qwen2_s1024": None},
            "qwen2_cluster": {"_qwen2_s1024": None},
            "zamba2-1.2b": {"_zamba2_shape": None},
            "zamba2_train": {"_zamba2_shape": None},
            "qwen2_train": {"_qwen2_train": None},
            "whisper_serve": {"_whisper_encoder": E,
                              "_whisper_decoder_prefill": L,
                              "_whisper_cross_prefill": L,
                              "_whisper_cross_decode": L * WHISPER_STEPS},
            "whisper_train": {"_whisper_train_encoder": fw * E,
                              "_whisper_train_decoder": fw * L,
                              "_whisper_train_cross": fw * L}},
        "flash_attention_bwd": {
            "qwen2_train": {"": None},
            "zamba2_train": {"_zamba2": None},
            "whisper_train": {"_whisper_encoder": WHISPER_TRAIN_STEPS * E,
                              "_whisper_decoder": WHISPER_TRAIN_STEPS * L,
                              "_whisper_cross": WHISPER_TRAIN_STEPS * L}},
        # the training forwards take the prefill's timed shape (B=4,
        # S=1024, no state in; training returns no state)
        "mamba2_scan": {"zamba2-1.2b": {"": None},
                        "zamba2_train": {"": None}},
        "rwkv6_scan": {"rwkv6-1.6b": {"": rw, "_decode": rw * DECODE_STEPS},
                       "rwkv6_train": {"": None}},
        "mamba2_scan_bwd": {"zamba2_train": {"": None}},
        "rwkv6_scan_bwd": {"rwkv6_train": {"": None}},
        # phase 15d's ranks, timed at their shape in 15a
        "rwkv6_scan_split": {"rwkv6-1.6b_tp_ranks": {"_ranks": None}},
        # phase 16c's (1, 3) ranks, timed at their shape in 16b
        "flash_attention_lse": {"whisper_tp_frames": {"_frames_rank":
                                                      None}}}
    split["flash_attention"]["qwen2_train_gspmd"] = {"_qwen2_train": None}
    for name in SERVE_TP_MODELS:          # phase 14a, timed in 14c
        split["flash_attention"][f"{name}_serve_tp"] = {
            f"_{name}_serve_tp": None}
    split["flash_attention_bwd"]["qwen2_train_gspmd"] = {"": None}
    # olmoe: its engine's batch of 8 (K1) and longest prompt (K2), and the
    # training shapes
    split["paged_attention"]["olmoe_engine"] = {"_olmoe_engine": None}
    split["flash_attention"]["olmoe_engine"] = {"_olmoe_s1024": None}
    for path in ("olmoe_train", "olmoe_train_gspmd"):
        split["flash_attention"][path] = {"_olmoe_train": None}
        split["flash_attention_bwd"][path] = {"_olmoe": None}
    # the small-width routes: every reduced path's calls at the timed
    # reduced shape (K4's S = 1 calls in serving at the decode one)
    for name in ("paged_attention", "flash_attention", "flash_attention_bwd",
                 "mamba2_scan", "mamba2_scan_bwd", "rwkv6_scan",
                 "rwkv6_scan_bwd"):
        split[f"{name}_small"] = {p: {"": None} for p in paths
                                  if p.startswith("reduced_")}
    out = {}
    for name, r in report.items():
        row = {"excess_ms": 0.0, "excess_ms_graph": 0.0, "by_path": {},
               "launches_not_timed": 0}
        for path, counts in paths.items():
            n = counts[name]
            shapes = split.get(name, {}).get(path, {})
            for suf, k in shapes.items():
                k = n if k is None else k
                b = r["bound_ms" + suf]
                ex = k * (r["ms" + suf] - b)
                row["excess_ms"] += ex
                row["excess_ms_graph"] += k * (r["ms_graph" + suf] - b)
                row["by_path"][path] = row["by_path"].get(path, 0.0) + ex
                n -= k
            check(n >= 0, f"ranking: {path} launched {name} {counts[name]} "
                  f"times, fewer than its timed shapes' share")
            row["launches_not_timed"] += n
        out[name] = row
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["excess_ms"]))


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
    ap.add_argument("--bwd-ab", metavar="PARENT",
                    help="K2-bwd's times alone, for PARENT's port and this "
                         "one")
    ap.add_argument("--bwd-only", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--scan-bwd-ab", metavar="PARENT",
                    help="K3-bwd's and K4-bwd's times alone, for PARENT's "
                         "port and this one")
    ap.add_argument("--scan-bwd-only", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--train-only", action="store_true",
                    help="the build and phases 9 and 11 (training) alone")
    ap.add_argument("--moe-only", action="store_true",
                    help="the build, phase 2's K1 and K2, phase 9a's K2-bwd "
                         "and phase 12 (the MoE family) alone")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="the build and phase 13 (the dry run held against "
                         "the card, the examples, the autotuner) alone")
    ap.add_argument("--serve-rec-tp-only", action="store_true",
                    help="the build, phase 2's scan checks and phase 15 "
                         "(partitioned serving of the recurrent families) "
                         "alone")
    ap.add_argument("--serve-encdec-tp-only", action="store_true",
                    help="the build and phase 16 (partitioned serving of "
                         "the encoder-decoder family) alone")
    ap.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-dir", help=argparse.SUPPRESS)
    ap.add_argument("--tp-job", default="rec", choices=("rec", "whisper"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--adamw-only", action="store_true",
                    help="the build and phase 17 (the AdamW kernel pair) "
                         "alone")
    ap.add_argument("--serve-tp-only", action="store_true",
                    help="the build, phase 2's kernel checks and phase 14 "
                         "(tensor-parallel serving) alone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.tp_rank is not None:
        if args.tp_job == "whisper":
            return whisper_tp_rank(args.tp_rank, args.tp_dir)
        return rec_tp_rank(args.tp_rank, args.tp_dir)
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
    if args.bwd_only:
        bwd_only(args.bwd_only)
        return 0
    if args.bwd_ab:
        bwd_ab(args.bwd_ab)
        return 0
    if args.scan_bwd_only:
        scan_bwd_only(args.scan_bwd_only)
        return 0
    if args.scan_bwd_ab:
        scan_bwd_ab(args.scan_bwd_ab)
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
    if args.adamw_only:
        row = phase("17 adamw", adamw_phase)
        print(f"[phase walls] {json.dumps(PHASE_WALLS)}")
        print(card)
        print(json.dumps({"kernels": [row]}))
        return 0
    if args.serve_encdec_tp_only:
        paths = serve_encdec_tp_phases(report)
        print(f"[phase walls] {json.dumps(PHASE_WALLS)}")
        print(f"[launches] {json.dumps(paths)}")
        print(card)
        return 0
    if args.serve_rec_tp_only:
        phase("2 scans vs plain", run_scan_checks, report)
        paths = serve_rec_tp_phases(report)
        print(f"[phase walls] {json.dumps(PHASE_WALLS)}")
        print(f"[launches] {json.dumps(paths)}")
        print(card)
        return 0
    if args.serve_tp_only:
        phase("2 kernels vs plain", run_kernel_checks, report)
        paths = serve_tp_phases(report)
        print(f"[phase walls] {json.dumps(PHASE_WALLS)}")
        print(f"[launches] {json.dumps(paths)}")
        print(card)
        return 0
    if args.dryrun_only:
        dryrun_phases()
        print(f"[phase walls] {json.dumps(PHASE_WALLS)}")
        print(card)
        return 0
    if args.moe_only:
        phase("2 kernels vs plain", run_kernel_checks, report)
        phase("9a K2-bwd vs plain", run_k2_bwd_checks, report)
        paths = moe_phases()
        print(f"[phase walls] {json.dumps(PHASE_WALLS)}")
        print(f"[launches] {json.dumps(paths)}")
        print(f"[ranking] {json.dumps(kernel_ranking(report, paths))}")
        print(card)
        return 0
    if args.train_only:
        train_phases(report)
        recurrent_train_phases(report)
        phase("2c small-width routes vs plain", run_small_width_checks,
              report)
        print(f"[phase walls] {json.dumps(PHASE_WALLS)}")
        print(card)
        return 0
    phase("2 kernels vs plain", run_kernel_checks, report)
    phase("2 scans vs plain", run_scan_checks, report)
    phase("2c small-width routes vs plain", run_small_width_checks, report)
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
    t0 = time.perf_counter()
    whole, _ = run_engine(cfg, params, chunked=False, launches=launches)
    chunked, _ = run_engine(cfg, params, chunked=True, launches=launches)
    PHASE_WALLS["3 engine"] = round(time.perf_counter() - t0, 1)
    same = sum(whole[i] == chunked[i] for i in whole)
    print(f"[engine] whole vs chunked prefill: {same}/{len(whole)} "
          "requests with identical tokens (bf16)")
    # the main path is the launcher's: whole-prompt prefill, then decode
    check(launches["whole"]["paged_attention"] > 0
          and launches["whole"]["flash_attention"] > 0,
          f"a kernel of the engine path never launched: {launches}")
    phase("4 engine kernels vs plain", compare_paths, cfg, params)
    reduced_serve = phase("4 reduced qwen2 card vs CPU", compare_with_cpu)
    cluster_counts = phase("7 cluster", cluster_phase, cfg, params)
    del params                         # one model on the card at a time
    torch.cuda.empty_cache()

    # each main path is read on its own: qwen2's engine (whole prefill, the
    # launcher's default), then rwkv6 and zamba2 served through get_model
    paths = {"qwen2_engine": launches["whole"],
             "qwen2_cluster": cluster_counts,
             "reduced_qwen2_serve": reduced_serve}
    for name in ("rwkv6-1.6b", "zamba2-1.2b"):
        torch.cuda.reset_peak_memory_stats()
        paths[name] = phase(f"5 {name}", serve_recurrent, name)
        torch.cuda.empty_cache()
    paths["reduced_recurrent_serve"] = phase(
        "6 reduced recurrent card vs CPU", compare_recurrent_with_cpu)
    phase("8 solver", solver_phase)
    paths.update(phase("9 training", train_phases, report))
    # whisper once every other model has left the card, then the
    # recurrent families trained
    paths.update(whisper_phases())
    paths.update(recurrent_train_phases(report))
    # the MoE family alone on the card
    paths.update(moe_phases())
    # the dry run held against the card, the examples, the autotuner
    dryrun_phases()
    # tensor-parallel serving: the entry points on a 1 x 1 mesh
    paths.update(serve_tp_phases(report))
    # the recurrent families' rank programs: K4's split-key route, then
    # the rank programs whole on gloo ranks sharing the card
    paths.update(serve_rec_tp_phases(report))
    # the encoder-decoder's rank programs and K2's LSE route
    paths.update(serve_encdec_tp_phases(report))
    # the optimizer update, last: its row's launches are the main paths'
    adamw = phase("17 adamw", adamw_phase)
    print(f"[phase walls] {json.dumps(PHASE_WALLS)}")
    ranking = kernel_ranking(report, paths)
    print(f"[ranking] {json.dumps(ranking)}")
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
        entry["main_paths_excess"] = ranking[name]
        kernels.append(entry)
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel of the main paths never launched: {paths}")
    by_path = {p: c["fused_adamw"] for p, c in paths.items()
               if c["fused_adamw"]}
    check(by_path, "the training paths never launched AdamW")
    kernels.append({**adamw, "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "launches_per_single_step":
                        paths["qwen2_train"]["fused_adamw"] / TRAIN_STEPS})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
