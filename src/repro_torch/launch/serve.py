"""Serving launcher: continuous-batching decode over the paged-KV engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --requests 8 --max-new 16                      # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --reduced --device cpu                         # plain path, CPU

The counterpart of ``repro.launch.serve``.  Page allocation goes through
RDMA buffer registration, virtual->physical page translation hits the
(software) TLB, and decode attention runs the paged-attention kernel whose
in-kernel page-table lookup is the hardware-TLB analogue.  Weights are
random, drawn from ``--seed``.  At exit it prints the process hub's span
summary: count, total and self milliseconds per span name.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.fabric import process_hub
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine, PagedLM, Request

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family not in ("dense", "moe", "vlm"):
        print(f"[serve] family {cfg.family} has no paged-KV decode "
              "(O(1) recurrent state) — engine targets transformer archs")
        return 2
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("[serve] no CUDA device; pass --device cpu")
            return 2
        # fp32 products stay fp32 on the card (TF32 keeps ~3 digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.get_model(cfg).init(gen)
    max_seq = args.prompt_len + args.max_new + args.page_tokens
    lm = PagedLM(cfg, params, max_batch=args.max_batch, max_seq=max_seq,
                 page_tokens=args.page_tokens, device=device)
    eng = Engine(lm)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab, size=(plen,)).astype(np.int32)
        eng.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    eng.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stats = eng.stats()
    toks = sum(len(r.out_tokens) for r in eng.finished)
    print(f"[serve] arch={cfg.name} device={device} "
          f"requests={len(eng.finished)} tokens={toks} wall={dt:.2f}s "
          f"({toks/dt:.1f} tok/s)")
    print(f"[serve] decode_steps={stats['decode_steps']} "
          f"tlb_hit_rate={stats['tlb_hit_rate']:.3f} "
          f"translation_cost={stats['translation_cost_s']*1e6:.1f} us")
    print(process_hub().span_summary())
    if len(eng.finished) != args.requests:
        print(f"[serve] only {len(eng.finished)} of {args.requests} "
              "requests finished")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
