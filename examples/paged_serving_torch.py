"""Batched serving with the paged KV cache + TLB registration (paper §2.2),
on the PyTorch port.

  PYTHONPATH=src python examples/paged_serving_torch.py            # the card
  PYTHONPATH=src python examples/paged_serving_torch.py --device cpu

The port's counterpart of ``examples/paged_serving.py``.  Continuous
batching: requests arrive, claim page-granular KV slots whose
virtual->physical translation goes through the RDMA registration TLB, and
finished requests release pages for newly admitted ones.  Decode attention
reads the pages through the page table inside the kernel (K1 on the card:
the "hardware TLB" fast path of Fig 2); prefill runs K2.  The last line
gives the kernels' launches.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.engine import Engine, PagedLM, Request  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    cfg = configs.get_config("qwen2-0.5b").reduced()
    model = api.get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    lm = PagedLM(cfg, params, max_batch=4, max_seq=96, page_tokens=16,
                 device=dev)
    eng = Engine(lm)
    rng = np.random.default_rng(0)
    n_requests = 10
    for rid in range(n_requests):
        plen = int(rng.integers(4, 20))
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, size=(plen,)).astype(np.int32),
            max_new_tokens=int(rng.integers(4, 12))))

    t0 = time.perf_counter()
    eng.run_to_completion()
    dt = time.perf_counter() - t0
    stats = eng.stats()
    toks = sum(len(r.out_tokens) for r in eng.finished)
    print(f"finished {len(eng.finished)}/{n_requests} requests, "
          f"{toks} tokens in {dt:.2f}s on {dev}")
    print(f"decode steps (continuous batching): {stats['decode_steps']}")
    print(f"TLB hit rate: {stats['tlb_hit_rate']:.3f} "
          f"(translation cost {stats['translation_cost_s']*1e6:.1f} us; "
          "a page hit bypasses the Nios II walk — Fig 2)")
    assert len(eng.finished) == n_requests
    assert stats["tlb_hit_rate"] > 0.0
    for r in eng.finished[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} -> "
              f"out={r.out_tokens}")
    print("kernel launches:", json.dumps(ops.launch_counts()))
    print("paged serving OK")


if __name__ == "__main__":
    main()
