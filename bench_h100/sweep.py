#!/usr/bin/env python3
"""A sweep of a serving cell's load: its closed loop at several client
counts, one short window each, on one set of weights.

    python3 bench_h100/sweep.py --workload <cell> --clients 8,16,32 \
        --seconds 20 --seed <n> [--pool-gb 50] [--out FILE]

Each point runs the cell's traffic mix with ``clients`` and ``max_batch``
set to the count and a page pool of ``--pool-gb`` (default: the mix's
own), and prints one JSON line: the end-to-end serving metrics and the
run's diagnostics (the pool's use, the queue, the decode step).  It
finds the knee a cell's client count is set from; nothing is checked
against the reference, and the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def point(cell, module, clients: int, seed: int, seconds: float,
          pool_gb: float | None, device) -> dict:
    import torch
    from benchkit import cell as C
    from benchkit import drive_serve, manifest, port

    c = copy.deepcopy(cell)
    t = c.traffic
    t.update(clients=clients, max_batch=clients)
    m = c.config["model"]
    page_bytes = c.layout.cache_bytes_per_token(m, 2) * t["page_tokens"]
    if pool_gb:
        t["pool_pages"] = int(pool_gb * 1e9 // page_bytes)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = C.Record(cell=c.name, kind="serve", model=m, traffic=t,
                   layout=c.layout)
    ctx = C.Ctx(cell=c, seed=seed, seconds=seconds, trace=False,
                device=device, clock=lambda: time.perf_counter() - t0,
                hooks={}, tmpdir=C._tmpdir(), record=rec)
    drive_serve._serve(ctx, module)
    port.free_cuda()
    out = {"clients": clients, "attempted": rec.attempted,
           "failed": rec.failed, "memory_peak_bytes": rec.memory_peak_bytes}
    for name in ("gen_tokens_per_s", "ttft_p90_ms", "itl_p95_ms"):
        out[name] = manifest.reader(name, ROOT)(rec)
    out.update(rec.diag)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--clients", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--pool-gb", type=float)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          str(ROOT / "build" / "repro_torch"))
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch
    from benchkit import manifest

    device = torch.device("cuda")
    cell = manifest.cell(args.workload, ROOT)
    cfg = cell.layout.arch(cell.config)
    module = cell.layout.lm_module(cfg, cell.config, args.seed, device)
    for n in (int(x) for x in args.clients.split(",")):
        line = json.dumps(point(cell, module, n, args.seed, args.seconds,
                                args.pool_gb, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
