#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the chips of this machine.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and metrics come from ``BENCHMARK.json`` and the files it names
(see ``bench_h100/README.md``).  The run builds the program on the seed's
weights, warms up, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints, as its last lines, each
compared number beside its limit on standard error and one JSON result
line on standard output.  ``--trace 1`` profiles a slice of the window
and reports the per-layer metrics instead of the end-to-end ones.

Exit codes: 0 with a result; 2 without enough CUDA devices; 3 if JAX or
the JAX package was loaded; any other failure raises (exit 1).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _since_process_start():
    """A clock reading the seconds since this process started."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        t0 = start / os.sysconf("SC_CLK_TCK")
        return lambda: time.clock_gettime(time.CLOCK_BOOTTIME) - t0
    except (OSError, ValueError, IndexError):
        t0 = time.perf_counter()
        return lambda: time.perf_counter() - t0


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or its package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    clock = _since_process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel and extension caches at fixed paths inside the checkout
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          str(ROOT / "build" / "repro_torch"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(HERE), str(ROOT / "src")]

    from benchkit import manifest
    cell = manifest.cell(args.workload, ROOT)

    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from benchkit.cell import drive, result
    rec = drive(cell, args.seed, args.seconds, bool(args.trace),
                device="cuda", clock=clock)
    out = result(cell, rec, bool(args.trace), "cuda", ROOT)
    print(f"setup_s {rec.setup_s!r} window_s {rec.window_s!r} "
          f"check_s {rec.check_s!r}", file=sys.stderr)
    if rec.diag:
        print(f"diagnostics {json.dumps(rec.diag)}", file=sys.stderr)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in rec.compared.items():
        if k not in out["compared"]:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, c in out["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
