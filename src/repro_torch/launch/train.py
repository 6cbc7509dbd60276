"""Training launcher.

The counterpart of the JAX package's ``launch/train.py``, with its flags
plus ``--device``.  ``--comm gspmd`` is the default, as in JAX: the
parameters, AdamW moments and batch sharded by ``parallel/sharding.py``'s
specs over a ("data", "model") mesh (``--mesh dp,tp``; default: every
rank on "data").  One process is one rank, launched under ``torchrun``
(NCCL on cards, one device a rank; gloo with ``--device cpu``):

  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch smollm-135m --reduced --mesh 4,2 --device cpu

With one rank it trains ``single``, as JAX's launcher does on one device.
On the card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 10 --batch 8 --seq 1024

``--comm apex`` is the paper-faithful explicit torus-collective data
parallelism (bidirectional ring reduce-scatter / all-gather as
``torch.distributed`` point-to-point rounds) over a one-axis mesh of every
rank.  The JAX launcher's ``--devices`` (forced host devices) has no
counterpart: ranks are processes.  At exit the lead rank prints the
process hub's span summary: count, total and self milliseconds per span
name.
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="",
                    help="mesh as 'dp,tp' (gspmd; default: all ranks on dp)")
    ap.add_argument("--comm", choices=["gspmd", "apex", "single"],
                    default="gspmd")
    ap.add_argument("--ckpt-dir", default="/tmp/apex_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per optimizer step")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one device a rank) or cpu")
    return ap.parse_args(argv)


def resolve_comm(comm: str, world: int) -> str:
    """One rank trains single, whatever ``--comm`` says (JAX: one device)."""
    return comm if world > 1 else "single"


def parse_mesh(spec: str, world: int) -> tuple[int, int]:
    """``--mesh 'dp,tp'`` as (dp, tp); default every rank on "data"."""
    if not spec:
        return world, 1
    dp, tp = (int(x) for x in spec.split(","))
    return dp, tp


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core.fabric import process_hub
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = None
    args.comm = resolve_comm(args.comm, world)
    if args.comm != "single":
        cuda = torch.device(args.device).type == "cuda"
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        # torchrun's environment (MASTER_ADDR, RANK, WORLD_SIZE)
        dist.init_process_group("nccl" if cuda else "gloo")
        if args.comm == "apex" and not args.mesh:
            mesh = make_mesh((world,), ("data",))
        else:       # --mesh dp,tp, or every rank on "data" (JAX's order)
            mesh = make_mesh(parse_mesh(args.mesh, world), ("data", "model"))

    opt = AdamWConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10),
                      total_steps=max(args.steps, 1))
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         opt=opt, batch=args.batch, seq_len=args.seq,
                         comm=args.comm, dp_axis="data", seed=args.seed,
                         grad_accum=args.grad_accum)
    tr = Trainer(cfg, tcfg, mesh=mesh, device=args.device)
    if args.resume:
        try:
            tr.resume()
        except FileNotFoundError:
            print("[train] no checkpoint found; starting fresh")
    lead = not dist.is_initialized() or dist.get_rank() == 0
    if lead:
        print(f"[train] arch={cfg.name} params={tr.n_params:,} "
              f"ranks={world} comm={args.comm} device={tr.device}")
    for m in tr.train(args.steps):
        if lead:
            print(f"  step {m['step']:>5d}  loss {m['loss']:.4f}  "
                  f"{m['step_time_s']*1e3:7.1f} ms")
    if tr.events and lead:
        print("[events]")
        for e in tr.events:
            print("  ", e)
    losses = [m["loss"] for m in tr.metrics_log]
    if lead:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        print(process_hub().span_summary())
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
