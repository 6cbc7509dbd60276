"""Fault-tolerant data-parallel training over the torus fabric (paper §4),
on the PyTorch port.

  PYTHONPATH=src python examples/fault_tolerant_train_torch.py

The port's counterpart of ``examples/fault_tolerant_train.py``.  It runs
the paper-faithful "apex" communication mode (explicit bidirectional ring
reduce-scatter / all-gather over the torus, lowered through the fabric's
CollectiveSchedule IR, run as ``torch.distributed`` point-to-point
rounds) on 8 ranks, and exercises BOTH fault-handling paths:

1. a torus LINK dies: LO|FA|MO's neighbour watchdogs each suspect the
   peer, the master correlates the two still-heartbeating endpoints into a
   link fault, and the trainer *reroutes* — the collective schedules are
   rewritten around the dead link (detour hops, higher predicted comm
   cost) and training continues with identical numerics, no restart;

2. a whole NODE dies: detection diffuses to the neighbours, the master
   flags the rank, and the trainer checkpoint-restarts on the surviving
   ranks (elastic re-mesh 8 -> 4) replaying the data stream; the dropped
   ranks leave the loop.

The script starts its 8 ranks itself as CPU processes (gloo, a file store
and a checkpoint directory in a temporary directory): one card cannot host
eight NCCL ranks.
"""
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core.lofamo import awareness_time_model  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

WORLD = 8


def rank_main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD)
    cfg = configs.get_config("qwen2-0.5b").reduced()
    mesh = make_mesh((WORLD,), ("data",))
    tcfg = TrainerConfig(
        ckpt_dir=os.path.join(tmp, "ckpt"), ckpt_every=5, batch=8,
        seq_len=32, opt=AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=40),
        comm="apex", dp_axis="data", fault_mode="reroute", wd_period=0.5)
    tr = Trainer(cfg, tcfg, mesh=mesh, device="cpu")
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[fabric] torus dims={tr.torus.dims}, comm=apex "
        f"(CollectiveSchedule-lowered torus ring collectives)")
    say(f"[fabric] predicted grad-sync: "
        f"{tr.predicted_comm_s * 1e3:.2f} ms/step")

    def fault_hook(i):
        if i == 2:
            say("[fault]  cutting link (2,3) ...")
            tr.lofamo.kill_link(2, 3)
        if i == 8:
            say("[fault]  killing node 5 (host+NIC) ...")
            tr.lofamo.kill_node(5)

    metrics = tr.train(16, fault_hook=fault_hook)
    if tr.active and rank == 0:
        losses = [m["loss"] for m in metrics]
        print(f"[train]  losses: {losses[0]:.3f} ... {losses[-1]:.3f}")
        assert all(np.isfinite(x) for x in losses)
        print("[events]")
        for e in tr.events:
            print("   ", e)
        # link fault -> reroute, no restart
        assert any("rerouted collectives" in e for e in tr.events), \
            "link reroute expected"
        # node fault -> elastic re-mesh
        assert any("re-mesh" in e for e in tr.events), "re-mesh expected"
        assert tr.mesh.size == 4
        # predicted vs measured communication for the last step
        last = metrics[-1]
        print(f"[cost]   predicted comm {last['predicted_comm_s'] * 1e3:.2f}"
              f" ms vs measured step {last['step_time_s'] * 1e3:.1f} ms")
        # LO|FA|MO awareness-time model at this watchdog period
        print(f"[lofamo] Ta(WD=500ms) = {awareness_time_model(0.5):.2f} s "
              "(paper: 0.9 s)")
        print("fault-tolerant training OK "
              "(link rerouted, then 8 -> 4 ranks, training continued)")
    dist.destroy_process_group()


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(tmp,), nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
