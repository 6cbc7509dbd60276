"""The APEnet+ fabric itself, on the PyTorch port: 3D-torus RDMA and ring
collectives over 8 ranks.

  PYTHONPATH=src python examples/torus_demo_torch.py

The port's counterpart of ``examples/torus_demo.py``:
  * 3D-torus coordinate math, dimension-ordered routing, hop metrics;
  * one-sided RDMA put over a mesh axis (``rdma.put_shift``: one
    ``torch.distributed`` point-to-point round a hop);
  * the bidirectional double-buffered ring all-reduce ("dual DMA
    engines") equal to the sum, every rank holding the same fp32 bits;
  * the APElink efficiency / latency models reproducing the paper numbers.

The script starts its 8 ranks itself as CPU processes (gloo, a file store
in a temporary directory): one card cannot host eight NCCL ranks, and the
collectives' point-to-point rounds are what is shown, not their speed.
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

from repro_torch.core import apelink, rdma  # noqa: E402
from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.core.lofamo import awareness_time_model  # noqa: E402
from repro_torch.core.topology import Torus  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

WORLD = 8


def rank_main(rank: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    if rank == 0:
        # --- topology: the QUonG 4x4x1 deployment ----------------------------
        t = Torus((4, 4, 1))
        print(f"QUonG torus {t.dims}: {t.size} nodes, diameter "
              f"{t.diameter}, {len(t.links())} links, bisection "
              f"{t.bisection_links} links")
        src, dst = 0, t.rank((2, 3, 0))
        print(f"dimension-ordered route {t.coords(src)} -> "
              f"{t.coords(dst)}: {[t.coords(r) for r in t.route(src, dst)]}")

    # --- RDMA put over a mesh axis -------------------------------------------
    mesh = make_mesh((WORLD,), ("x",))
    x = torch.arange(WORLD * 3, dtype=torch.float32).reshape(WORLD, 3)
    shifted = rdma.put_shift(x[rank], "x", mesh, +1)
    put_ok = torch.tensor(int(torch.equal(shifted, torch.roll(x, 1, 0)[rank])))
    dist.all_reduce(put_ok, op=dist.ReduceOp.MIN)

    # --- bidirectional ring all-reduce vs the sum ----------------------------
    v = torch.from_numpy(np.random.default_rng(0).normal(
        size=(WORLD, 1000)).astype(np.float32))
    ours = C.make_stacked_all_reduce(mesh, ("x",))(v)
    want = v.sum(0)
    close = torch.tensor(int(torch.allclose(ours, want, rtol=2e-5,
                                            atol=1e-5)))
    dist.all_reduce(close, op=dist.ReduceOp.MIN)
    every = [torch.empty_like(ours) for _ in range(WORLD)]
    dist.all_gather(every, ours)
    same_bits = all(torch.equal(e, every[0]) for e in every)
    if rank == 0:
        print("rdma.put_shift(+1) moved every rank's row to its +X "
              f"neighbour: {bool(put_ok)}")
        print("bidirectional double-buffered ring all-reduce == sum: "
              f"{bool(close)} (every rank holds the same fp32 bits: "
              f"{same_bits})")

        # --- the paper's numbers ---------------------------------------------
        net = apelink.NetModel()
        print("\npaper model reproduction:")
        print(f"  APElink efficiency          "
              f"{apelink.protocol_efficiency():.3f}   (paper 0.784)")
        print(f"  sustained link bandwidth    "
              f"{apelink.sustained_bandwidth()/1e9:.2f} GB/s (paper ~2.2)")
        print(f"  GPU-GPU latency, P2P        "
              f"{net.latency(32, src_gpu=True, dst_gpu=True)*1e6:.1f} us "
              "(paper ~8.2)")
        staged = net.latency(32, src_gpu=True, dst_gpu=True, p2p=False)
        print(f"  GPU-GPU latency, staged     {staged * 1e6:.1f} us "
              "(paper ~16.8)")
        print(f"  GPU-GPU latency, IB+MVAPICH "
              f"{net.latency(32, fabric='ib')*1e6:.1f} us (paper ~17.4)")
        print(f"  LO|FA|MO Ta @ WD=500ms      "
              f"{awareness_time_model(0.5):.2f} s (paper 0.9)")
        assert bool(put_ok) and bool(close) and same_bits
        print("\ntorus demo OK")
    dist.destroy_process_group()


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(os.path.join(tmp, "store"),),
                 nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
