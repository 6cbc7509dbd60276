"""Expert-parallel MoE over the all-to-all, on the PyTorch port.

  PYTHONPATH=src python examples/ep_moe_demo_torch.py

The port's counterpart of ``examples/ep_moe_demo.py``: one MoE layer run
three ways on 8 CPU ranks (gloo, a ("data", "model") mesh of 2 x 4), shown
to agree while communicating very differently:

  1. dense reference      — every expert on every token (no dispatch);
  2. global sort dispatch — each rank gathers the whole batch's tokens and
     dispatches them all (``moe.apply_moe_global``);
  3. expert-parallel      — each rank routes its own block of tokens and
     sends only the capacity-bounded expert buffers across "model": two
     all-to-alls (``moe.apply_moe_ep``), the paper's torus all-to-all.

Each way's collectives are counted by ``parallel.spmd``'s counters.  The
script starts its 8 ranks itself (``torch.multiprocessing``, a file store
in a temporary directory) and imports nothing of the JAX package.
"""
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import MoeCfg  # noqa: E402
from repro_torch.parallel import sharding, spmd  # noqa: E402

WORLD, MESH = 8, (2, 4)


def dense_reference(cfg, p, x):
    """y_t = sum_k p_k FFN_{e_k}(x_t), every expert on every token."""
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt.float() @ p["router"], -1)
    top_p, top_e = torch.topk(probs, cfg.moe.top_k, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    g = F.silu(torch.einsum("td,edf->tef", xt, p["w_gate"]))
    u = torch.einsum("td,edf->tef", xt, p["w_up"])
    every = torch.einsum("tef,efd->ted", g * u, p["w_down"])
    sel = torch.gather(every, 1, top_e[..., None].expand(-1, -1,
                                                         xt.shape[-1]))
    return (sel * top_p[..., None]).sum(1).reshape(x.shape)


def rank_main(rank: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    mesh = make_mesh(MESH, ("data", "model"))
    cfg = dataclasses.replace(
        configs.get_config("olmoe-1b-7b").reduced(),
        moe=MoeCfg(n_experts=8, top_k=2, d_expert=32, capacity_factor=8.0),
        d_model=64, dtype=torch.float32, moe_impl="ep_a2a")
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(4, 16, cfg.d_model)) * 0.3)
                         .astype(np.float32))
    rows = spmd.shard(x, (("data",),), mesh)     # this rank's batch rows
    want = dense_reference(cfg, p, x)
    out, counts = {}, {}
    sharding.set_runtime_mesh(mesh, (("data",),))
    try:
        with torch.no_grad():
            for way, fn in (("global", moe.apply_moe_global),
                            ("ep", moe.apply_moe_ep)):
                spmd.reset_counts()
                y, _ = fn(cfg, p, rows)
                counts[way] = dict(spmd.counts)
                out[way] = spmd.unshard(y, (("data",),), mesh)
    finally:
        sharding.set_runtime_mesh(None)
    if rank == 0:
        for way in ("global", "ep"):
            err = float((out[way] - want).abs().max())
            ok = torch.allclose(out[way], want, rtol=2e-4, atol=2e-4)
            print(f"{way:6s} dispatch == dense reference: {ok} "
                  f"(max |diff| {err:.2e})")
        for way in ("global", "ep"):
            n = {f"{op}/{tag}": c for (op, tag), c in counts[way].items()}
            print(f"collectives a rank ran, {way}: {n}")
        print("(8 experts live 2 a rank on the 4-way 'model' axis; each rank "
              "routed its own tokens and exchanged capacity buffers by two "
              "all-to-alls)")
        print("ep moe demo OK")
    dist.destroy_process_group()


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(os.path.join(tmp, "store"),),
                 nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
