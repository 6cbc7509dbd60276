"""Multi-node serving with live RDMA KV-page migration, on the PyTorch port.

  PYTHONPATH=src python examples/cluster_serving_torch.py            # card
  PYTHONPATH=src python examples/cluster_serving_torch.py --device cpu

The port's counterpart of ``examples/cluster_serving.py``: the three
cluster mechanisms.

  1. ROUTER     — requests are admitted to the least-loaded node of a
                  4-ring torus fabric carrying two serving replicas;
  2. MIGRATION  — a running request's KV pages move to another node as one
                  bulk dimension-ordered RDMA PUT (``put_pages`` over a
                  ``fabric.lower_p2p`` schedule) and decode resumes there
                  with bitwise-identical tokens;
  3. FAULT REROUTE — the direct link dies (LO|FA|MO feeds the fault map);
                  the next migration takes the BFS detour: more hops,
                  honestly higher modelled cost, same tokens.

Both replicas live on one device (the card unless asked otherwise), and a
migration's seconds are the modelled fabric's.  The last line gives the
kernels' launches (K1 decode, K2 prefill on the card).
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core.topology import Torus  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.cluster import ServingCluster, owners  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    cfg = configs.get_reduced("qwen2-0.5b")
    model = api.get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    # 4-ring fabric, serving nodes at ranks 0 and 1 (2 and 3 route only)
    cluster = ServingCluster(cfg, params, torus=Torus((4,)),
                             node_ranks=(0, 1), max_batch=4, max_seq=64,
                             page_tokens=8, device=dev)

    rng = np.random.default_rng(0)
    rids = list(range(4))
    for rid in rids:
        plen = int(rng.integers(5, 16))
        placed = cluster.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, size=(plen,)).astype(np.int32),
            max_new_tokens=10))
        print(f"router: request {rid} (prompt {plen} tok) -> node {placed}")

    for _ in range(4):          # prefill + a few decode steps everywhere
        cluster.step()

    # -- live migration off node 0 -------------------------------------------
    rid = next(r.rid for r in cluster.nodes[0].engine.running.values())
    rep = cluster.migrate(rid, 1)
    print(f"\nmigrated request {rep.rid}: node {rep.src} -> {rep.dst}, "
          f"{rep.n_pages} pages / {rep.nbytes / 1e3:.1f} KB over "
          f"{rep.hops} hop(s)")
    print(f"  modelled PUT {rep.modelled_s * 1e6:.1f} us vs re-prefill "
          f"stall {rep.reprefill_s * 1e6:.1f} us")

    # -- the same move through a dead link ------------------------------------
    cluster.fail_link(0, 1)
    rid2 = next((r.rid for r in cluster.nodes[0].engine.running.values()),
                None)
    if rid2 is not None:
        rep2 = cluster.migrate(rid2, 1)
        print(f"\nlink (0,1) dead -> request {rep2.rid} rerouted over "
              f"{rep2.hops} hops (healthy route: {rep2.min_hops}); "
              f"rerouted={rep2.rerouted}")

    cluster.run_to_completion()
    st = cluster.stats()
    print(f"\nfinished {len(cluster.finished)}/{len(rids)} requests, "
          f"{st['n_migrations']} migrations "
          f"({st['migrated_bytes'] / 1e3:.1f} KB KV moved, "
          f"{st['rerouted_migrations']} rerouted)")
    for r, ns in st["nodes"].items():
        print(f"  node {r}: {ns['decode_steps']} decode steps, "
              f"tlb_hit_rate={ns['tlb_hit_rate']:.3f}")
    assert len(cluster.finished) == len(rids)
    assert owners(cluster, rids) == {rid: None for rid in rids}
    print("kernel launches:", json.dumps(ops.launch_counts()))
    print("cluster serving OK")


if __name__ == "__main__":
    main()
