#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size.

    python3 bench_h100/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--out FILE]

For each seed, in one process: a run of the cell (a short window at the
cell's own load), the program's compared numbers, and the control's —
the reference put in the program's place and computed in float8 (e4m3
operands, e5m2 gradients) in place of the configuration's bf16.  A
serving cell's control is read at each answering position of the same
prompts and served tokens: the fp32 reference's gap of the token the fp8
reference puts first.  A training cell also reads the planted fault
"half of the batch left out" in a second run of the program on the same
seed; "a step that returns its state unchanged" reads 1 by construction
(no weight moves) and is not run.  One JSON line a seed.  With
``--routes``, a training cell's routing of its first step's tokens by the
program and by the reference, compared layer by layer, instead.

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(cell, seed: int, seconds: float, device="cuda",
             fault: bool = True) -> dict:
    from benchkit import cell as C
    from benchkit import faults, port
    from reference import serve

    class Ctx(C.Ctx):
        def judge_serve(self, rec, sample):
            served = [o for _, o in sample]
            rows = serve.logit_rows(self.layout, self.cfgd, self.seed,
                                    sample, self.device)
            rec.compared = serve.gaps(rows, served)
            low = serve.logit_rows(self.layout, self.cfgd, self.seed,
                                   sample, self.device, prec="fp8")
            first = [r.argmax(-1).cpu().numpy() for r in low]
            rec.control = serve.gaps(rows, first)

        def judge_train(self, rec, got):
            ref = C.reference_training(self, got["rows"])
            first = got["rows"][0][0]
            rec.compared.update(C.compare_training(
                self.layout, got, ref, self.device, first))
            low = C.reference_training(self, got["rows"], prec="fp8")
            rec.control = C.compare_training(self.layout, low, ref,
                                             self.device, first)
            ref["grads"] = {k: t.cpu() for k, t in ref["grads"].items()}
            rec.ref = ref           # kept on the host for the fault's run

    rec = C.drive(cell, seed, seconds, False, device=device, ctx_cls=Ctx)
    out = {"seed": seed, "program": rec.compared, "control": rec.control,
           "attempted": rec.attempted, "failed": rec.failed}
    if rec.kind == "train" and fault:
        ref = rec.ref

        class Fault(C.Ctx):
            def judge_train(self, r, got):
                r.compared.update(C.compare_training(
                    self.layout, got, ref, self.device, got["rows"][0][0]))

        port.free_cuda()
        bad = C.drive(cell, seed, min(seconds, 1.0), False, device=device,
                      ctx_cls=Fault,
                      hooks={"trainer": [faults.half_batch_train]})
        out["half_batch"] = bad.compared
    return out


def _kept(flat_e, K: int, E: int, C: int) -> set:
    """The (token, expert) rows the capacity keeps: of the rows routed to
    each expert, in (token, k) order, the first C."""
    kept = set()
    for e in range(E):
        idx = (flat_e == e).nonzero()[:C, 0].tolist()
        kept.update((i // K, e) for i in idx)
    return kept


def route_flips(prog, ref, K: int, E: int, factor: float) -> dict:
    """How the program's routing of the first step's tokens departs from
    the reference's, layer by layer: the share of tokens whose top-k set
    differs, of routed rows in one set and not the other, and of rows
    that the capacity keeps on one side and drops on the other."""
    out = {"tokens_flipped": [], "rows_flipped": [], "kept_differs": [],
           "dropped_program": [], "dropped_reference": []}
    for p, r in zip(prog, ref):
        p, r = p.cpu(), r.cpu()
        T = p.numel() // K
        ps, rs = p.view(T, K).sort(-1).values, r.view(T, K).sort(-1).values
        out["tokens_flipped"].append(float((ps != rs).any(-1).float().mean()))
        same = sum(len(set(a) & set(b)) for a, b in zip(ps.tolist(),
                                                        rs.tolist()))
        out["rows_flipped"].append(1 - same / (T * K))
        C = max(int(T * K / E * factor), K)
        kp, kr = _kept(p, K, E, C), _kept(r, K, E, C)
        out["kept_differs"].append(len(kp ^ kr) / (2 * T * K))
        out["dropped_program"].append(1 - len(kp) / (T * K))
        out["dropped_reference"].append(1 - len(kr) / (T * K))
    return out


def routes(cell, seed: int, device="cuda") -> dict:
    """The routing of a training cell's first step, in the program and in
    the reference, compared (``route_flips``)."""
    from benchkit import cell as C
    from reference import ops

    m = cell.config["model"]
    L, K, E = (m["num_hidden_layers"], m["num_experts_per_tok"],
               m["num_experts"])
    ref: list = []

    class Ctx(C.Ctx):
        def judge_train(self, rec, got):
            ops.ROUTES = ref
            try:
                C.reference_training(self, got["rows"][:1])
            finally:
                ops.ROUTES = None

    with cell.layout.recorded_routes([], L) as prog:
        C.drive(cell, seed, 1.0, False, device=device, ctx_cls=Ctx)
    factor = cell.config["assumed"]["moe_capacity_factor_train"]
    return {"seed": seed, **route_flips(prog, ref[:L], K, E, factor)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    ap.add_argument("--no-fault", action="store_true",
                    help="skip a training cell's planted fault")
    ap.add_argument("--routes", action="store_true",
                    help="compare a training cell's routing of its first "
                    "step with the reference's, instead")
    args = ap.parse_args(argv)
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          str(ROOT / "build" / "repro_torch"))
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    from benchkit import manifest, port

    cell = manifest.cell(args.workload, ROOT)
    for s in args.seeds.split(","):
        line = json.dumps(routes(cell, int(s)) if args.routes else
                          readings(cell, int(s), args.seconds,
                                   fault=not args.no_fault))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        port.free_cuda()
    return 0


if __name__ == "__main__":
    sys.exit(main())
