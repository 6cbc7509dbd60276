"""One run of one cell: drive it, judge it, read its metrics.

``run_cell`` is what ``run.py`` calls once it has found the chips; the
tests call it on the CPU at small sizes, with faults planted through
``hooks`` (``{"lm": [fn(lm)], "trainer": [fn(trainer)]}``, each called on
the program's object before the first step).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import os
import tempfile
import time

import numpy as np
import torch

from benchkit import manifest, weights


@dataclasses.dataclass
class Record:
    """What a run leaves for the metric readers."""
    cell: str
    kind: str
    model: dict
    traffic: dict
    layout: object = None        # the configuration's layout module
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)
    steps: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)
    stall: float = 0.0
    trace: object = None
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    itemsize: int = 2
    check_s: float = 0.0         # the reference's time, after the window
    excluded_s: float = 0.0      # stopping the profiler, inside the window
    compared: dict = dataclasses.field(default_factory=dict)
    diag: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        """The window's seconds, less the time spent stopping the
        profiler in a traced run."""
        return self.window[1] - self.window[0] - self.excluded_s

    def quiet_steps(self) -> list:
        """The window's steps outside the profiled slice."""
        return [x for x in self.steps if not x[4]]

    @property
    def quiet_wall(self) -> float:
        """The window's seconds less those of its profiled steps."""
        return self.window_s - sum(x[1] - x[0] for x in self.steps if x[4])

    def quiet_spans(self, name: str) -> list:
        """The window's ``name`` spans outside the profiled slice."""
        tr = self.trace
        return [s for s in self.spans if s[0] == name
                and (tr is None or not tr.t0 <= s[1] <= tr.t1)]


@dataclasses.dataclass
class Ctx:
    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    clock: object
    hooks: dict
    tmpdir: str
    record: Record

    @property
    def cfgd(self) -> dict:
        return self.cell.config

    @property
    def layout(self):
        return self.cell.layout

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def judge_serve(self, rec: Record, sample) -> None:
        from reference import serve
        rows = serve.logit_rows(self.layout, self.cfgd, self.seed, sample,
                                self.device)
        got = serve.gaps(rows, [o for _, o in sample])
        rec.compared.update({k: v for k, v in got.items() if k != "tokens"})

    def judge_train(self, rec: Record, got: dict) -> None:
        rec.compared.update(compare_training(
            self.layout, got, reference_training(self, got["rows"]),
            self.device, got["rows"][0][0]))


def reference_training(ctx, rows, prec: str = "fp32") -> dict:
    """The reference's readings of the cell's first steps, with its first
    gradient stacked into the optimizer's leaves."""
    from reference import train
    grads: dict = {}
    ref = train.train(ctx.layout, ctx.cfgd, ctx.seed, rows,
                      ctx.traffic["optimizer"], ctx.device, prec=prec,
                      first_grads=grads)
    ref["grads"] = ctx.layout.stack_leaves(grads)
    return ref


def worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    """The widest gap between the program's and the reference's norm of a
    leaf, over the larger of the reference's norm of that leaf and the
    median leaf's."""
    if set(prog) != set(ref):
        return math.inf
    med = float(np.median(list(ref.values())))
    keys = [k for k in ref if keep is None or k in keep]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def compare_training(layout, got: dict, ref: dict, device, tokens) -> dict:
    """The numbers a training cell may compare (its limits file says
    which).  ``got`` and ``ref`` hold each step's loss, the first step's
    gradient by leaf (``grads``) and each leaf's change over the steps
    (``change_norms``); ``tokens`` are the first step's token ids, whose
    rows of the layout's token embedding (``TOKEN_LEAF``) are read."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   ref["losses"]))
    if set(got["grads"]) != set(ref["grads"]):
        return {"loss_rel_gap": loss, "grad_norm_gap": math.inf,
                "grad_rel_diff": math.inf, "token_grad_rel_diff": math.inf,
                "change_norm_gap": math.inf}
    gp, g, diff = {}, {}, {}
    for k, t in ref["grads"].items():       # on the card: exact fp32 sums
        a, b = got["grads"][k].to(device).float(), t.to(device).float()
        gp[k], g[k] = float(a.norm()), float(b.norm())
        diff[k] = float((a - b).norm())
    med = float(np.median(list(g.values())))
    # a leaf whose gradient is nought to rounding moves by round-off alone
    moving = {k for k, v in g.items() if v >= 1e-3 * med}
    # each embedding row the first step's tokens use holds that token's
    # own gradient: its relative difference, at the median row
    ids = torch.as_tensor(np.unique(tokens), dtype=torch.long, device=device)
    a = got["grads"][layout.TOKEN_LEAF].to(device)[ids].float()
    b = ref["grads"][layout.TOKEN_LEAF].to(device)[ids].float()
    rows = (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)
    return {"loss_rel_gap": loss,
            "grad_norm_gap": worst_leaf(gp, g),
            "grad_rel_diff": max(diff[k] / max(g[k], med, 1e-30) for k in g),
            "token_grad_rel_diff": float(rows.median()),
            "change_norm_gap": worst_leaf(got["change_norms"],
                                          ref["change_norms"], moving)}


def _tmpdir() -> str:
    return os.path.join(os.environ.get("TMPDIR") or tempfile.gettempdir(),
                        "bench_h100")


def drive(cell: manifest.Cell, seed: int, seconds: float, trace: bool, *,
          device="cuda", clock=None, hooks=None, ctx_cls=Ctx) -> Record:
    """Set-up, window and check of one run: its ``Record``."""
    t0 = time.perf_counter()
    clock = clock or (lambda: time.perf_counter() - t0)
    device = torch.device(device)
    traffic = cell.traffic
    rec = Record(cell=cell.name, kind=traffic["mode"],
                 model=cell.config["model"], traffic=traffic,
                 layout=cell.layout,
                 itemsize=weights.DTYPES[cell.config["dtype"]].itemsize)
    ctx = ctx_cls(cell=cell, seed=int(seed), seconds=seconds,
                  trace=bool(trace), device=device, clock=clock,
                  hooks=hooks or {}, tmpdir=_tmpdir(), record=rec)
    importlib.import_module(f"benchkit.drive_{traffic['mode']}").run(ctx)
    return rec


def result(cell: manifest.Cell, rec: Record, trace: bool, device="cuda",
           root=manifest.ROOT) -> dict:
    """The run's result line as a dict (``compared`` last)."""
    device = torch.device(device)
    limits = cell.limits["limits"]
    compared = {k: {"value": float(rec.compared[k]), "limit": float(v)}
                for k, v in limits.items() if k in rec.compared}
    correct = (rec.failed == 0 and set(compared) == set(limits)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in compared.values()))
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = manifest.reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.entry["chips"],
           "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out = {"correct": bool(correct), "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    out["compared"] = compared
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", clock=None, hooks=None, root=manifest.ROOT,
             cell=None) -> dict:
    """One run of cell ``name``: its result line as a dict."""
    cell = cell or manifest.cell(name, root)
    rec = drive(cell, seed, seconds, trace, device=device, clock=clock,
                hooks=hooks)
    return result(cell, rec, trace, device, root)
