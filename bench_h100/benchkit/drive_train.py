"""Training cells: ``Trainer.train_step`` in a loop.

Set-up builds one trainer on the seed's weights and drives it through its
first ``checked_steps`` steps with the window's own call on the seed's
rows; those steps are also its warm-up.  It keeps what the check reads of
them: each step's loss, the norm of each leaf's first gradient as the
optimizer took it (from its first moment) and, after the last of them,
the norm of each leaf's change from the seed's weights.  The window then
runs the same trainer's steps for ``seconds`` on fresh rows.

After the window the program's peak memory is read, the trainer is freed
and the reference trains from the same weights on the same rows.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from benchkit import port, profile, weights
from benchkit.drive_serve import Collections, Spans
from benchkit.traffic import Rows


def run(ctx):
    got = _train(ctx)              # every tensor of the program dies here
    port.free_cuda()
    t0 = time.perf_counter()
    ctx.judge_train(ctx.record, got)
    ctx.record.check_s = time.perf_counter() - t0
    return ctx.record


def _change_norms(layout, cfgd, seed, named, device) -> dict[str, float]:
    m, dtype = cfgd["model"], weights.DTYPES[cfgd["dtype"]]
    start = dict(layout.outer_weights(m, seed, device, dtype))
    sq: dict[str, float] = {}
    layer_at, cache = None, {}
    for name, t in named:
        i, key = weights.split(name)
        if i is None:
            t0 = start[name]
        else:
            if i != layer_at:
                layer_at = i
                cache = layout.layer_weights(m, seed, i, device, dtype)
            t0 = cache[key]
        leaf = layout.leaf_of(name)
        sq[leaf] = sq.get(leaf, 0.0) + float(
            (t.float() - t0.float()).square().sum())
    return {k: math.sqrt(v) for k, v in sq.items()}


def _train(ctx) -> dict:
    tr, cfgd, rec, layout = ctx.traffic, ctx.cfgd, ctx.record, ctx.layout
    m = cfgd["model"]
    cfg = layout.arch(cfgd)
    data = Rows(tr, ctx.seed, m["vocab_size"])
    module = layout.lm_module(cfg, cfgd, ctx.seed, ctx.device)
    ckpt = os.path.join(ctx.tmpdir, "ckpt")
    trainer = layout.trainer(cfg, module, tr, ctx.seed, ctx.device, ckpt,
                             data)
    del module
    for hook in ctx.hooks.get("trainer", ()):
        hook(trainer)
    spans = Spans()
    step = spans.wrap("train_step", trainer.train_step, lambda: None)

    got = {"losses": []}
    for i in range(tr["checked_steps"]):
        got["losses"].append(step()["loss"])
        if i == 0:
            got["grads"] = layout.first_gradient(trainer,
                                                 tr["optimizer"]["b1"])
    got["change_norms"] = _change_norms(layout, cfgd, ctx.seed,
                                        layout.named_weights(trainer),
                                        ctx.device)
    got["rows"] = [data.rows(i) for i in range(tr["checked_steps"])]
    rec.setup_s = ctx.clock()
    n_warm = len(spans.items)

    t_start = time.perf_counter()
    t_stop = t_start + ctx.seconds
    sl, done_sl, n_prof = None, None, 0
    prof_at = t_start + ctx.seconds / 3
    steps, losses = [], []
    with Collections() as collected:
        while True:
            if ctx.trace and done_sl is None and sl is None \
                    and time.perf_counter() >= prof_at:
                sl = profile.Slice()
                sl.start()
            t0 = time.perf_counter()
            loss = step()["loss"]
            t1 = time.perf_counter()
            steps.append((t0, t1, tr["batch"] * tr["seq_len"], 0.0,
                          sl is not None))
            losses.append(loss)
            if sl is not None:
                n_prof += 1
                if n_prof == tr["profile_steps"]:
                    rec.excluded_s = sl.stop()   # left out of the window
                    t_stop += rec.excluded_s
                    sl, done_sl = None, sl
            if t1 >= t_stop and sl is None:
                break
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if ctx.device.type == "cuda" else 0)
    rec.window = (t_start, steps[-1][1])
    rec.steps = steps
    rec.spans = spans.items[n_warm:]
    rec.trace = done_sl.trace(rec.spans) if done_sl else None
    quiet = [t1 - t0 for t0, t1, *_ in rec.quiet_steps()] or [0.0]
    rec.diag = {"step_ms_p10": 1e3 * float(np.percentile(quiet, 10)),
                "step_ms_median": 1e3 * float(np.median(quiet)),
                "step_ms_p90": 1e3 * float(np.percentile(quiet, 90)),
                "gc_full": collected.n, "gc_full_s": collected.seconds}
    rec.attempted = len(steps)
    rec.failed = sum(not math.isfinite(x) for x in losses)
    return got
