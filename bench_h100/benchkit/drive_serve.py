"""Serving cells: a closed loop of clients driving ``Engine.step``.

Set-up builds the engine on the seed's weights, fills every slot with the
first requests (their answers cut so completions are staggered), prefills
the longest prompt the mix can send once on a spare slot (so the window
meets no new allocation), and runs ``warm_steps`` engine steps.  The
window then runs engine steps for ``seconds``; a client sends its next
request as soon as its last one finished.  Each token is delivered at the
end of the engine step that produced it.

After the window the program's peak memory is read, a sample of the
requests finished in the window (drawn from the seed, the longest always
in it) is kept, the program is freed, and the reference computes its
logits over each prompt and its served tokens: the widest gap by which a
served token's logit lies below the reference's best is compared.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from benchkit import port, profile
from benchkit.traffic import Requests


@dataclasses.dataclass
class Req:
    """A request as its client sees it: when it was sent and when each of
    its tokens came (the end of the step that produced it)."""
    prompt_len: int
    answer_len: int
    sent: float
    times: list = dataclasses.field(default_factory=list)
    finished: float | None = None
    obj: object = None


class Spans:
    """Host-clock spans the benchmark records around calls into the
    program: (name, t0, t1, info); each is also a ``record_function``
    range, so the profiler sees it."""

    def __init__(self) -> None:
        self.items: list = []

    def wrap(self, name: str, fn, info):
        tag = "bench." + name

        def wrapped(*args, **kwargs):
            i = info(*args)
            with torch.profiler.record_function(tag):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                t1 = time.perf_counter()
            self.items.append((name, t0, t1, i))
            return out
        return wrapped


class Collections:
    """The collector's full (generation 2) collections while it is
    attached: how many and their seconds on the host's clock, a pause of
    the host that a host-paced window takes whole (a diagnostic, never
    compared)."""

    def __init__(self) -> None:
        self.n, self.seconds, self._t0 = 0, 0.0, None

    def __call__(self, phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.n += 1
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self) -> "Collections":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


def run(ctx):
    sample = _serve(ctx)           # every tensor of the program dies here
    port.free_cuda()
    t0 = time.perf_counter()
    ctx.judge_serve(ctx.record, sample)
    ctx.record.check_s = time.perf_counter() - t0
    return ctx.record


def _serve(ctx, module=None) -> list:
    """Set-up and window; returns the checked sample (prompt, served).
    ``module``: the program's model on the seed's weights, if already
    built."""
    tr, cfgd, rec, layout = ctx.traffic, ctx.cfgd, ctx.record, ctx.layout
    m = cfgd["model"]
    cfg = layout.arch(cfgd)
    if module is None:
        module = layout.lm_module(cfg, cfgd, ctx.seed, ctx.device)
    lm, eng = layout.engine(cfg, module, tr, ctx.device)
    del module
    spans = Spans()
    lm.prefill_slot = spans.wrap(
        "prefill", lm.prefill_slot,
        lambda slot, prompt: {"prompt": len(prompt),
                              "padded": -(-len(prompt) // lm.page) * lm.page})
    lm.decode_batch = spans.wrap(
        "decode", lm.decode_batch,
        lambda tokens, active: {"lens": (lm.seq_lens + 1).tolist(),
                                "context": (lm.seq_lens[active] + 1).tolist()})
    for hook in ctx.hooks.get("lm", ()):
        hook(lm)
    step = spans.wrap("step", eng.step, lambda: None)

    stream = Requests(tr, ctx.seed, m["vocab_size"])
    live: dict[int, Req] = {}
    done: list[Req] = []

    def send(now: float) -> None:
        k, prompt, answer = stream.next()
        r = port.request(k, prompt, answer)
        live[k] = Req(len(prompt), answer, now, obj=r)
        eng.submit(r)

    # the longest prompt once, on a spare slot: every allocation made
    slot = lm.claim_slot(tr["prompt_tokens"][1], 1)
    lm.prefill_slot(slot, np.zeros(tr["prompt_tokens"][1], np.int32))
    lm.free_slot(slot)
    now = time.perf_counter()
    for _ in range(tr["clients"]):
        send(now)

    # (t0, t1, tokens, stall_s, profiled, pages held, tokens cached,
    #  requests waiting for a slot or pages)
    steps: list = []

    def one_step(profiled: bool) -> float:
        stall0 = eng.decode_stall_s
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        waiting = len(eng.pending)       # sent and still not admitted
        n = 0
        for k, r in list(live.items()):
            got = len(r.obj.out_tokens) - len(r.times)
            r.times.extend([t1] * got)
            n += got
            if r.obj.done:       # the step that finished it also freed it
                r.finished = t1
                done.append(live.pop(k))
                send(t1)
        steps.append((t0, t1, n, eng.decode_stall_s - stall0, profiled,
                      *port.pages_in_use(lm), waiting))
        return t1

    for _ in range(tr["warm_steps"]):
        one_step(False)
    rec.setup_s = ctx.clock()
    n_warm, warm_spans = len(steps), len(spans.items)

    t_start = time.perf_counter()
    t_stop = t_start + ctx.seconds
    sl, done_sl, n_prof = None, None, 0
    prof_at = t_start + ctx.seconds / 3
    with Collections() as collected:
        while True:
            if ctx.trace and done_sl is None and sl is None \
                    and time.perf_counter() >= prof_at:
                sl = profile.Slice()
                sl.start()
            t = one_step(sl is not None)
            if sl is not None:
                n_prof += 1
                if n_prof == tr["profile_steps"]:
                    rec.excluded_s = sl.stop()   # left out of the window
                    t_stop += rec.excluded_s
                    sl, done_sl = None, sl
            if t >= t_stop and sl is None:
                break
    t_end = steps[-1][1]
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if ctx.device.type == "cuda" else 0)

    win = steps[n_warm:]
    rec.window = (t_start, t_end)
    rec.steps = win
    rec.spans = spans.items[warm_spans:]
    rec.trace = done_sl.trace(rec.spans) if done_sl else None
    rec.requests = done + list(live.values())
    rec.stall = sum(s[3] for s in win if not s[4])
    rec.diag = _diagnostics(rec, lm)
    rec.diag.update(gc_full=collected.n, gc_full_s=collected.seconds)
    finished = [r for r in done if t_start < r.finished <= t_end]
    rec.attempted = len(finished)
    rec.failed = sum(len(r.obj.out_tokens) != r.answer_len for r in finished)

    # the sample the reference checks, of the requests the window
    # finished; where it finished fewer than the sample holds, the engine
    # runs on past the close (outside every metric) until it has them
    pool = list(finished)
    t_wait = time.perf_counter() + 60.0
    while len(pool) < tr["check_requests"] and time.perf_counter() < t_wait:
        one_step(False)
        pool = [r for r in done if r.finished > t_start]
    rng = np.random.default_rng([ctx.seed, 3])
    longest = max(pool, key=lambda r: r.prompt_len + r.answer_len)
    rest = [r for r in pool if r is not longest]
    pick = [longest] + [rest[i] for i in rng.choice(
        len(rest), size=min(tr["check_requests"] - 1, len(rest)),
        replace=False)]
    sample = [(np.asarray(r.obj.prompt), np.asarray(r.obj.out_tokens))
              for r in pick]
    for r in rec.requests:
        r.obj = None
    return sample


def _diagnostics(rec, lm) -> dict:
    """What the spread of a run's numbers is looked for in: the decode
    step's time and batch, prefill's share of the window, the pool's use
    and the queue (printed on standard error, never compared)."""
    win = rec.quiet_steps()
    dec = [s for s in rec.spans if s[0] == "decode"]
    pre = [s for s in rec.spans if s[0] == "prefill"]
    per_tok = rec.layout.cache_bytes_per_token(rec.model, rec.itemsize)
    # prefills a window step ran: a step that admits several runs their
    # prefills one after another, and the last of them waits for all
    at = np.searchsorted([s[0] for s in rec.steps], [s[1] for s in pre],
                         side="right") - 1
    per = np.bincount(at[at >= 0], minlength=len(rec.steps))
    held = [s[5] for s in win] or [0]
    cached = [s[6] for s in win] or [0]
    return {
        "steps": len(rec.steps),
        "decode_ms_median": 1e3 * float(np.median(
            [s[2] - s[1] for s in dec])) if dec else None,
        "decode_batch_mean": float(np.mean(
            [len(s[3]["context"]) for s in dec])) if dec else None,
        "prefill_share": sum(s[2] - s[1] for s in pre) / rec.window_s,
        "prefills": len(pre),
        "prefills_per_step_max": int(per.max()) if per.size else 0,
        "prefills_stacked_share": float(per[per >= 2].sum()
                                        / max(per.sum(), 1)),
        "waiting_share": float(np.mean([s[7] > 0 for s in win]))
        if win else None,
        "pool_gb": lm.n_pages * lm.page * per_tok / 1e9,
        "held_gb_max": max(held) * lm.page * per_tok / 1e9,
        "held_gb_mean": float(np.mean(held)) * lm.page * per_tok / 1e9,
        "cached_gb_mean": float(np.mean(cached)) * per_tok / 1e9,
        "cached_gb_max": max(cached) * per_tok / 1e9,
    }
