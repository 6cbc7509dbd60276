"""Schedule executor — walks a ``CollectiveSchedule`` and runs it as
``torch.distributed`` point-to-point rounds.

The counterpart of the JAX package's ``core/fabric/execute.py``, which
emits a shard_map/ppermute program.  Every entry point is *per-rank* code:
it takes this rank's array and the ``Mesh`` (``repro_torch.launch.mesh``)
that binds the schedule's axis names to process groups; ``axis_index`` is
this rank's position in its line of the axis.  The executor derives
nothing about rings or hops itself — perms come verbatim from the
schedule's transfers, so a fault-rewritten schedule executes with zero
extra code.

One ppermute is a set of ``dist.P2POp``s: this rank sends to the position
its (src, dst) pair names and receives from the position that names it; a
rank that no pair addresses receives zeros.  Every ``Step`` of a schedule
is ONE ``dist.batch_isend_irecv`` round, and both directions of a
bidirectional phase go into that same batch — the two DMA engines of an
APEnet+ link (paper §2.1, Fig 1): n-1 rounds for a ring of n, each moving
two data-independent half-chunks.  ``schedule.rounds`` is the sequential
depth.

Numerics: ring reductions accumulate in fp32 when inputs are lower
precision (bf16/fp16), in the schedule's order, so they equal the JAX
executor's sums.  Layouts match it too: reduce-scatter hands ring-slot r
the contiguous chunk r (front half via the +1 ring, back half via the -1
ring), all-gather returns slot-ordered rows.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.fabric.schedule import (
    A2A, AG, AR, HALO, RS, BucketPlan, CollectiveSchedule, Phase)

# ----------------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------------


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_floating_point and torch.finfo(dtype).bits < 32:
        return torch.float32
    return dtype


def _flatten_pad(x: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """Flatten to 1D and zero-pad so the length divides ``n``."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, flat.numel() // n


def ring_slot(phase: Phase, mesh, axis_name: str | None = None) -> int:
    """This rank's slot on the phase ring (= axis index when the ring is
    the identity).  Ranks at dead positions get slot 0 — their output is
    undefined, they send nothing and receive zeros."""
    axis = axis_name or phase.axis
    pos = mesh.axis_index(axis)
    n = mesh.shape[axis]
    if phase.ring == tuple(range(n)):
        return pos
    inv = np.zeros((n,), np.int64)
    for j, p in enumerate(phase.ring):
        inv[p] = j
    return int(inv[pos])


def _phase_perms(phase: Phase) -> list[list[tuple[int, int]]]:
    return [list(tr.perm) for tr in phase.steps[0].transfers]


def ppermute_round(sends, axis: str, mesh) -> list[torch.Tensor]:
    """One round: every (x, perm) of ``sends`` moves concurrently in ONE
    ``batch_isend_irecv``.  Returns what each perm delivered to this rank
    (zeros where no pair addresses it)."""
    me = mesh.axis_index(axis)
    line, group = mesh.line(axis), mesh.group(axis)
    ops, outs = [], []
    for tag, (x, perm) in enumerate(sends):
        x = x.contiguous()
        out = torch.zeros_like(x)
        outs.append(out)
        if x.numel() == 0:     # an empty half-chunk: nothing on the wire
            continue
        for s, d in perm:
            if s == me and d == me:
                out.copy_(x)
            elif s == me:
                ops.append(dist.P2POp(dist.isend, x, line[d], group, tag))
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, out, line[s], group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return outs


# ----------------------------------------------------------------------------
# reduce-scatter
# ----------------------------------------------------------------------------

def _rs_directed(acc, axis, mesh, perm, slot, m: int, sgn: int, nsteps: int):
    """One directed ring pass over ``acc`` of shape (m, chunk); returns the
    fully reduced chunk owned by this rank's slot."""
    for s in range(nsteps):
        send_idx = (slot - sgn * (s + 1)) % m
        recv_idx = (slot - sgn * (s + 2)) % m
        (got,) = ppermute_round([(acc[send_idx], perm)], axis, mesh)
        acc[recv_idx] = acc[recv_idx] + got
    return acc[slot]


def _rs_bidi(acc_f, acc_b, axis, mesh, perm_f, perm_b, slot, m: int,
             nsteps: int):
    """Both ring directions advanced per round — the fused dual-DMA pass."""
    for s in range(nsteps):
        send_f, recv_f = (slot - (s + 1)) % m, (slot - (s + 2)) % m
        send_b, recv_b = (slot + (s + 1)) % m, (slot + (s + 2)) % m
        got_f, got_b = ppermute_round(
            [(acc_f[send_f], perm_f), (acc_b[send_b], perm_b)], axis, mesh)
        acc_f[recv_f] = acc_f[recv_f] + got_f
        acc_b[recv_b] = acc_b[recv_b] + got_b
    return acc_f[slot], acc_b[slot]


def _exec_rs_phase(work: torch.Tensor, phase: Phase, mesh) -> torch.Tensor:
    """Reduce-scatter one ring phase over flat ``work``; returns this
    slot's fp32-accumulated chunk (front half via +1, back half via -1)."""
    m = phase.ring_size
    flat, chunk = _flatten_pad(work, max(m, 1))
    if m <= 1 or not phase.steps:
        return flat.to(_acc_dtype(work.dtype))
    acc = flat.reshape(m, chunk).to(_acc_dtype(work.dtype)).clone()
    slot = ring_slot(phase, mesh)
    perms = _phase_perms(phase)
    nsteps = len(phase.steps)
    if phase.directions == 2:
        half = chunk // 2
        out_f, out_b = _rs_bidi(acc[:, :half].contiguous(),
                                acc[:, half:].contiguous(), phase.axis, mesh,
                                perms[0], perms[1], slot, m, nsteps)
        out = torch.cat([out_f, out_b], dim=0)
    else:
        out = _rs_directed(acc, phase.axis, mesh, perms[0], slot, m, +1,
                           nsteps)
    return out / m if phase.mean else out


# ----------------------------------------------------------------------------
# all-gather
# ----------------------------------------------------------------------------

def _ag_directed(x, axis, mesh, perm, slot, m: int, sgn: int, nsteps: int):
    out = torch.zeros((m,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out[slot] = x
    cur = x
    for s in range(nsteps):
        (cur,) = ppermute_round([(cur, perm)], axis, mesh)
        out[(slot - sgn * (s + 1)) % m] = cur
    return out


def _ag_bidi(x_f, x_b, axis, mesh, perm_f, perm_b, slot, m: int,
             nsteps: int):
    out_f = torch.zeros((m,) + tuple(x_f.shape), dtype=x_f.dtype,
                        device=x_f.device)
    out_b = torch.zeros((m,) + tuple(x_b.shape), dtype=x_b.dtype,
                        device=x_b.device)
    out_f[slot], out_b[slot] = x_f, x_b
    cur_f, cur_b = x_f, x_b
    for s in range(nsteps):
        cur_f, cur_b = ppermute_round([(cur_f, perm_f), (cur_b, perm_b)],
                                      axis, mesh)
        out_f[(slot - (s + 1)) % m] = cur_f
        out_b[(slot + (s + 1)) % m] = cur_b
    return out_f, out_b


def _exec_ag_phase(work: torch.Tensor, phase: Phase, mesh) -> torch.Tensor:
    """All-gather one ring phase: flat local chunk -> (m, chunk) rows in
    ring-slot order."""
    m = phase.ring_size
    flat = work.reshape(-1)
    if m <= 1 or not phase.steps:
        return flat[None]
    slot = ring_slot(phase, mesh)
    perms = _phase_perms(phase)
    nsteps = len(phase.steps)
    if phase.directions == 2:
        half = flat.numel() // 2
        out_f, out_b = _ag_bidi(flat[:half], flat[half:], phase.axis, mesh,
                                perms[0], perms[1], slot, m, nsteps)
        return torch.cat([out_f, out_b], dim=-1)
    return _ag_directed(flat, phase.axis, mesh, perms[0], slot, m, +1,
                        nsteps)


# ----------------------------------------------------------------------------
# whole-schedule executors
# ----------------------------------------------------------------------------

def execute_reduce_scatter(schedule: CollectiveSchedule, x: torch.Tensor,
                           mesh) -> tuple[torch.Tensor, list[int]]:
    """Returns (chunk, stage_sizes): the reduced flat chunk this rank owns
    and the per-phase pre-pad sizes an inverse all-gather needs."""
    assert schedule.collective == RS, schedule.collective
    work = x.reshape(-1)
    sizes: list[int] = []
    for ph in schedule.phases:
        sizes.append(work.numel())
        work = _exec_rs_phase(work, ph, mesh)
    return work, sizes


def execute_all_gather(schedule: CollectiveSchedule, x: torch.Tensor, mesh,
                       stage_sizes: list[int] | None = None) -> torch.Tensor:
    """Single-phase schedules return slot-ordered rows (m, *x.shape);
    multi-phase (dimension-ordered) walks need ``stage_sizes`` from the
    forward reduce-scatter and return the flat reassembled array."""
    assert schedule.collective == AG, schedule.collective
    if stage_sizes is None:
        if len(schedule.phases) != 1:
            raise ValueError("multi-phase all-gather needs stage_sizes")
        ph = schedule.phases[0]
        out = _exec_ag_phase(x.reshape(-1), ph, mesh)
        return out.reshape((max(ph.ring_size, 1),) + tuple(x.shape))
    work = x.reshape(-1)
    for ph, size in zip(schedule.phases, reversed(tuple(stage_sizes))):
        work = _exec_ag_phase(work, ph, mesh).reshape(-1)[:size]
    return work


def execute_all_reduce(schedule: CollectiveSchedule, x: torch.Tensor,
                       mesh) -> torch.Tensor:
    assert schedule.collective == AR, schedule.collective
    work = x.reshape(-1)
    sizes: list[int] = []
    for ph in schedule.phases:
        if ph.kind == RS:
            sizes.append(work.numel())
            work = _exec_rs_phase(work, ph, mesh)
        else:
            work = _exec_ag_phase(work, ph, mesh).reshape(-1)[: sizes.pop()]
    return work.reshape(x.shape).to(x.dtype)


def execute_all_to_all(schedule: CollectiveSchedule, x: torch.Tensor,
                       mesh) -> torch.Tensor:
    """Store-and-forward: x[j] is this rank's block for rank j; returns
    rows holding the block received from each rank."""
    assert schedule.collective == A2A, schedule.collective
    ph = schedule.phases[0]
    n = ph.ring_size
    if ph.ring != tuple(range(n)):
        raise ValueError("all-to-all schedules keep the identity ring")
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} != ring size {n}")
    if not ph.steps:
        return x
    r = mesh.axis_index(ph.axis)
    perm = _phase_perms(ph)[0]
    out = torch.zeros_like(x)
    out[r] = x[r]
    buf = x
    for s in range(len(ph.steps)):
        (buf,) = ppermute_round([(buf, perm)], ph.axis, mesh)
        out[(r - s - 1) % n] = buf[r]         # buf originated at r-s-1
    return out


def execute_halo_exchange(schedule: CollectiveSchedule, x: torch.Tensor,
                          mesh, halo: int = 1, dim: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (from_prev, from_next): both ring neighbours' facing slabs —
    a pair of one-sided puts fired in the same round."""
    assert schedule.collective == HALO, schedule.collective
    ph = schedule.phases[0]
    lo = x.narrow(dim, 0, halo)
    hi = x.narrow(dim, x.shape[dim] - halo, halo)
    if not ph.steps:
        return hi, lo  # ring of one: own edges wrap straight around
    perm_f, perm_b = _phase_perms(ph)
    from_prev, from_next = ppermute_round([(hi, perm_f), (lo, perm_b)],
                                          ph.axis, mesh)
    return from_prev, from_next


# ----------------------------------------------------------------------------
# bucketed gradient hook — the overlap engine's executor entry point
# ----------------------------------------------------------------------------

def _bucket_grads(schedule: CollectiveSchedule, phase: Phase, m: int, mesh,
                  leaves: list[list[torch.nn.Parameter]]) -> None:
    """Reduce-scatter the gradients of one bucket's leaves in place: each
    leaf's flat gradient (its parameters' gradients concatenated) becomes
    zeros except this rank's reduced chunk at its ring slot — the
    pre-reduced ZeRO-1 shard, embedded in a full-size buffer."""
    slot = ring_slot(phase, mesh)
    for params in leaves:
        g = torch.cat([p.grad.reshape(-1) for p in params])
        chunk, _ = execute_reduce_scatter(schedule, g, mesh)
        full = torch.zeros((chunk.shape[0] * m,), dtype=chunk.dtype,
                           device=chunk.device)
        full[slot * chunk.shape[0]:(slot + 1) * chunk.shape[0]] = chunk
        off = 0
        with torch.no_grad():
            for p in params:
                n = p.numel()
                p.grad.copy_(full[off:off + n].reshape(p.shape))
                off += n


def make_bucket_grad_hook(plan: BucketPlan, schedule: CollectiveSchedule,
                          mesh):
    """Gradient hooks that bucket-reduce-scatter gradients inside the
    backward pass.

    ``schedule`` must be a single-axis reduce-scatter (possibly fault-
    rewritten).  Returns ``hook(leaves)``: ``leaves`` lists, for each leaf
    of the plan, the parameters whose flattened gradients, concatenated,
    make that leaf's gradient (``repro_torch.weights.jax_leaves``).  It
    registers a ``register_post_accumulate_grad_hook`` on every parameter
    and returns the handles; once every parameter of a bucket has its
    gradient — the point in the backward pass where the bucket is ready —
    the bucket's reduce-scatters run, free to overlap the rest of the
    backward, like the dual-DMA engine draining its prefetchable command
    queue (paper §2.1).  Afterwards each gradient holds this rank's reduced
    chunk at its slice (zeros elsewhere); pair with
    ``apex_zero1_update(pre_reduced=True)``.  Numerics match the
    sequential per-leaf path bit for bit for fp32 parameters
    (lower-precision ones pay one extra wire-dtype cast, like any bucketed
    DDP implementation).  A bucket fires once per backward pass; remove
    the handles to detach the hooks.
    """
    if schedule.collective != RS:
        raise ValueError(
            f"bucket hook needs a reduce-scatter schedule, got "
            f"{schedule.collective!r}")
    if len(schedule.phases) != 1:
        raise ValueError("bucket hook supports single-axis schedules only")
    phase = schedule.phases[0]
    m = max(phase.ring_size, 1)
    if phase.ring != tuple(range(m)):
        # a node-fault-shrunk/reordered ring changes where each rank's
        # reduced chunk lands, but the pre-reduced ZeRO update slices at
        # axis_index over the FULL axis — silent divergence.  Link-fault
        # rewrites keep the identity ring and are fine; node faults must
        # remesh (which the trainer does) rather than reroute.
        raise ValueError(
            f"bucket hook requires the identity ring, got {phase.ring}; "
            "node-fault-shrunk rings change the ZeRO chunk layout")

    def hook(leaves):
        if len(leaves) != plan.n_leaves:
            raise ValueError(f"tree has {len(leaves)} leaves, plan expects "
                             f"{plan.n_leaves}")
        handles = []
        for b in plan.buckets:
            group = [leaves[i] for i in b.leaves]
            params = [p for ps in group for p in ps]
            ids = frozenset(id(p) for p in params)
            pending = set(ids)

            def ready(p, group=group, pending=pending, ids=ids):
                pending.discard(id(p))
                if not pending:
                    pending.update(ids)          # armed for the next step
                    _bucket_grads(schedule, phase, m, mesh, group)

            handles += [p.register_post_accumulate_grad_hook(ready)
                        for p in params]
        return handles

    return hook


_EXECUTORS = {
    RS: execute_reduce_scatter,
    AG: execute_all_gather,
    AR: execute_all_reduce,
    A2A: execute_all_to_all,
    HALO: execute_halo_exchange,
}


def execute(schedule: CollectiveSchedule, x: torch.Tensor, mesh, **kw):
    """Dispatch on the schedule's collective kind (per-rank code)."""
    fn = _EXECUTORS.get(schedule.collective)
    if fn is None:
        raise ValueError(
            f"schedule kind {schedule.collective!r} has no per-rank "
            "executor (p2p schedules are priced and fault-rewritten; their "
            "data movement is modelled by the RDMA layer's put_pages)")
    return fn(schedule, x, mesh, **kw)
