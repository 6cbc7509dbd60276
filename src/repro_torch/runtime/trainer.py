"""Fault-tolerant trainer: LO|FA|MO watchdogs + checkpoint/restart +
elastic re-mesh + straggler detection.

The counterpart of the JAX package's ``runtime/trainer.py``.  Three
communication modes:

  * ``comm="single"`` (or no mesh) — one rank, plain AdamW;
  * ``comm="gspmd"`` (the default) over a mesh — JAX's production path,
    where XLA partitions one program by ``parallel/sharding.py``'s specs.
    Here every rank of the mesh is a process running its part: it holds
    its shard of every parameter (``param_specs``), of every AdamW moment
    (``zero1_specs``: ZeRO-1) and of the batch (``batch_specs``); the
    dense decoder stack runs tensor-parallel (heads and d_ff over "model",
    one all-reduce a sub-block) or sequence-parallel (``tp_activations``
    "sp" / "manual_sp": one all-gather and one reduce-scatter a
    sub-block), a dp_only stack whose sequence is over "model" runs on
    its slice of it (K/V gathered a layer), every other sharded leaf is gathered where a layer reads
    it (``models.common.Params``), and autograd runs through the
    collectives (``parallel/spmd.py``).  Gradients are summed over each
    leaf's replica axes, AdamW runs on this rank's moment shard against
    the matching slice of its parameter shard, and the updated slices are
    all-gathered back into the parameter layout.  Checkpoints keep JAX's
    global layout and keys: the lowest rank writes them, every rank
    restores by slicing.  An MoE with ``moe_impl="ep_a2a"`` dispatches
    its tokens expert-parallel over "model" (``moe.apply_moe_ep``);
  * ``comm="apex"``  — the paper-faithful path: every rank of the mesh's DP
    axis is one process, gradients are synchronised by the explicit
    bidirectional ring reduce-scatter / all-gather of ``core/collectives``
    (first-neighbour torus puts as ``torch.distributed`` point-to-point
    rounds, both directions of a round in one batch: the dual DMA engines)
    with shard-local ZeRO-1 moments.  Model must fit per rank (DP-pure).

Fault tolerance loop (per §4 of the paper):

  host watchdog ticks each step -> LofamoSim (the fabric model) diffuses
  any injected/host fault to neighbours -> the trainer's master view flags
  the rank -> trainer restores the last verified checkpoint onto the
  surviving mesh (elastic re-mesh) and replays the data stream from the
  checkpointed position.  A dead link under ``fault_mode="reroute"`` only
  re-lowers the schedules around it.

Every rank runs the same deterministic ``LofamoSim`` and the same fault
hook, so all ranks reach the same decision at the same step without
talking.  The lowest rank of the mesh writes the checkpoints (ZeRO moments
gathered to JAX's global ``(dp * chunk,)`` layout) and every rank restores
from them; the ranks an elastic re-mesh drops leave the loop.

The parameters live in the model module (``nn.Module``, per layer); the
optimizer sees the JAX pytree's leaves (``weights.jax_leaves``: layer-
stacked where JAX stacks), so its rules and the ZeRO chunking see JAX's
shapes, the bucket plan and cost model JAX's leaf sizes, and a checkpoint
has JAX's keys and layout.

Each step records wall-clock spans into the process's telemetry hub
(``fabric.process_hub()``), on track ``("train",)``: ``train.step`` with
its children ``train.data`` (the next batch, placed), ``train.fwd_bwd``
and ``train.update`` (the single and GSPMD steps: leaf gradients, AdamW
and the assignment back, or, in the single step on a card without
gradient accumulation, the in-place kernel pair ``optim.adamw_update_``;
the apex step overlaps the two and is not split) and ``train.wait`` (the
card catching up).  On a card,
``train.fwd_bwd`` and ``train.update`` carry ``dev_s``, the device's time
between CUDA events recorded at their boundaries, read after the step's
own synchronisation.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import weights
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import collectives as C
from repro_torch.core import fabric, hw
from repro_torch.core.fabric.telemetry import process_hub
from repro_torch.core.lofamo import LofamoSim
from repro_torch.core.rdma import RdmaEndpoint
from repro_torch.core.topology import Torus
from repro_torch.data import SyntheticTokens, make_batch_arrays
from repro_torch.models import api, transformer
from repro_torch.models.common import ArchCfg
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               adamw_update_)
from repro_torch.optim.adamw import apex_zero1_init, apex_zero1_update
from repro_torch.parallel import sharding, spmd

TRACK = ("train",)


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = "/tmp/apex_ckpt"
    ckpt_every: int = 50
    keep_last: int = 3
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    batch: int = 8
    seq_len: int = 128
    # microbatch gradient accumulation: the global batch is split into
    # `grad_accum` sequential microbatches whose grads accumulate in fp32
    # before one optimizer step; activation memory drops by the same factor
    grad_accum: int = 1
    remat: bool = True
    comm: str = "gspmd"            # or "apex" / "single"
    dp_axis: str = "data"
    # link-fault policy ("remesh" is the node-fault-only default: a dead
    # link loses no state, so it is logged and routing is left to the
    # runtime fabric); "reroute" (apex comm only) = rewrite the collective
    # schedules around the dead link and keep training — no restart, no
    # lost steps, just a higher predicted hop cost.  Node faults always
    # checkpoint-restart on an elastically re-meshed machine.
    fault_mode: str = "remesh"
    # overlap engine (apex comm only): bucket the gradient reduce-scatter
    # (fabric.plan_buckets) and issue each bucket's schedule inside the
    # backward pass via the fabric bucket grad hook, so the point-to-point
    # rounds overlap the remaining backward compute — the schedule-level
    # analogue of the §2.1 dual-DMA prefetchable command queue.  Numerics
    # are identical to the sequential step (fp32 params: bitwise).
    overlap: bool = False
    # bucket size target (MB of fp32 grads).  The default (None) loads
    # the fabric autotuner's searched value from ``best_configs.json``
    # ("train" workload entry) and falls back to the hand-tuned 4 MB when
    # no artifact is pinned; passing any explicit number always wins.
    bucket_mb: float | None = None
    # fabric time-model backend for predicted_comm_s / the overlap
    # estimate: "analytic" (closed-form, the fast default) or "sim" (the
    # event-driven link-level FabricSim replay)
    cost_backend: str = "analytic"
    # sim-backend fidelity tier: "packet", "fluid" or "hybrid"; the
    # analytic backend ignores it
    cost_fidelity: str = "packet"
    wd_period: float = 0.5          # LO|FA|MO watchdog period (seconds)
    straggler_factor: float = 3.0   # step slower than this x median -> flag
    seed: int = 0
    # LO|FA|MO fabric shape override: the fault model may cover the full
    # cluster even when this process group drives fewer ranks (default:
    # the mesh's own torus twin)
    torus_dims: tuple | None = None

    def __post_init__(self) -> None:
        if self.bucket_mb is None:
            from repro_torch.core.fabric import autotune
            self.bucket_mb = float(
                autotune.tuned_knob("train", "bucket_mb", 4.0))


def shard_params(cfg: ArchCfg, params: torch.nn.Module, mesh) -> dict:
    """Cut every parameter of ``params`` to this rank's shard of its
    ``param_specs`` spec (a stacked leaf's spec less its layer entry: each
    layer's tensor), kept in ``p.spec``; returns {leaf path: spec}."""
    pspecs = sharding.flatten(sharding.param_specs(
        cfg, api.param_shapes(cfg), mesh))
    with torch.no_grad():
        for path, ps in weights.jax_leaves(cfg, params).items():
            spec = pspecs[path]
            if weights.is_stacked(cfg, path):
                spec = sharding.P(*spec[1:])    # each layer's tensor
            for p in ps:
                p.data = spmd.shard(p.data, spec, mesh).clone(
                    memory_format=torch.contiguous_format)
                p.spec = spec
    return pspecs


class Trainer:
    """``Trainer(cfg, tcfg, mesh=None, telemetry=None, device="cuda")``:
    trains on the card (this rank's device) unless the caller asks for the
    CPU; without a card the default raises.  ``init_params`` (a model
    module) replaces the seeded initialisation, e.g. weights carried over
    from the JAX package (``weights.from_jax_params``)."""

    def __init__(self, cfg: ArchCfg, tcfg: TrainerConfig, mesh=None,
                 telemetry: "object | None" = None, device="cuda", *,
                 init_params: torch.nn.Module | None = None) -> None:
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Trainer: no CUDA device is available; "
                                   "pass device='cpu' to train on the CPU")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = device
        self.telemetry = telemetry
        self.model = api.get_model(cfg)
        self._init_params = init_params
        self.store = CheckpointStore(tcfg.ckpt_dir, keep_last=tcfg.keep_last)
        self.data = SyntheticTokens(cfg, tcfg.batch, tcfg.seq_len,
                                    seed=tcfg.seed)
        self.metrics_log: list[dict] = []
        self.events: list[str] = []
        # the straggler check's running median reads the last 20 steps
        self._step_times: collections.deque = collections.deque(maxlen=20)
        # (span, start event, end event) of this step's timed phases
        self._phases: list = []
        # False once an elastic re-mesh drops this rank: it leaves the loop
        self.active = True
        if tcfg.torus_dims is not None:
            dims = tuple(tcfg.torus_dims)
        elif mesh is not None:
            dims = tuple(mesh.shape[a] for a in mesh.axis_names)
        else:
            dims = (1,)
        self.torus = Torus(dims)
        self.lofamo = LofamoSim(self.torus, wd_period=tcfg.wd_period)
        # RDMA endpoint twin: its command-queue depth feeds the overlap
        # model (prefetchable queue = issue gaps hidden between buckets)
        self.rdma = RdmaEndpoint(self.torus, rank=0, telemetry=telemetry)
        self._handled_faults: set[int] = set()
        self._handled_links: set[tuple[int, int]] = set()
        self._fault_map = fabric.FaultMap()
        self.predicted_comm_s: float | None = None
        self.bucket_plan: fabric.BucketPlan | None = None
        self.overlap_estimate: fabric.OverlapEstimate | None = None
        self._overlap_baseline: dict | None = None
        self._build()

    # ------------------------------------------------------------------ build
    def _apex(self) -> bool:
        return self.mesh is not None and self.tcfg.comm == "apex"

    def _gspmd(self) -> bool:
        return self.mesh is not None and self.tcfg.comm == "gspmd"

    def _build(self) -> None:
        cfg, tcfg = self.cfg, self.tcfg
        if self._init_params is not None:
            params = copy.deepcopy(self._init_params).to(self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
            params = self.model.init(gen)
        for p in params.parameters():     # the trainer's own parameters
            p.requires_grad_(True)
        self.params = params
        if self._gspmd():
            self._build_gspmd()
            return
        self.leaves = weights.jax_leaves(cfg, params)
        if self._apex():
            self._build_apex()
        else:
            self.opt_state = adamw_init(self._leaf_values())
            self._step_fn = self._single_step

    def _leaf_values(self) -> dict:
        """{JAX leaf path: value}, layer-stacked leaves as stacked copies."""
        with torch.no_grad():
            return {k: weights.leaf_tensor(self.cfg, k, ps).detach()
                    for k, ps in self.leaves.items()}

    def _leaf_grads(self) -> dict:
        return {k: weights.leaf_tensor(
            self.cfg, k, [p.grad if p.grad is not None
                          else torch.zeros_like(p) for p in ps])
            for k, ps in self.leaves.items()}

    def _assign(self, new_params: dict) -> None:
        for k, v in new_params.items():
            weights.assign_leaf(self.cfg, k, self.leaves[k], v)

    def _backward(self, batch: dict, scale: float = 1.0) -> torch.Tensor:
        """One forward + backward on ``batch``: the gradients of ``scale``
        times the loss in ``.grad``; returns the loss."""
        for p in self.params.parameters():
            p.grad = None
        loss = self.model.train_loss(self.params, batch,
                                     remat=self.tcfg.remat)
        (loss if scale == 1.0 else loss * scale).backward()
        return loss.detach().float()

    def _loss_and_grads(self, batch: dict, scale: float = 1.0):
        """(loss, {leaf: grad}); microbatched when grad_accum > 1 (fp32
        accumulation, one optimizer step per global batch)."""
        accum = self.tcfg.grad_accum
        if accum <= 1:
            loss = self._backward(batch, scale)
            return loss, self._leaf_grads()
        micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=self.device)
        g_acc = None
        for i in range(accum):
            loss = self._backward({k: v[i] for k, v in micro.items()},
                                  scale)
            g = {k: t.float() for k, t in self._leaf_grads().items()}
            # JAX: zeros + g, then + g for each later microbatch
            g_acc = g if g_acc is None else {k: g_acc[k] + g[k] for k in g}
            loss_acc = loss_acc + loss
        inv = 1.0 / accum
        return loss_acc * inv, {k: g * inv for k, g in g_acc.items()}

    @contextlib.contextmanager
    def _phase(self, name: str):
        """A span of the step; on a card, CUDA events at its boundaries
        give its device time once the step has synchronised."""
        with process_hub().span(TRACK, name) as sp:
            if self.device.type != "cuda" or self._phases is None:
                yield
                return
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._phases.append((sp, start, end))

    def _single_step(self, batch: dict) -> dict:
        with self._phase("train.fwd_bwd"):
            if self.tcfg.grad_accum <= 1:
                loss, grads = self._backward(batch), None
            else:
                loss, grads = self._loss_and_grads(batch)
        with self._phase("train.update"):
            if grads is None and self.device.type == "cuda":
                # one kernel pair, in place: no stacked copy, no copy back
                metrics = adamw_update_(self.tcfg.opt, self.leaves,
                                        self.opt_state)
            else:
                if grads is None:
                    grads = self._leaf_grads()
                new_p, self.opt_state, metrics = adamw_update(
                    self.tcfg.opt, grads, self.opt_state,
                    self._leaf_values())
                self._assign(new_p)
        return {"loss": loss, **metrics}

    # ------------------------------------------------------- apex (fabric)
    def _apex_schedules(self) -> dict:
        """Lower the apex step's collective schedules against the fabric
        torus, rewritten around the currently known fault map."""
        axis = self.tcfg.dp_axis
        dp = self.mesh.shape[axis]
        torus = self.torus if self.torus.dims == (dp,) else Torus((dp,))
        scheds = {
            "rs": fabric.lower_reduce_scatter(torus, (axis,), mean=True),
            "ag": fabric.lower_all_gather(torus, (axis,)),
            "loss": fabric.lower_all_reduce(torus, (axis,), mean=True),
        }
        if self._fault_map:
            scheds = {k: fabric.rewrite(s, self._fault_map)
                      for k, s in scheds.items()}
        return scheds

    def _leaf_meta(self) -> list[tuple[int, int]]:
        """(elements, bytes per element) of every JAX leaf, in order."""
        return [(sum(p.numel() for p in ps), ps[0].element_size())
                for ps in self.leaves.values()]

    def _predict_comm_s(self, scheds) -> float:
        """Predicted per-step gradient-sync time: every leaf's fp32 grad
        reduce-scatter plus updated-param all-gather, priced on the same
        schedules the step executes (fabric cost model)."""
        dp = self.mesh.shape[self.tcfg.dp_axis]
        backend = self.tcfg.cost_backend
        # trainer collectives carry the COLLECTIVE traffic class
        cls = fabric.TrafficClass.COLLECTIVE
        fid = self.tcfg.cost_fidelity
        total = fabric.estimate(scheds["loss"], 4, backend=backend,
                                fidelity=fid, cls=cls).total_s
        for size, itemsize in self._leaf_meta():
            chunk_bytes = -(-size // dp) * itemsize
            total += fabric.estimate(scheds["rs"], 4 * size,
                                     backend=backend, fidelity=fid,
                                     cls=cls).total_s
            total += fabric.estimate(scheds["ag"], chunk_bytes,
                                     backend=backend, fidelity=fid,
                                     cls=cls).total_s
        return total

    def _bwd_compute_model_s(self) -> float:
        """Modelled per-rank backward-compute seconds — the overlap model's
        compute trace (backward ~ 2x forward = 4 * P * T FLOPs, priced at a
        conservative 40% MFU on the JAX package's target chip, so the
        estimate equals the reference's)."""
        dp = self.mesh.shape[self.tcfg.dp_axis]
        tokens = self.tcfg.batch * self.tcfg.seq_len / max(dp, 1)
        flops = 4.0 * self.n_params * tokens
        return flops / (hw.TPU_V5E.peak_flops_bf16 * 0.4)

    def _make_apex_step(self) -> None:
        """(Re)build the apex step from the current schedules.

        With ``overlap=True`` the gradient reduce-scatter runs bucket by
        bucket *inside* the backward pass (fabric bucket grad hook) and the
        ZeRO-1 update consumes the pre-reduced shards; the sequential step
        stays available as the measured-overlap baseline."""
        tcfg = self.tcfg
        scheds = self._apex_schedules()
        self.apex_schedules = scheds
        self.predicted_comm_s = self._predict_comm_s(scheds)
        self._overlap_baseline = None
        self._bucket_hook = None
        if tcfg.overlap:
            bucket_bytes = max(int(tcfg.bucket_mb * (1 << 20)), 1)
            self.bucket_plan = fabric.plan_buckets(
                [n for n, _ in self._leaf_meta()], bucket_bytes)
            self.overlap_estimate = fabric.estimate_overlapped(
                scheds["rs"], self.bucket_plan, self._bwd_compute_model_s(),
                queue_depth=self.rdma.queue_depth,
                backend=tcfg.cost_backend, fidelity=tcfg.cost_fidelity,
                cls=fabric.TrafficClass.COLLECTIVE)
            self._bucket_hook = fabric.make_bucket_grad_hook(
                self.bucket_plan, scheds["rs"], self.mesh)
        else:
            self.bucket_plan = None
            self.overlap_estimate = None
        self._step_fn = self._apex_train_step

    def _apex_step(self, batch: dict, bucketed: bool):
        """One apex step, committing nothing: (new_params, state, loss)."""
        axis, scheds = self.tcfg.dp_axis, self.apex_schedules
        handles = (self._bucket_hook(list(self.leaves.values()))
                   if bucketed else [])
        try:
            local = self._backward(batch)
        finally:
            for h in handles:
                h.remove()
        grads = self._leaf_grads()
        # mean loss across DP ranks over the torus ring
        loss = C.ring_all_reduce(local[None], axis, self.mesh,
                                 schedule=scheds["loss"])[0]
        new_p, state = apex_zero1_update(
            self.tcfg.opt, grads, self.opt_state, self._leaf_values(),
            mesh=self.mesh, axis_name=axis, rs_schedule=scheds["rs"],
            ag_schedule=scheds["ag"], pre_reduced=bucketed)
        return new_p, state, loss

    def _apex_train_step(self, batch: dict) -> dict:
        new_p, self.opt_state, loss = self._apex_step(
            batch, self.tcfg.overlap)
        self._assign(new_p)
        return {"loss": loss}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _measure_overlap_baseline(self, batch) -> dict:
        """One-off calibration for measured overlap efficiency: wall-time
        the sequential (barrier) apex step and the compute-only backward on
        the live batch (second run each, past warm-up).  Also warms the
        overlapped step, so the step times compared against these
        baselines never include a first call.  Nothing is committed."""
        def timed(fn):
            fn()
            self._sync()
            t0 = time.perf_counter()
            fn()
            self._sync()
            return time.perf_counter() - t0

        seq_s = timed(lambda: self._apex_step(batch, False))
        compute_s = timed(lambda: self._backward(batch))
        self._apex_step(batch, True)                   # warm, discard
        self._sync()
        return {"seq_s": seq_s, "compute_s": compute_s}

    def _build_apex(self) -> None:
        """Paper-faithful DP: explicit torus ring collectives, every
        collective lowered through the fabric's CollectiveSchedule."""
        self._make_apex_step()
        # this rank's moment slices: (chunk,) of the global (dp * chunk,)
        self.opt_state = apex_zero1_init(self._leaf_values(),
                                         self.mesh.shape[self.tcfg.dp_axis])

    # ------------------------------------------------------- gspmd (specs)
    @classmethod
    def rank_program(cls, cfg: ArchCfg, tcfg: TrainerConfig, mesh,
                     batch_shapes: dict, *, device="meta") -> "Trainer":
        """One rank's GSPMD step and nothing around it: no data stream,
        checkpoints or fault model.  The parameters (built on ``device``
        with no values when it is meta, seeded elsewhere), ZeRO-1 moments
        and batch spec of ``mesh``'s rank for a global batch of
        ``batch_shapes``; ``gspmd_step(batch)`` runs a step on this rank's
        part of the batch (``spmd.shard`` by ``bspecs``).  On meta over
        an abstract mesh it is what the dry run traces
        (``launch/dryrun.py``)."""
        self = cls.__new__(cls)
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.device = torch.device(device)
        self._phases = None        # no train_step reads the phases' times
        self.model = api.get_model(cfg)
        if self.device.type == "meta":
            params = weights.model_class(cfg)(cfg, device="meta")
        else:
            params = self.model.init(torch.Generator(
                device=self.device).manual_seed(tcfg.seed))
        for p in params.parameters():
            p.requires_grad_(True)
        self.params = params
        self._build_gspmd(batch_shapes)
        return self

    def _build_gspmd(self, batch_shapes: dict | None = None) -> None:
        """Shard the parameters, the moments and the batch by the specs
        (JAX: ``_build_gspmd``): each rank keeps its part of each.  The
        batch spec is that of ``batch_shapes`` (default: a peek at the
        data stream's next batch)."""
        cfg, mesh = self.cfg, self.mesh
        shapes = api.param_shapes(cfg)
        self.shapes = sharding.flatten(shapes)       # path -> meta (global)
        self.pspecs = shard_params(cfg, self.params, mesh)
        self.zspecs = sharding.flatten(sharding.zero1_specs(cfg, shapes,
                                                            mesh))
        self.leaves = weights.jax_leaves(cfg, self.params)
        m = {k: torch.zeros(spmd.shard(t, self.zspecs[k], mesh).shape,
                            dtype=torch.float32, device=self.device)
             for k, t in self.shapes.items()}
        self.opt_state = {"m": m, "v": {k: z.clone() for k, z in m.items()},
                          "step": torch.zeros((), dtype=torch.int32,
                                              device=self.device)}
        if batch_shapes is None:
            batch_shapes = self.data.next_batch()
            self.data.step -= 1  # the batch was a peek at its shapes
        self.bspecs = sharding.batch_specs(cfg, batch_shapes, mesh)
        self._step_fn = self.gspmd_step

    def _replica_axes(self, spec) -> tuple[str, ...]:
        """The mesh axes a tensor under ``spec`` is replicated over."""
        used = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def _moment_cut(self, path: str) -> tuple:
        """Where the moment shard cuts the parameter shard further: the
        entries ``zero1_specs`` adds to ``param_specs``."""
        p, z = self.pspecs[path], self.zspecs[path]
        z = tuple(z) + (None,) * (len(self.shapes[path].shape) - len(z))
        p = tuple(p) + (None,) * (len(z) - len(p))
        return tuple(zi if zi != pi else None for zi, pi in zip(z, p))

    def _gspmd_loss_and_grads(self, batch: dict):
        """(mean loss over the global batch, {leaf: gradient of this
        rank's parameter shard}).  Each rank computes its part of the
        batch (the whole sequence of its rows, gathered where dp_only
        sharded it, unless the model runs on sequence slices) and
        backpropagates its loss over the mesh size, so the ranks'
        gradients sum to the global mean's; each leaf's are summed over
        the axes it is replicated on."""
        mesh, n = self.mesh, self.mesh.size
        spec = self.bspecs["tokens"]
        if not transformer.takes_sequence_slices(self.cfg):
            batch = {k: spmd.unshard(v, (None,) + tuple(self.bspecs[k][1:]),
                                     mesh) for k, v in batch.items()}
            spec = spec[:1]
        sharding.set_runtime_mesh(mesh, spec)
        try:
            local, grads = self._loss_and_grads(batch, 1.0 / n)
        finally:
            sharding.set_runtime_mesh(None)
        with torch.no_grad():
            grads = {k: spmd.all_reduce(g, mesh,
                                        self._replica_axes(self.pspecs[k]),
                                        tag="grad")
                     for k, g in grads.items()}
            loss = spmd.all_reduce(local, mesh, mesh.axis_names,
                                   tag="loss") / n
        return loss, grads

    def _zero1_update(self, grads: dict):
        """AdamW on this rank's moment shard against the matching slices
        of its gradient and parameter shards, then the new slices gathered
        back into the parameter layout.  Returns (new parameter shards,
        metrics)."""
        mesh = self.mesh
        vals = self._leaf_values()
        cut, g_sl, p_sl = {}, {}, {}
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            for k, g in grads.items():
                cut[k] = self._moment_cut(k)
                g_sl[k] = spmd.shard(g, cut[k], mesh)
                p_sl[k] = spmd.shard(vals[k], cut[k], mesh)
                # a slice held by r ranks counts once in the global norm
                r = math.prod(mesh.shape[a]
                              for a in self._replica_axes(self.zspecs[k]))
                sq = sq + torch.sum(torch.square(g_sl[k].float())) / r
            gnorm = torch.sqrt(spmd.all_reduce(sq, mesh, mesh.axis_names,
                                               tag="norm"))
            new_p, self.opt_state, metrics = adamw_update(
                self.tcfg.opt, g_sl, self.opt_state, p_sl, grad_norm=gnorm)
            new_p = {k: spmd.unshard(v, cut[k], mesh, tag="param")
                     for k, v in new_p.items()}
        return new_p, metrics

    def gspmd_step(self, batch: dict) -> dict:
        """One GSPMD step on this rank's part of the batch."""
        with self._phase("train.fwd_bwd"):
            loss, grads = self._gspmd_loss_and_grads(batch)
        with self._phase("train.update"):
            new_p, metrics = self._zero1_update(grads)
            self._assign(new_p)
        return {"loss": loss, **metrics}

    @property
    def n_params(self) -> int:
        if self._gspmd():
            return sum(t.numel() for t in self.shapes.values())
        return sum(n for n, _ in self._leaf_meta())

    # ------------------------------------------------------------ checkpoint
    def _writer(self) -> bool:
        """The lowest rank of the mesh writes the checkpoints."""
        return self.mesh is None or dist.get_rank() == min(self.mesh.ranks)

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier(group=self.mesh.all_group)

    def _global_params(self) -> dict:
        """{leaf: value} in JAX's global layout (every rank takes part:
        GSPMD shards are gathered)."""
        vals = self._leaf_values()
        if not self._gspmd():
            return vals
        return {k: spmd.unshard(v, self.pspecs[k], self.mesh)
                for k, v in vals.items()}

    def _global_moments(self) -> dict:
        """The optimizer state in JAX's layout: apex moments gathered to
        the global (dp * chunk,) buffers, GSPMD moment shards to the
        leaves' shapes (every rank takes part)."""
        if self._gspmd():
            def gather(tree):
                return {k: spmd.unshard(t, self.zspecs[k], self.mesh)
                        for k, t in tree.items()}
            return {"m": gather(self.opt_state["m"]),
                    "v": gather(self.opt_state["v"]),
                    "step": self.opt_state["step"]}
        if not self._apex():
            return self.opt_state
        axis = self.tcfg.dp_axis
        dp = self.mesh.shape[axis]
        ag = fabric.lower_all_gather(Torus((dp,)), (axis,))

        def gather(tree):
            return {k: fabric.execute_all_gather(ag, t, self.mesh)
                    .reshape(-1) for k, t in tree.items()}

        return {"m": gather(self.opt_state["m"]),
                "v": gather(self.opt_state["v"]),
                "step": self.opt_state["step"]}

    def _template(self) -> dict:
        if self._gspmd():     # the global layout, with no memory behind it
            def zeros(dtype):
                return {k: torch.empty(t.shape, dtype=dtype or t.dtype,
                                       device="meta")
                        for k, t in self.shapes.items()}
            return {"params": zeros(None),
                    "opt": {"m": zeros(torch.float32),
                            "v": zeros(torch.float32),
                            "step": self.opt_state["step"]}}
        return {"params": self._leaf_values(), "opt": self.opt_state}

    def _place(self, tree: dict) -> None:
        """Load a restored host tree (JAX layout) into the model and the
        optimizer state; an apex rank keeps its chunk of each moment, a
        GSPMD rank its shards of every parameter and moment."""
        if self._gspmd():
            mesh, opt = self.mesh, tree["opt"]
            self._assign({k: spmd.shard(v, self.pspecs[k], mesh)
                          .to(self.device) for k, v in tree["params"].items()})

            def local(t, k):
                return spmd.shard(t.float(), self.zspecs[k], mesh).to(
                    self.device).clone(memory_format=torch.contiguous_format)
            self.opt_state = {
                "m": {k: local(t, k) for k, t in opt["m"].items()},
                "v": {k: local(t, k) for k, t in opt["v"].items()},
                "step": opt["step"].to(device=self.device,
                                       dtype=torch.int32)}
            return
        self._assign({k: v.to(self.device)
                      for k, v in tree["params"].items()})
        if self._apex():
            dp = self.mesh.shape[self.tcfg.dp_axis]
            rank = self.mesh.axis_index(self.tcfg.dp_axis)
        else:
            dp, rank = 1, 0
        opt = tree["opt"]
        self.opt_state = weights.from_jax_opt_state(
            {"m": {k: t.numpy() for k, t in opt["m"].items()},
             "v": {k: t.numpy() for k, t in opt["v"].items()},
             "step": opt["step"].numpy()},
            dp=dp, rank=rank, device=self.device)

    def resume(self) -> None:
        """Restore the latest checkpoint (raises FileNotFoundError if none)."""
        tree, extra = self.store.restore_latest(self._template())
        self._place(tree)
        self.data = SyntheticTokens.from_state(
            self.cfg, self.tcfg.batch, self.tcfg.seq_len, extra["data"])
        self.events.append(f"resumed from checkpoint @ step {self.data.step}")

    def checkpoint(self) -> None:
        params, opt = self._global_params(), self._global_moments()
        if self._writer():
            tree = {"params": params, "opt": opt}
            self.store.save_async(self.data.step, tree,
                                  extra={"data": self.data.state(),
                                         "arch": self.cfg.name})
        self.events.append(f"checkpoint @ step {self.data.step}")

    # ------------------------------------------------------------------- loop
    def _place_batch(self, np_batch: dict) -> dict:
        batch = make_batch_arrays(np_batch, self.cfg, self.device)
        if self._gspmd():
            # this rank's part of the global batch (JAX: batch_specs)
            return {k: spmd.shard(v, self.bspecs[k], self.mesh).clone(
                memory_format=torch.contiguous_format)
                for k, v in batch.items()}
        if self._apex():
            # this rank's rows of the global batch (JAX: P(dp_axis))
            dp = self.mesh.shape[self.tcfg.dp_axis]
            r = self.mesh.axis_index(self.tcfg.dp_axis)
            batch = {k: v.reshape((dp, v.shape[0] // dp) + v.shape[1:])[r]
                     for k, v in batch.items()}
        return batch

    def train_step(self) -> dict:
        hub = process_hub()
        with hub.span(TRACK, "train.step"):
            return self._train_step(hub)

    def _train_step(self, hub) -> dict:
        t0 = time.perf_counter()
        with hub.span(TRACK, "train.data"):
            batch = self._place_batch(self.data.next_batch())
        if self._apex() and self.tcfg.overlap \
                and self._overlap_baseline is None:
            self._overlap_baseline = self._measure_overlap_baseline(batch)
            t0 = time.perf_counter()  # calibration is not step time
        metrics = self._step_fn(batch)
        with hub.span(TRACK, "train.wait"):
            self._sync()
        dt = time.perf_counter() - t0
        self._step_times.append(dt)
        for sp, start, end in self._phases:
            hub.annotate(sp, dev_s=start.elapsed_time(end) * 1e-3)
        self._phases.clear()
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_time_s"] = dt
        metrics["step"] = self.data.step
        if self.predicted_comm_s is not None:
            # fabric cost model vs wall clock: the schedule's predicted
            # gradient-sync time for this step (APEnet+ NetModel pricing)
            metrics["predicted_comm_s"] = self.predicted_comm_s
        if self.overlap_estimate is not None:
            # overlap engine: predicted overlap efficiency vs the measured
            # one (wall clock of the overlapped step against the
            # sequential-step and compute-only calibration baselines)
            est = self.overlap_estimate
            metrics["overlap_eff_pred"] = est.efficiency
            metrics["overlap_pred_reduction"] = est.reduction
            metrics["overlap_pred_total_s"] = est.total_s
            if self._overlap_baseline is not None:
                base = self._overlap_baseline
                comm_meas = max(base["seq_s"] - base["compute_s"], 1e-9)
                eff = (base["seq_s"] - dt) / comm_meas
                metrics["overlap_eff_measured"] = float(
                    np.clip(eff, 0.0, 1.0))
                metrics["seq_step_s"] = base["seq_s"]
        # straggler detection: this step vs the running median
        if len(self._step_times) >= 5:
            med = float(np.median(self._step_times))
            if dt > self.tcfg.straggler_factor * med:
                metrics["straggler"] = True
                self.events.append(
                    f"straggler step={self.data.step} {dt:.3f}s vs median "
                    f"{med:.3f}s — would re-issue on hot spare")
        self.metrics_log.append(metrics)
        if self.telemetry is not None:
            self.telemetry.add("trainer.steps")
            self.telemetry.add("trainer.step_time_s", dt)
        return metrics

    def train(self, steps: int, *, fault_hook: Callable[[int], None] | None
              = None) -> list[dict]:
        """Run ``steps`` steps; a rank that an elastic re-mesh drops stops
        there (``active`` turns False) and returns what it ran."""
        out = []
        for i in range(steps):
            if not self.active:
                break
            if fault_hook:
                fault_hook(i)
            # LO|FA|MO: one watchdog tick per step (the diagnostic traffic
            # rides the fabric; zero cost on the data path)
            self.lofamo.step()
            failed = self.lofamo.detected_at_master() - self._handled_faults
            if failed:
                self._recover(failed)
                self._handled_faults |= failed
                if not self.active:
                    break
            links = (self.lofamo.detected_links_at_master()
                     - self._handled_links)
            if links:
                self._handle_link_faults(links)
                self._handled_links |= links
            out.append(self.train_step())
            if self.tcfg.ckpt_every and \
                    self.data.step % self.tcfg.ckpt_every == 0:
                self.checkpoint()
        self.store.wait()
        if self.active:
            self._barrier()
        return out

    # -------------------------------------------------------------- recovery
    def _handle_link_faults(self, links: set[tuple[int, int]]) -> None:
        """A torus link died but both endpoints live.  Under
        ``fault_mode="reroute"`` (apex comm) the collective schedules are
        rewritten around the dead link — same numerics, no restart, only a
        higher predicted hop cost; otherwise we just log the awareness."""
        self.events.append(
            f"LO|FA|MO: master aware of dead link(s) {sorted(links)}")
        if self.telemetry is not None:
            self.telemetry.add("fabric.fault_epochs")
        if self.tcfg.fault_mode != "reroute" or not self._apex():
            return
        dp = self.mesh.shape[self.tcfg.dp_axis]
        if self.torus.dims != (dp,):
            # LofamoSim link pairs are ranks of self.torus; the apex
            # schedules are lowered on the dp ring — without a 1:1 match
            # the pair would be misread in the other rank space
            self.events.append(
                f"reroute unsupported: fault torus {self.torus.dims} is not "
                f"the dp ring ({dp},); routing left to the runtime fabric")
            return
        before = self.predicted_comm_s
        self._fault_map = fabric.FaultMap.normalized(
            self._fault_map.dead_nodes,
            set(self._fault_map.dead_links) | links)
        try:
            self._make_apex_step()
        except fabric.UnroutableError as e:
            self.events.append(f"reroute impossible ({e}); keeping schedule")
            return
        hops = max(s.max_hops for s in self.apex_schedules.values())
        self.events.append(
            f"rerouted collectives around {sorted(links)}: detour "
            f"max_hops={hops}, predicted grad-sync "
            f"{(before or 0) * 1e3:.2f} -> {self.predicted_comm_s * 1e3:.2f} ms"
            " (training continues, no restart)")

    def _recover(self, failed: set[int]) -> None:
        """Checkpoint-restart on the surviving mesh (elastic re-mesh)."""
        from repro_torch.launch.mesh import make_mesh

        self.events.append(f"LO|FA|MO: master aware of faults {sorted(failed)}"
                           f" (Ta ~ {1.8 * self.tcfg.wd_period:.2f}s)")
        self.store.wait()
        self._barrier()          # the writer's checkpoint is on disk
        survivors = [r for i, r in enumerate(self.mesh.ranks)
                     if i not in failed] if self.mesh is not None else []
        if self.mesh is not None and survivors \
                and len(self.mesh.axis_names) == 1:
            # largest power-of-two prefix that still forms a ring
            n = 1
            while n * 2 <= len(survivors):
                n *= 2
            new_mesh = make_mesh((n,), self.mesh.axis_names,
                                 ranks=survivors[:n])
            self.events.append(
                f"elastic re-mesh: {self.mesh.size} -> {n} devices")
            self.mesh = new_mesh
            self.torus = Torus(tuple(new_mesh.shape[a]
                                     for a in new_mesh.axis_names))
            self.lofamo = LofamoSim(self.torus,
                                    wd_period=self.tcfg.wd_period)
            # fresh fabric: the surviving ranks' links are all healthy
            self._fault_map = fabric.FaultMap()
            self._handled_links = set()
            if dist.get_rank() not in new_mesh:
                self.active = False    # dropped: this rank leaves the loop
                self.events.append("dropped by the re-mesh: leaving")
                return
        # restore model+opt+data from the last verified checkpoint.  The
        # template is taken before _build(), as JAX takes it: the restored
        # moments keep the checkpoint's global layout, which each rank
        # slices by the NEW dp size (ROADMAP §3)
        template = self._template()
        try:
            tree, extra = self.store.restore_latest(template)
        except FileNotFoundError:
            self.events.append("no checkpoint yet: restarting from init")
            self._build()
            return
        self._build()  # rebuild the step and state for the new mesh
        self._place(tree)
        self.data = SyntheticTokens.from_state(
            self.cfg, self.tcfg.batch, self.tcfg.seq_len, extra["data"])
        self.events.append(
            f"restored step {self.data.step}; data stream replayed")
