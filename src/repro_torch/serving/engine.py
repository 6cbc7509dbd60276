"""Batched serving engine with a paged KV cache — the §2.2 TLB in action.

The counterpart of the JAX package's ``serving/engine.py``.  The engine owns
a physical page pool per layer; each request's logical (virtual) cache
pages are mapped to physical pages through a page table.  Page allocation
goes through buffer *registration* on an RdmaEndpoint (core/rdma): the
first touch of a page walks the "Nios II" path, later accesses hit the
hardware TLB — the engine reports the measured hit rate alongside
throughput.

Decode attention dispatches through ``kernels/ops.paged_attention``: on the
card the CUDA kernel K1 translates pages inside the kernel (the hardware
TLB); on the CPU the plain version gathers pages first (the software walk).
Whole-prompt prefill attends through ``ops.flash_attention`` (K2 on the
card).  Continuous batching: finished requests free their pages; admitted
requests prefill into freshly mapped ones.

Differences from the JAX engine, none of which changes a token:
  * the K/V pools are torch tensors on the device, updated IN PLACE (JAX
    returns new pools from every jitted step);
  * writes that JAX drops through an out-of-bounds ``mode="drop"`` scatter
    (inactive decode slots, padded chunk pages past the allocation) are
    left out by an explicit mask of the rows to write;
  * no ``jit``: each step runs eagerly.
A shared fabric simulator (``sim=``, any tier of ``fabric.make_sim``)
prices this node's migration PUTs and per-step TP collectives on one
timeline with every other node's, as in the JAX engine.

Engine scope: decoder-only transformer families (dense/moe/vlm).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import fabric
from repro_torch.core.apelink import NetModel
from repro_torch.core.rdma import RdmaEndpoint
from repro_torch.core.tlb import PAGE_BYTES
from repro_torch.core.topology import Torus
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import transformer
from repro_torch.models.common import ArchCfg
from repro_torch.models.transformer import TransformerLM


class TruncatedRunError(RuntimeError):
    """``run_to_completion`` exhausted ``max_steps`` with requests still
    in flight.  Returning silently here would quietly truncate exactly
    the tail of a long replay — the p99 requests are the ones still in
    flight — so the driver raises and carries the evidence."""

    def __init__(self, steps: int, in_flight: int) -> None:
        super().__init__(
            f"run_to_completion truncated after {steps} steps with "
            f"{in_flight} request(s) still in flight (raise max_steps, "
            "or drain the admission queue)")
        self.steps = steps
        self.in_flight = in_flight


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    pos: int = 0                 # current context length
    # trace-replay / SLO surface (optional; the engine never requires
    # them) — see the JAX package's Request for their meaning
    arrival_s: float | None = None
    admit_s: float | None = None
    first_token_s: float | None = None
    finish_s: float | None = None
    shed_s: float | None = None
    warm_tokens: int = 0
    session: int = -1

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


class PageAllocator:
    """Free-list page allocator whose pages are TLB-registered buffers."""

    def __init__(self, n_pages: int, page_tokens: int, bytes_per_token: int,
                 endpoint: RdmaEndpoint) -> None:
        self.free = list(range(n_pages - 1, -1, -1))
        self.page_tokens = page_tokens
        self.endpoint = endpoint
        self.region = endpoint.register(
            max(n_pages * page_tokens * bytes_per_token, PAGE_BYTES))
        self.translation_cost = 0.0

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError("page pool exhausted")
        page = self.free.pop()
        # translating the page's address range = registration fast/slow path
        vaddr = self.region.vaddr + page * PAGE_BYTES
        _, cost = self.endpoint.tlb.translate(vaddr)
        self.translation_cost += cost
        return page

    def release(self, pages: list[int]) -> None:
        self.free.extend(pages)

    @property
    def hit_rate(self) -> float:
        return self.endpoint.tlb.stats.hit_rate


@dataclasses.dataclass
class SlotState:
    """A running slot's exportable KV state — what a migration moves.

    ``k``/``v`` hold only the slot's LIVE pages (the ones covering
    ``seq_len`` tokens) in page-table (logical) order, shaped
    (L, n_pages, page_tokens, n_kv_heads, head_dim); the importer claims
    all ``n_alloc`` pages fresh from its own pool.  A modelled node exports
    ``k = v = None`` with ``n_live`` carrying the page count."""

    k: torch.Tensor | None
    v: torch.Tensor | None
    seq_len: int
    page_tokens: int
    n_alloc: int                 # total pages the importer must claim
    nbytes: int                  # wire payload (live page contents only)
    n_live: int = -1             # live page count when k is None

    @property
    def n_pages(self) -> int:
        """Live pages on the wire (<= n_alloc)."""
        if self.k is None:
            return int(self.n_live)
        return int(self.k.shape[1])


def _resolve_device(device) -> torch.device:
    """``None`` means the card; the CPU only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("PagedLM runs on a CUDA device and none is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch path on the CPU")
    return dev


class PagedLM:
    """Decode wrapper holding paged K/V pools for every layer.

    ``params`` is a ``TransformerLM``; it is moved to ``device`` (``None``:
    ``"cuda"``, raising when there is no card).  ``torus``/``rank`` place
    this node's fabric twin at its torus coordinate; ``tp_axes`` are the
    mesh axes of the modelled tensor-parallel deployment — default: one
    axis per torus dimension; pass ``()`` for a single-card replica.

    ``modelled=True`` keeps the whole control plane — slots, page
    allocator, TLB registration, export/import, RDMA endpoint — but
    allocates no K/V tensors: decode/prefill become pure accounting.
    """

    def __init__(self, cfg: ArchCfg, params: TransformerLM, *,
                 max_batch: int, max_seq: int, page_tokens: int = 16,
                 pool_pages: int | None = None,
                 torus: Torus | None = None,
                 tp_axes: tuple[str, ...] | None = None,
                 rank: int = 0, net: NetModel | None = None,
                 sim=None,
                 descriptor_bytes: float | None = None,
                 modelled: bool = False, device=None) -> None:
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"PagedLM serves dense/moe/vlm, not "
                             f"{cfg.family}")
        self.cfg = cfg
        self.device = _resolve_device(device)
        self.modelled = modelled
        self.params = None if modelled else params.to(self.device)
        self.page = page_tokens
        self.max_batch = max_batch
        self.pages_per_seq = -(-max_seq // page_tokens)
        need = max_batch * self.pages_per_seq
        self.n_pages = pool_pages or int(need * 1.25)
        hd = cfg.resolved_head_dim
        L = cfg.n_layers
        if modelled:
            self.k_pool = None
            self.v_pool = None
        else:
            # (L, n_pages, page, Hkv, hd) on the device, written in place
            shape = (L, self.n_pages, page_tokens, cfg.n_kv_heads, hd)
            self.k_pool = torch.zeros(shape, dtype=cfg.dtype,
                                      device=self.device)
            self.v_pool = torch.zeros_like(self.k_pool)
        self.page_table = np.zeros((max_batch, self.pages_per_seq), np.int32)
        self.seq_lens = np.zeros((max_batch,), np.int32)
        self.torus = torus or Torus((4, 4))
        self.rank = rank
        if not 0 <= rank < self.torus.size:
            raise ValueError(f"rank {rank} out of range for torus "
                             f"{self.torus.dims}")
        self.net = net or NetModel()
        # kept exactly as the JAX engine counts it (2 bytes per element
        # whatever the pool dtype), so the TLB registration — and with it
        # every reported stat — matches bit for bit
        self.bytes_per_token = 2 * L * cfg.n_kv_heads * hd * 2
        # shared fabric timeline: a serving cluster passes ONE simulator
        # (any tier of ``fabric.make_sim``; the surface is duck-typed) so
        # this node's migration PUTs and decode-step TP collectives
        # contend with every other node's traffic on the same links
        self.sim = sim
        self.endpoint = RdmaEndpoint(self.torus, rank=rank, net=self.net,
                                     sim=sim,
                                     descriptor_bytes=descriptor_bytes)
        self.allocator = PageAllocator(
            self.n_pages, page_tokens,
            bytes_per_token=self.bytes_per_token, endpoint=self.endpoint)
        # Fabric twin of a TP deployment of this model on the torus: one
        # residual-stream all-reduce per layer per decode step, priced by
        # the same CollectiveSchedule the trainer executes.  Reported in
        # stats() against the measured decode step time.
        if tp_axes is None:   # one TP axis per torus dim, whatever its rank
            names = ("x", "y", "z")
            tp_axes = tuple(names[i] if i < len(names) else f"d{i}"
                            for i in range(self.torus.ndims))
        self.tp_axes = tuple(tp_axes)
        if self.tp_axes:
            self.tp_schedule = fabric.lower_all_reduce(self.torus,
                                                       self.tp_axes)
            ar_bytes = max_batch * cfg.d_model * cfg.dtype.itemsize
            # per-decode-step TP wire bytes: one residual all-reduce per
            # layer (the per-step traffic a shared sim injects as flows)
            self.tp_step_bytes = L * ar_bytes
            self._tp_base = self.tp_schedule   # healthy-fabric lowering
            self._tp_ar_bytes = ar_bytes
            self.predicted_tp_comm_s = L * fabric.estimate(
                self.tp_schedule, ar_bytes, self.net).total_s
        else:
            self.tp_schedule = None
            self._tp_base = None
            self._tp_ar_bytes = 0
            self.tp_step_bytes = 0
            self.predicted_tp_comm_s = 0.0
        self.slot_pages: dict[int, list[int]] = {}

    # -- fault feed -------------------------------------------------------------
    def relower_tp(self, faults) -> bool:
        """Re-lower the decode TP twin through ``fabric.rewrite`` against
        a fault map.  Returns True when the twin changed; a map that
        partitions the TP ring keeps the last routable twin."""
        if self._tp_base is None:
            return False
        try:
            sched = fabric.rewrite(self._tp_base, faults) if faults \
                else self._tp_base
        except fabric.UnroutableError:
            return False
        if sched == self.tp_schedule:
            return False
        self.tp_schedule = sched
        self.predicted_tp_comm_s = self.cfg.n_layers * fabric.estimate(
            sched, self._tp_ar_bytes, self.net).total_s
        return True

    # -- slot management --------------------------------------------------------
    def _claim(self, npages: int) -> int:
        """Claim a free slot holding ``npages`` freshly allocated pages."""
        if npages > self.pages_per_seq:
            # ValueError, NOT RuntimeError: admission retries RuntimeError
            # (transient exhaustion), but an oversize request can never fit
            raise ValueError(
                f"request needs {npages} pages > pages_per_seq "
                f"{self.pages_per_seq} (raise max_seq or shorten it)")
        used = set(self.slot_pages)
        slot = next((i for i in range(self.max_batch) if i not in used),
                    None)
        if slot is None:
            raise RuntimeError("no free decode slot")
        pages: list[int] = []
        try:
            for _ in range(npages):
                pages.append(self.allocator.alloc())
        except RuntimeError:
            # pool exhausted mid-claim: hand the partial allocation back
            self.allocator.release(pages)
            raise
        self.slot_pages[slot] = pages
        self.page_table[slot, :npages] = pages
        self.seq_lens[slot] = 0
        return slot

    def claim_slot(self, prompt_len: int, max_new: int) -> int:
        return self._claim(-(-(prompt_len + max_new) // self.page))

    def free_slot(self, slot: int) -> None:
        self.allocator.release(self.slot_pages.pop(slot))
        self.seq_lens[slot] = 0

    # -- slot migration (export/import) -----------------------------------------
    def live_pages(self, slot: int) -> list[int]:
        """The slot's pages actually covering its ``seq_len`` tokens."""
        seq_len = int(self.seq_lens[slot])
        n_live = min(len(self.slot_pages[slot]), -(-seq_len // self.page))
        return self.slot_pages[slot][:n_live]

    def export_slot(self, slot: int) -> SlotState:
        """Snapshot a slot's live KV pages (logical order) + seq_len."""
        live = self.live_pages(slot)
        nbytes = len(live) * self.page * self.bytes_per_token
        if self.modelled:
            return SlotState(
                k=None, v=None,
                seq_len=int(self.seq_lens[slot]), page_tokens=self.page,
                n_alloc=len(self.slot_pages[slot]), n_live=len(live),
                nbytes=nbytes)
        idx = torch.tensor(live, dtype=torch.long, device=self.device)
        return SlotState(
            k=self.k_pool[:, idx], v=self.v_pool[:, idx],
            seq_len=int(self.seq_lens[slot]), page_tokens=self.page,
            n_alloc=len(self.slot_pages[slot]), nbytes=nbytes)

    def import_slot(self, state: SlotState) -> int:
        """Land a migrated slot: claim ``n_alloc`` local pages, write the
        live KV contents, restore the sequence length."""
        if state.page_tokens != self.page:
            raise ValueError(
                f"page_tokens mismatch: exported {state.page_tokens}, "
                f"local {self.page}")
        if state.n_pages > state.n_alloc:
            raise ValueError(f"corrupt slot state: {state.n_pages} live "
                             f"pages > {state.n_alloc} allocated")
        slot = self._claim(state.n_alloc)
        if state.n_pages and not self.modelled and state.k is not None:
            idx = torch.tensor(self.slot_pages[slot][:state.n_pages],
                               dtype=torch.long, device=self.device)
            self.k_pool[:, idx] = state.k.to(self.device)
            self.v_pool[:, idx] = state.v.to(self.device)
        self.seq_lens[slot] = state.seq_len
        return slot

    # -- compute -------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.no_grad()
    def _prefill_logits(self, slot: int, prompt: np.ndarray) -> torch.Tensor:
        """Prefill one request's prompt into its pages (batch of 1).

        Tokens are right-padded to a page multiple; the returned logits (V,)
        are taken at the *true* last prompt position."""
        cfg = self.cfg
        pad = (-len(prompt)) % self.page
        tokens = self._tensor(np.pad(prompt, (0, pad))[None]
                              .astype(np.int64))
        S = tokens.shape[1]
        _, cache, h = transformer.prefill(cfg, self.params,
                                          {"tokens": tokens}, max_len=S,
                                          return_hidden=True,
                                          moe_dropless=True)
        logits = common.lm_head(cfg, self.params.embed,
                                h[:, len(prompt) - 1])
        npage_prompt = S // self.page   # S is padded to page multiple
        dest = self._tensor(self.page_table[slot, :npage_prompt]
                            .astype(np.int64))
        shape = (cfg.n_layers, npage_prompt, self.page, cfg.n_kv_heads, -1)
        self.k_pool[:, dest] = cache["k"][:, 0].reshape(shape)
        self.v_pool[:, dest] = cache["v"][:, 0].reshape(shape)
        return logits[0]

    @torch.no_grad()
    def _prefill_chunk_logits(self, slot: int, tokens: np.ndarray,
                              start_pos: int, n_alloc: int) -> torch.Tensor:
        """Prefill ONE page-aligned chunk of a prompt (batch of 1).

        Each chunk writes its K/V into the slot's pages and attends all
        cached positions <= its own, so the math per query is identical to
        the whole-prompt prefill.  This attention is plain PyTorch on every
        device, as the JAX engine's is inline jnp rather than a kernel.

        tokens: (T,) with T a page multiple (final chunk right-padded);
        start_pos: absolute position of tokens[0] (page-aligned); n_alloc:
        pages claimed for the slot — pages past it are not written (their
        queries are padding, never read).  Returns logits (T, V)."""
        cfg = self.cfg
        dev = self.device
        T = tokens.shape[0]
        npage = T // self.page
        hd = cfg.resolved_head_dim
        group = cfg.n_heads // cfg.n_kv_heads
        S_all = self.pages_per_seq * self.page
        h = common.embed_tokens(self.params.embed,
                                self._tensor(tokens[None].astype(np.int64)))
        freqs = common.rope_freqs(cfg, dev)
        pos = start_pos + torch.arange(T, device=dev)
        page0 = start_pos // self.page
        rows = self._tensor(self.page_table[slot].astype(np.int64))
        n_write = max(0, min(npage, n_alloc - page0))
        dest = rows[page0:page0 + n_write]
        mask = torch.arange(S_all, device=dev)[None, :] <= pos[:, None]
        for li, lp in enumerate(self.params.layers):
            kp, vp = self.k_pool[li], self.v_pool[li]
            x = common.apply_norm(cfg, lp.ln1, h)
            q, k, v = attn_mod._project_qkv(cfg, lp.attn, x, x)
            q = common.apply_rope(q, pos[None], freqs)
            k = common.apply_rope(k, pos[None], freqs)
            kp[dest] = k[0].reshape(npage, self.page, cfg.n_kv_heads,
                                    hd)[:n_write]
            vp[dest] = v[0].reshape(npage, self.page, cfg.n_kv_heads,
                                    hd)[:n_write]
            kd = kp[rows].reshape(S_all, cfg.n_kv_heads, hd)
            vd = vp[rows].reshape(S_all, cfg.n_kv_heads, hd)
            qf = q[0].float() * hd ** -0.5
            kf = kd.float()
            vf = vd.float()
            if group > 1:
                kf = kf.repeat_interleave(group, dim=1)
                vf = vf.repeat_interleave(group, dim=1)
            logits = torch.einsum("qhd,khd->hqk", qf, kf)
            logits = logits.masked_fill(~mask[None], float("-inf"))
            probs = torch.softmax(logits, dim=-1)
            out = torch.einsum("hqk,khd->qhd", probs, vf)
            h = h + out.to(h.dtype).reshape(1, T, -1) @ lp.attn["wo"]
            h = h + transformer._mix(cfg, lp, h, moe_dropless=True)
        h = common.apply_norm(cfg, self.params.final_norm, h)
        return common.lm_head(cfg, self.params.embed, h)[0]

    @torch.no_grad()
    def decode_logits(self, tokens: np.ndarray,
                      active: np.ndarray) -> torch.Tensor:
        """One batched decode step over all slots: writes each active
        slot's new K/V into its current page and returns logits (B, V)
        (zero rows for inactive slots).  ``seq_lens`` is not advanced.

        tokens: (B,) int; active: (B,) bool."""
        cfg = self.cfg
        dev = self.device
        B = tokens.shape[0]
        h = common.embed_tokens(self.params.embed,
                                self._tensor(tokens[:, None].astype(np.int64)))
        freqs = common.rope_freqs(cfg, dev)
        seq_lens = self._tensor(self.seq_lens)
        pos = seq_lens.long()
        page_table = self._tensor(self.page_table)
        # this step's K/V go to each ACTIVE slot's current page; inactive
        # slots write nothing (their pages may already belong to a newly
        # admitted request) — JAX drops those writes out of bounds
        act = np.flatnonzero(active)
        act_t = self._tensor(act.astype(np.int64))
        phys = self._tensor(self.page_table[act, self.seq_lens[act]
                                            // self.page].astype(np.int64))
        off = self._tensor((self.seq_lens[act] % self.page).astype(np.int64))
        attend_lens = seq_lens + 1
        for li, lp in enumerate(self.params.layers):
            kp, vp = self.k_pool[li], self.v_pool[li]
            x = common.apply_norm(cfg, lp.ln1, h)
            q, k, v = attn_mod._project_qkv(cfg, lp.attn, x, x)
            q = common.apply_rope(q, pos[:, None], freqs)
            k = common.apply_rope(k, pos[:, None], freqs)
            kp[phys, off] = k[act_t, 0]
            vp[phys, off] = v[act_t, 0]
            out = ops.paged_attention(q[:, 0].contiguous(), kp, vp,
                                      page_table, attend_lens)
            h = h + out.reshape(B, 1, -1) @ lp.attn["wo"]
            h = h + transformer._mix(cfg, lp, h, moe_dropless=True)
        h = common.apply_norm(cfg, self.params.final_norm, h)
        logits = common.lm_head(cfg, self.params.embed, h)[:, 0]
        return torch.where(self._tensor(active)[:, None], logits, 0.0)

    # -- public API ---------------------------------------------------------------
    def prefill_slot(self, slot: int, prompt: np.ndarray) -> int:
        logits = self._prefill_logits(slot, prompt)
        self.seq_lens[slot] = len(prompt)
        return int(torch.argmax(logits))

    def prefill_slot_chunk(self, slot: int, prompt: np.ndarray, start: int,
                           chunk_tokens: int) -> int | None:
        """Prefill ``prompt[start:start+chunk_tokens]`` into the slot.

        ``start`` and ``chunk_tokens`` must be page multiples.  Returns the
        first generated token when the chunk covers the prompt tail (the
        request is then decode-ready), else None."""
        if start % self.page or chunk_tokens % self.page:
            raise ValueError("chunk boundaries must be page-aligned")
        end = min(start + chunk_tokens, len(prompt))
        toks = np.zeros((chunk_tokens,), np.int32)
        toks[:end - start] = prompt[start:end]
        logits = self._prefill_chunk_logits(slot, toks, start,
                                            len(self.slot_pages[slot]))
        if end < len(prompt):
            return None
        self.seq_lens[slot] = len(prompt)
        return int(torch.argmax(logits[len(prompt) - 1 - start]))

    def decode_batch(self, tokens: np.ndarray, active: np.ndarray):
        logits = self.decode_logits(tokens, active)
        self.seq_lens = self.seq_lens + active.astype(np.int32)
        return torch.argmax(logits, -1).cpu().numpy()


class Engine:
    """Continuous-batching loop over a PagedLM.

    ``chunked_prefill=True`` admits prompts in page-sized chunks
    interleaved with decode steps (one chunk per prefilling request per
    engine step), so a long prompt no longer stalls the running batch for
    its whole forward.  Tokens are identical to whole-prompt prefill.
    """

    def __init__(self, lm: PagedLM, *, chunked_prefill: bool = False,
                 prefill_chunk_pages: int = 1) -> None:
        self.lm = lm
        self.chunked_prefill = chunked_prefill
        self.chunk_tokens = max(prefill_chunk_pages, 1) * lm.page
        self.pending: list[Request] = []
        self.prefilling: dict[int, Request] = {}
        self.running: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.steps = 0
        self.prefill_chunks = 0
        self.decode_stall_s = 0.0   # non-decode work while a batch waited
        self._step_times: list[float] = []
        # shared-timeline accounting (lm.sim attached): each decode step
        # injects the node's TP collective traffic as flows; the timeline
        # owner (the serving cluster) settles them per logical window
        self.pending_comm_fids: list[int] = []
        self.sim_tp_comm_s = 0.0    # settled, contention-priced TP comm
        self.sim_comm_steps = 0
        # per-window accounting, read (and cleared) by a window owner
        self.window_first: list[Request] = []
        self.window_finished: list[Request] = []
        self.window_decode_tokens = 0
        self.window_cold_prefill_tokens = 0

    @property
    def load(self) -> int:
        """Requests this engine is responsible for (the router's metric)."""
        return len(self.pending) + len(self.prefilling) + len(self.running)

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    # -- migration hooks --------------------------------------------------------
    def detach(self, slot: int) -> Request:
        """Hand a running request over to a migration (its pages stay
        claimed until the caller frees them)."""
        return self.running.pop(slot)

    def attach(self, req: Request) -> None:
        """Adopt a migrated request whose slot was already imported."""
        if req.slot is None or req.slot in self.running:
            raise ValueError(f"cannot attach request {req.rid} at slot "
                             f"{req.slot}")
        self.running[req.slot] = req

    def _admit(self) -> int:
        admitted = 0
        while self.pending and len(self.running) + len(self.prefilling) \
                < self.lm.max_batch:
            req = self.pending.pop(0)
            try:
                slot = self.lm.claim_slot(len(req.prompt),
                                          req.max_new_tokens)
            except RuntimeError:
                self.pending.insert(0, req)
                return admitted
            except ValueError:
                # oversize request: surface the error, but keep the request
                # addressable (it must not vanish from every queue)
                self.pending.insert(0, req)
                raise
            req.slot = slot
            admitted += 1
            if self.chunked_prefill:
                req.pos = 0
                self.prefilling[slot] = req
            else:
                if self.lm.modelled:
                    # accounting-only prefill: the warm prefix is skipped,
                    # the cold remainder is charged to the window
                    warm = min(max(req.warm_tokens, 0), len(req.prompt))
                    self.window_cold_prefill_tokens += \
                        len(req.prompt) - warm
                    self.lm.seq_lens[slot] = len(req.prompt)
                    first = 0
                else:
                    first = self.lm.prefill_slot(slot, req.prompt)
                req.out_tokens.append(first)
                req.pos = len(req.prompt)
                self.running[slot] = req
                self.window_first.append(req)
        return admitted

    def _advance_prefills(self) -> int:
        """One chunk per prefilling request per engine step."""
        if self.lm.modelled:
            return self._advance_prefills_modelled()
        chunks = 0
        for slot, req in list(self.prefilling.items()):
            tok = self.lm.prefill_slot_chunk(slot, req.prompt, req.pos,
                                             self.chunk_tokens)
            self.prefill_chunks += 1
            chunks += 1
            req.pos = min(req.pos + self.chunk_tokens, len(req.prompt))
            if tok is not None:
                req.out_tokens.append(tok)
                req.pos = len(req.prompt)
                del self.prefilling[slot]
                self.running[slot] = req
                self.window_first.append(req)
        return chunks

    def _advance_prefills_modelled(self) -> int:
        """Accounting-only chunked prefill: the warm prefix is skipped
        outright, each step charges one chunk of the cold remainder, and
        the request goes decode-ready when the cursor covers the prompt."""
        chunks = 0
        for slot, req in list(self.prefilling.items()):
            if req.pos == 0 and req.warm_tokens > 0:
                req.pos = min(req.warm_tokens, len(req.prompt))
            end = min(req.pos + self.chunk_tokens, len(req.prompt))
            self.window_cold_prefill_tokens += end - req.pos
            req.pos = end
            self.prefill_chunks += 1
            chunks += 1
            if req.pos >= len(req.prompt):
                self.lm.seq_lens[slot] = len(req.prompt)
                req.out_tokens.append(0)
                req.pos = len(req.prompt)
                del self.prefilling[slot]
                self.running[slot] = req
                self.window_first.append(req)
        return chunks

    def step(self) -> None:
        t0 = time.perf_counter()
        self.window_first = []
        self.window_finished = []
        self.window_decode_tokens = 0
        self.window_cold_prefill_tokens = 0
        had_batch = bool(self.running)
        worked = self._admit()
        if self.chunked_prefill:
            worked += self._advance_prefills()
        if had_batch and worked:
            # prefill work ran while the decode batch sat idle: the
            # admission stall the chunked path bounds at one chunk
            self.decode_stall_s += time.perf_counter() - t0
        if not self.running:
            return
        if self.lm.modelled:
            self._step_modelled(t0)
            return
        B = self.lm.max_batch
        tokens = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        for slot, req in self.running.items():
            tokens[slot] = req.out_tokens[-1]
            active[slot] = not req.done
        self.window_decode_tokens += int(active.sum())
        nxt = self.lm.decode_batch(tokens, active)
        if self.lm.sim is not None and self.lm.tp_schedule is not None:
            # this step's TP collectives enter the shared timeline at the
            # current window start, tagged DECODE; settle_comm prices them
            # with whatever traffic they contended against
            self._inject_tp()
        self.steps += 1
        self._step_times.append(time.perf_counter() - t0)
        for slot, req in list(self.running.items()):
            if active[slot]:
                req.out_tokens.append(int(nxt[slot]))
                req.pos += 1
            if req.done:
                self.lm.free_slot(slot)
                self.finished.append(self.running.pop(slot))
                self.window_finished.append(req)

    def _step_modelled(self, t0: float) -> None:
        """Decode step on a modelled lm: token bookkeeping only (the
        placeholder token is 0), same batch/finish semantics."""
        for slot, req in list(self.running.items()):
            if not req.done:
                req.out_tokens.append(0)
                req.pos += 1
                self.lm.seq_lens[slot] += 1
                self.window_decode_tokens += 1
            if req.done:
                self.lm.free_slot(slot)
                self.finished.append(self.running.pop(slot))
                self.window_finished.append(req)
        if self.lm.sim is not None and self.lm.tp_schedule is not None:
            # the fabric twin is real even when the FLOPs are modelled
            self._inject_tp()
        self.steps += 1
        self._step_times.append(time.perf_counter() - t0)

    def _inject_tp(self) -> None:
        self.pending_comm_fids.extend(fabric.inject_schedule(
            self.lm.sim, self.lm.tp_schedule, self.lm.tp_step_bytes,
            start_s=self.lm.sim.now, granularity="phase",
            cls=fabric.TrafficClass.DECODE))
        self.sim_comm_steps += 1

    def settle_comm(self, window_start: float) -> float:
        """Resolve this window's injected TP flows against the shared
        timeline; accrues their contention-priced time and returns the
        window's comm end (``window_start`` when idle).  Called by the
        timeline owner (the serving cluster) once per logical window."""
        if not self.pending_comm_fids:
            return window_start
        sim = self.lm.sim
        sim.run()
        end = max(sim.finish_s(f) for f in self.pending_comm_fids)
        self.pending_comm_fids = []
        self.sim_tp_comm_s += max(end - window_start, 0.0)
        return end

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        steps = 0
        while (self.pending or self.prefilling or self.running) \
                and steps < max_steps:
            self.step()
            steps += 1
        if self.pending or self.prefilling or self.running:
            raise TruncatedRunError(steps, self.load)

    def stats(self) -> dict:
        alloc = self.lm.allocator
        # median, not mean: the first decode step carries one-time set-up
        measured = (float(np.median(self._step_times))
                    if self._step_times else 0.0)
        return {
            "decode_steps": self.steps,
            "finished": len(self.finished),
            "tlb_hit_rate": alloc.hit_rate,
            "translation_cost_s": alloc.translation_cost,
            # fabric CollectiveSchedule prediction vs wall clock: the
            # per-step TP all-reduce cost a torus deployment would add
            "predicted_tp_comm_s": self.lm.predicted_tp_comm_s,
            "measured_step_s": measured,
            "chunked_prefill": self.chunked_prefill,
            "prefill_chunks": self.prefill_chunks,
            "decode_stall_s": self.decode_stall_s,
            # shared-timeline contention pricing (0.0 without a sim): TP
            # comm as settled against every other node's traffic
            "sim_tp_comm_s": self.sim_tp_comm_s,
            "sim_comm_steps": self.sim_comm_steps,
        }
