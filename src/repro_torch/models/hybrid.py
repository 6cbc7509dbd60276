"""Zamba2-style hybrid LM: Mamba2 backbone + one *shared* attention block.

The counterpart of the JAX package's ``models/hybrid.py``.  The backbone is
a stack of Mamba2 mixer layers (``models/ssm.py``; their prefill scans run
the kernel K3 on the card, their gradients K3-bwd); one shared transformer
block (full attention + MLP, one parameter set) is applied after every
``attn_every`` backbone layers.  Its prefill attention goes through
``attn_full``, so through the kernel K2 on the card (K2-bwd under grad).
Training (``train_loss(..., remat=True)``, JAX's default) recomputes each
mamba layer in the backward and keeps the shared block's activations, as
JAX checkpoints its mamba scan body and not the shared block.

Decode state: per-layer Mamba states (O(1)) and one dense KV cache per
shared-block application, padded to ``max_len`` at prefill.  ``decode_step``
writes the new K/V rows into those caches in place (JAX returns updated
copies); the Mamba states come back as new tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common, ssm, transformer
from repro_torch.models.common import ArchCfg
from repro_torch.parallel import sharding, spmd


def n_shared_applications(cfg: ArchCfg) -> int:
    return cfg.n_layers // cfg.attn_every


class SharedBlock(nn.Module):
    """The shared block: ln1 -> attention, ln2 -> MLP."""

    def __init__(self, cfg: ArchCfg, gen, device) -> None:
        super().__init__()
        self.ln1 = common.init_norm(cfg, device)
        self.ln2 = common.init_norm(cfg, device)
        self.attn = attn.init_attn(cfg, gen, device)
        self.mlp = common.init_mlp(cfg, gen, device)


class HybridLM(nn.Module):
    """Parameters named like the JAX pytree (``mamba.<i>.mixer.w_in``,
    ``shared.attn.wq``, ...)."""

    def __init__(self, cfg: ArchCfg, *, device,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = common.init_embed(cfg, generator, device)
        self.mamba = nn.ModuleList(ssm.MambaBlock(cfg, generator, device)
                                   for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, generator, device)
        self.final_norm = common.init_norm(cfg, device)


def init_lm(cfg: ArchCfg, generator: torch.Generator) -> HybridLM:
    """Random weights drawn from ``generator``, on the generator's device."""
    return HybridLM(cfg, device=generator.device, generator=generator)


def _spans(cfg: ArchCfg):
    """[(lo, hi, shared_after), ...] covering all backbone layers."""
    napps = n_shared_applications(cfg)
    spans = [(g * cfg.attn_every, (g + 1) * cfg.attn_every, True)
             for g in range(napps)]
    if napps * cfg.attn_every < cfg.n_layers:
        spans.append((napps * cfg.attn_every, cfg.n_layers, False))
    return spans


def _shared_full(cfg: ArchCfg, sp: SharedBlock, h: torch.Tensor, freqs):
    a, kv = attn.attn_full(cfg, sp.attn, common.apply_norm(cfg, sp.ln1, h),
                           freqs=freqs, causal=True)
    h = h + a
    h = h + common.apply_mlp(cfg, sp.mlp, common.apply_norm(cfg, sp.ln2, h))
    return h, kv


def forward(cfg: ArchCfg, params: HybridLM, h: torch.Tensor, *,
            remat: bool = True) -> torch.Tensor:
    """The stack over embeddings h: (B, S, d); ``remat`` (under grad)
    recomputes each mamba layer in the backward, not the shared block."""
    freqs = common.rope_freqs(cfg, h.device)
    for lo, hi, shared in _spans(cfg):
        for lp in params.mamba[lo:hi]:
            h = common.run_layer(ssm.layer, remat, cfg, lp, h)
        if shared:
            h, _ = _shared_full(cfg, params.shared, h, freqs)
    return common.apply_norm(cfg, params.final_norm, h)


def train_loss(cfg: ArchCfg, params: HybridLM, batch: dict, *,
               remat: bool = True) -> torch.Tensor:
    h = common.embed_tokens(params.embed, batch["tokens"])
    logits = common.lm_head(cfg, params.embed,
                            forward(cfg, params, h, remat=remat))
    return common.cross_entropy(logits, batch["labels"])


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------

def init_state(cfg: ArchCfg, batch: int, max_len: int, *,
               device="cuda") -> dict:
    return {"mamba": ssm.init_mamba_state(cfg, batch, layers=cfg.n_layers,
                                          device=device),
            "kv": attn.init_kv_cache(cfg, batch, max_len,
                                     layers=n_shared_applications(cfg),
                                     device=device)}


def prefill(cfg: ArchCfg, params: HybridLM, batch: dict, *,
            max_len: int | None = None):
    """Returns (last-token logits (B, 1, V), decode state); the shared
    block's K/V are padded to ``max_len`` (default: the prompt length).

    Under a runtime mesh with a "model" axis of more than one rank, this
    rank's part of JAX's partitioned prefill (``_prefill_tp``): the state
    comes back as this rank's ``decode_state_specs`` shard, with
    "max_len", the shared-block caches' whole depth, which names their
    layout."""
    mesh = sharding.serving_mesh(cfg)
    if mesh is not None:
        return _prefill_tp(cfg, params, batch["tokens"], max_len, mesh)
    h = common.embed_tokens(params.embed, batch["tokens"])
    S = h.shape[1]
    pad = (max_len or S) - S
    freqs = common.rope_freqs(cfg, h.device)
    convs, ssds, ks, vs = [], [], [], []
    for lo, hi, shared in _spans(cfg):
        for lp in params.mamba[lo:hi]:
            y, (conv, ssd) = ssm.apply_mamba(
                cfg, lp.mixer, common.apply_norm(cfg, lp.ln, h),
                return_state=True)
            h = h + y
            convs.append(conv)
            ssds.append(ssd)
        if shared:
            h, (k, v) = _shared_full(cfg, params.shared, h, freqs)
            ks.append(F.pad(k, (0, 0, 0, 0, 0, pad)))
            vs.append(F.pad(v, (0, 0, 0, 0, 0, pad)))
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h[:, -1:])
    return logits, {
        "mamba": {"conv": torch.stack(convs), "ssd": torch.stack(ssds)},
        "kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
    }


def decode_step(cfg: ArchCfg, params: HybridLM, token: torch.Tensor,
                state: dict, pos: int):
    """token: (B, 1); ``pos``: the position this token writes to.  Returns
    (logits (B, 1, V), state), the shared block's caches written in place.

    Under a runtime mesh with a "model" axis of more than one rank, token
    holds this rank's rows and state its ``decode_state_specs`` shard
    with the caches' depth ("max_len"), as ``prefill`` returns it there
    (``_decode_tp``)."""
    mesh = sharding.serving_mesh(transformer.serving_cfg(cfg))
    if mesh is not None:
        return _decode_tp(transformer.serving_cfg(cfg), params, token, state,
                          pos, mesh)
    h = common.embed_tokens(params.embed, token)
    freqs = common.rope_freqs(cfg, h.device)
    mamba, kv = state["mamba"], state["kv"]
    convs, ssds = [], []
    app = 0
    for lo, hi, shared in _spans(cfg):
        for i in range(lo, hi):
            lp = params.mamba[i]
            y, conv, ssd = ssm.mamba_decode_step(
                cfg, lp.mixer, common.apply_norm(cfg, lp.ln, h),
                mamba["conv"][i], mamba["ssd"][i])
            h = h + y
            convs.append(conv)
            ssds.append(ssd)
        if shared:
            sp = params.shared
            a, _, _ = attn.attn_decode(
                cfg, sp.attn, common.apply_norm(cfg, sp.ln1, h),
                kv["k"][app], kv["v"][app], pos, freqs=freqs)
            h = h + a
            h = h + common.apply_mlp(cfg, sp.mlp,
                                     common.apply_norm(cfg, sp.ln2, h))
            app += 1
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h)
    return logits, {"mamba": {"conv": torch.stack(convs),
                              "ssd": torch.stack(ssds)}, "kv": kv}


# ----------------------------------------------------------------------------
# serving under a mesh: one rank's part of JAX's partitioned prefill and
# decode step.  The mamba layers are ssm.rank_states' (the state's ds over
# "model" in decode, the SSM heads in prefill); the shared block runs on
# the rank's heads where "model" divides them (attention's q/k/v from its
# column slices, K2 in prefill, its wo rows --AR-->; the MLP on its d_ff
# slice --AR-->), and decode_state_specs puts its caches' KV heads over
# "model", so a rank's cache is its heads' ("heads", the decoders' route:
# attn_decode on the rank's heads, nothing gathered).  Another cache
# layout is read and written back one application at a time, the block
# run whole.
# ----------------------------------------------------------------------------

def _shared_heads(cfg: ArchCfg, mesh) -> tuple | None:
    """The rank's (heads, KV heads) where "model" divides both, else
    None (the shared block runs whole, its weights gathered)."""
    tp = mesh.shape["model"]
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        return None
    return cfg.n_heads // tp, cfg.n_kv_heads // tp


def _shared_mlp(cfg: ArchCfg, sp: SharedBlock, h: torch.Tensor, mesh):
    """h + the shared MLP, on the rank's d_ff slice where it divides."""
    x = common.apply_norm(cfg, sp.ln2, h)
    if cfg.d_ff % mesh.shape["model"]:
        return h + common.apply_mlp(cfg, sp.mlp, x)
    return h + common.apply_mlp(cfg, sp.mlp, x,
                                w=transformer._local(sp.mlp, mesh),
                                reduce=transformer._act_sum(mesh))


def _prefill_tp(cfg: ArchCfg, params: HybridLM, tokens: torch.Tensor,
                max_len: int | None, mesh):
    tokens = ssm.whole_sequence(tokens, mesh)
    B, S = tokens.shape
    max_len = max(max_len or S, S)
    st = ssm.rank_states(cfg, mesh, B, None, lambda b: init_state(
        cfg, b, max_len, device="meta"), prefix="mamba/")
    heads = _shared_heads(cfg, mesh)
    rows = sharding.runtime_batch_spec()[0]
    src = (rows, None, "model" if heads else None, None)
    h = common.embed_tokens(params.embed, tokens)
    freqs = common.rope_freqs(cfg, h.device)
    napps = n_shared_applications(cfg)
    kept = {"k": [], "v": []}
    app = 0
    for lo, hi, shared in _spans(cfg):
        for i in range(lo, hi):
            h = ssm.prefill_layer(cfg, st, i, params.mamba[i], h)
        if not shared:
            continue
        sp = params.shared
        x = common.apply_norm(cfg, sp.ln1, h)
        if heads:
            a, kv = attn.attn_full(cfg, sp.attn, x, freqs=freqs, causal=True,
                                   w=transformer._local(sp.attn, mesh),
                                   heads=heads)
            a = transformer._act_sum(mesh)(a)
        else:
            a, kv = attn.attn_full(cfg, sp.attn, x, freqs=freqs, causal=True)
        h = _shared_mlp(cfg, sp, h + a, mesh)
        for n, t in zip(("k", "v"), kv):
            t = spmd.layer_out(F.pad(t, (0, 0, 0, 0, 0, max_len - S)), app,
                               napps, src, st.layout[f"kv/{n}"][0], mesh,
                               tag="cache")
            if t is not None:
                kept[n].append(t)
        app += 1
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h[:, -1:])
    return logits, {"mamba": st.stacks(),
                    "kv": {n: torch.stack(ts) for n, ts in kept.items()},
                    "max_len": max_len}


def _decode_tp(cfg: ArchCfg, params: HybridLM, token: torch.Tensor,
               state: dict, pos: int, mesh):
    if "max_len" not in state:
        raise ValueError("decode_step under a mesh takes the state that "
                         "prefill returns there, with its caches' depth "
                         "(max_len)")
    max_len = state["max_len"]
    st = ssm.rank_states(cfg, mesh, token.shape[0], state, lambda b:
                         init_state(cfg, b, max_len, device="meta"),
                         prefix="mamba/")
    napps = n_shared_applications(cfg)
    heads = _shared_heads(cfg, mesh)
    rows = sharding.runtime_batch_spec()[0]
    want = (rows, None, "model" if heads else None, None)
    kv = state["kv"]
    h = common.embed_tokens(params.embed, token)
    freqs = common.rope_freqs(cfg, h.device)
    app = 0
    for lo, hi, shared in _spans(cfg):
        for i in range(lo, hi):
            h = ssm.decode_layer(cfg, st, i, params.mamba[i], h)
        if not shared:
            continue
        sp = params.shared
        x = common.apply_norm(cfg, sp.ln1, h)
        spec = st.layout["kv/k"][0]
        direct = spec[0] is None and all(
            sharding.spec_axes(a) == sharding.spec_axes(b)
            for a, b in zip(spec[1:], want))
        if direct:       # the rank's heads of every position: in place
            kc, vc = kv["k"][app], kv["v"][app]
        else:
            kc, vc = (spmd.layer_in(kv[n], app, napps, spec, want, mesh,
                                    tag="cache") for n in ("k", "v"))
        if heads:
            a = transformer._act_sum(mesh)(attn.attn_decode(
                cfg, sp.attn, x, kc, vc, pos, freqs=freqs,
                w=transformer._local(sp.attn, mesh), heads=heads)[0])
        else:
            a = attn.attn_decode(cfg, sp.attn, x, kc, vc, pos,
                                 freqs=freqs)[0]
        if not direct:
            for n, t in (("k", kc), ("v", vc)):
                t = spmd.layer_out(t, app, napps, want, spec, mesh)
                if t is not None:
                    kv[n][app % len(kv[n])].copy_(t)
        h = _shared_mlp(cfg, sp, h + a, mesh)
        app += 1
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h)
    return logits, {"mamba": st.stacks(), "kv": kv, "max_len": max_len}
