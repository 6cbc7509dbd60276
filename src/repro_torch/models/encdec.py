"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The counterpart of the JAX package's ``models/encdec.py``.  The conv1d mel
frontend is a stub there and here: callers hand in precomputed frame
embeddings (B, n_frames, d_model).  The encoder is a non-causal
transformer over the frames with a learned positional table; the decoder
is a causal transformer (RoPE positions, as in the JAX package) with
cross-attention to the encoder output.  Every attention of the encoder,
of the decoder's prefill and of its cross-attention goes through
``ops.flash_attention``, so through the kernel K2 on the card (K2-bwd for
its gradient); the decoder's self-attention in a decode step is inline
PyTorch against the dense cache (``attention.attn_decode``), as JAX's is
inline jnp.

The layer stacks are ``nn.ModuleList``s walked with Python loops (JAX:
``lax.scan`` over ``enc_layers`` and ``dec_layers``, stacked separately);
``remat=True`` recomputes each layer in the backward
(``torch.utils.checkpoint``, as JAX's ``nothing_saveable`` checkpoint).

Decode state, from ``prefill(..., max_len=)``: ``k``/``v`` the decoder's
self-attention caches (L, B, max_len, Hkv, hd), JAX's layout, written in
place by ``decode_step``; ``cross_k``/``cross_v`` the encoder's K/V for
every decoder layer, kept in the kernel's (L, B, Hkv, F, hd) layout where
JAX keeps (L, B, F, Hkv, hd), so that no decode step copies them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.common import ArchCfg, dense_init


class EncLayer(nn.Module):
    """One encoder layer: ln1 -> self-attention, ln2 -> MLP."""

    def __init__(self, cfg: ArchCfg, gen, device) -> None:
        super().__init__()
        self.ln1 = common.init_norm(cfg, device)
        self.ln2 = common.init_norm(cfg, device)
        self.attn = attn.init_attn(cfg, gen, device)
        self.mlp = common.init_mlp(cfg, gen, device)


class DecLayer(nn.Module):
    """One decoder layer: ln1 -> causal self-attention, ln2 ->
    cross-attention to the encoder output, ln3 -> MLP."""

    def __init__(self, cfg: ArchCfg, gen, device) -> None:
        super().__init__()
        self.ln1 = common.init_norm(cfg, device)
        self.ln2 = common.init_norm(cfg, device)
        self.ln3 = common.init_norm(cfg, device)
        self.self_attn = attn.init_attn(cfg, gen, device)
        self.cross_attn = attn.init_attn(cfg, gen, device)
        self.mlp = common.init_mlp(cfg, gen, device)


class EncDecLM(nn.Module):
    """Parameters named like the JAX pytree (``embed.tok``, ``enc_pos``,
    ``enc_layers.<i>.attn.wq``, ``dec_layers.<i>.cross_attn.wk``,
    ``enc_norm.scale``, ``final_norm.scale``, ...)."""

    def __init__(self, cfg: ArchCfg, *, device,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = common.init_embed(cfg, generator, device)
        self.enc_pos = nn.Parameter(
            dense_init(generator, (cfg.n_frames, cfg.d_model), cfg.dtype,
                       device, scale=0.02), requires_grad=False)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, generator, device)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, generator, device)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = common.init_norm(cfg, device)
        self.final_norm = common.init_norm(cfg, device)


def init_lm(cfg: ArchCfg, generator: torch.Generator) -> EncDecLM:
    """Random weights drawn from ``generator``, on the generator's device."""
    return EncDecLM(cfg, device=generator.device, generator=generator)


def _enc_layer(cfg: ArchCfg, lp: EncLayer, h: torch.Tensor) -> torch.Tensor:
    a, _ = attn.attn_full(cfg, lp.attn, common.apply_norm(cfg, lp.ln1, h),
                          freqs=None, causal=False)
    h = h + a
    return h + common.apply_mlp(cfg, lp.mlp,
                                common.apply_norm(cfg, lp.ln2, h))


def encode(cfg: ArchCfg, params: EncDecLM, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """frames: (B, n_frames, d) stub embeddings -> encoder output."""
    h = frames.to(cfg.dtype) + common.full(params.enc_pos)[None]
    for lp in params.enc_layers:
        h = common.run_layer(_enc_layer, remat, cfg, lp, h)
    return common.apply_norm(cfg, params.enc_norm, h)


def _cross_kv(cfg: ArchCfg, lp: DecLayer, enc_out: torch.Tensor):
    """One decoder layer's cross-attention K/V from the encoder output, as
    contiguous (B, Hkv, F, hd): the kernel's layout (JAX: (B, F, Hkv, hd))."""
    B, Fr, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    p = lp.cross_attn
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return tuple(t.reshape(B, Fr, cfg.n_kv_heads, hd).transpose(1, 2)
                 .contiguous() for t in (k, v))


def _dec_layer(cfg: ArchCfg, lp: DecLayer, h: torch.Tensor,
               enc_out: torch.Tensor, freqs):
    """One decoder layer over the whole sequence; returns (h, (k, v), ckv):
    the self-attention K/V and the cross K/V."""
    a, kv = attn.attn_full(cfg, lp.self_attn,
                           common.apply_norm(cfg, lp.ln1, h), freqs=freqs,
                           causal=True)
    h = h + a
    ckv = _cross_kv(cfg, lp, enc_out)
    h = h + attn.attn_cross(cfg, lp.cross_attn,
                            common.apply_norm(cfg, lp.ln2, h), ckv)
    h = h + common.apply_mlp(cfg, lp.mlp, common.apply_norm(cfg, lp.ln3, h))
    return h, kv, ckv


def decode_stack(cfg: ArchCfg, params: EncDecLM, h: torch.Tensor,
                 enc_out: torch.Tensor, *, remat: bool = True
                 ) -> torch.Tensor:
    freqs = common.rope_freqs(cfg, h.device)
    for lp in params.dec_layers:
        h = common.run_layer(_dec_layer, remat, cfg, lp, h, enc_out, freqs)[0]
    return common.apply_norm(cfg, params.final_norm, h)


def train_loss(cfg: ArchCfg, params: EncDecLM, batch: dict, *,
               remat: bool = True) -> torch.Tensor:
    enc_out = encode(cfg, params, batch["frames"], remat=remat)
    h = common.embed_tokens(params.embed, batch["tokens"])
    h = decode_stack(cfg, params, h, enc_out, remat=remat)
    logits = common.lm_head(cfg, params.embed, h)
    return common.cross_entropy(logits, batch["labels"])


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------

def prefill(cfg: ArchCfg, params: EncDecLM, batch: dict, *,
            max_len: int | None = None, remat: bool = True):
    """Encode frames + prefill decoder tokens.  Returns (last-token logits
    (B, 1, V), state); the self-attention K/V are padded to ``max_len``
    (default: the prompt length).  ``remat`` only matters under grad."""
    enc_out = encode(cfg, params, batch["frames"], remat=remat)
    h = common.embed_tokens(params.embed, batch["tokens"])
    S = h.shape[1]
    pad = (max_len or S) - S
    freqs = common.rope_freqs(cfg, h.device)
    ks, vs, cks, cvs = [], [], [], []
    for lp in params.dec_layers:
        h, (k, v), (ck, cv) = _dec_layer(cfg, lp, h, enc_out, freqs)
        ks.append(F.pad(k, (0, 0, 0, 0, 0, pad)))
        vs.append(F.pad(v, (0, 0, 0, 0, 0, pad)))
        cks.append(ck)
        cvs.append(cv)
    h = common.apply_norm(cfg, params.final_norm, h)
    logits = common.lm_head(cfg, params.embed, h[:, -1:])
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs)}


def decode_step(cfg: ArchCfg, params: EncDecLM, token: torch.Tensor,
                state: dict, pos: int):
    """token: (B, 1); ``pos``: the position this token writes to.  Returns
    (logits (B, 1, V), state), the self-attention caches written in
    place; the cross K/V are read as they are."""
    h = common.embed_tokens(params.embed, token)
    freqs = common.rope_freqs(cfg, h.device)
    for i, lp in enumerate(params.dec_layers):
        a, _, _ = attn.attn_decode(cfg, lp.self_attn,
                                   common.apply_norm(cfg, lp.ln1, h),
                                   state["k"][i], state["v"][i], pos,
                                   freqs=freqs)
        h = h + a
        h = h + attn.attn_cross(cfg, lp.cross_attn,
                                common.apply_norm(cfg, lp.ln2, h),
                                (state["cross_k"][i], state["cross_v"][i]))
        h = h + common.apply_mlp(cfg, lp.mlp,
                                 common.apply_norm(cfg, lp.ln3, h))
    h = common.apply_norm(cfg, params.final_norm, h)
    return common.lm_head(cfg, params.embed, h), state
