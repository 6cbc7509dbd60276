"""Per-architecture smoke tests of the PyTorch port, the mirror of
``tests/test_arch_smoke.py``: every arch of ``ALL_ARCHS`` on its REDUCED
same-family config, one train step and one prefill + decode step on the
CPU, asserting shapes, finite values and a nonzero gradient.  The FULL
configs are built on the meta device only (nothing allocated), to hold
their settings and parameter counts to the JAX package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import weights  # noqa: E402
from repro_torch.configs import (ALL_ARCHS, get_config,  # noqa: E402
                                 get_reduced)
from repro_torch.models import api  # noqa: E402
from repro_torch.models.common import ArchCfg  # noqa: E402


def make_batch(cfg: ArchCfg, B=2, S=16, *, labels=True, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int64))}
    if labels:
        batch["labels"] = batch["tokens"]
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(B, cfg.n_frames, cfg.d_model))).to(cfg.dtype)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.from_numpy(
            rng.normal(size=(B, cfg.n_patches, cfg.d_model))).to(cfg.dtype)
    return batch


def init(cfg: ArchCfg):
    return api.get_model(cfg).init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_reduced_train_step(arch):
    cfg = get_reduced(arch)
    model = api.get_model(cfg)
    params = init(cfg)
    for p in params.parameters():
        p.requires_grad_(True)
    loss = model.train_loss(params, make_batch(cfg))
    assert loss.shape == ()
    assert np.isfinite(float(loss.detach())), arch
    loss.backward()
    grads = [p.grad for p in params.parameters() if p.grad is not None]
    assert grads, arch
    gnorm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    assert np.isfinite(gnorm) and gnorm > 0, arch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_reduced_prefill_decode(arch):
    cfg = get_reduced(arch)
    model = api.get_model(cfg)
    params = init(cfg)
    B, S = 2, 16
    batch = make_batch(cfg, B, S, labels=False)
    # note VLM context includes the patch prefix: the cache must hold it
    # and the decoded token (JAX's test sizes it S + 4 and its decode
    # write clamps into the last row; the port's raises, see below)
    pos = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    if cfg.family in ("dense", "moe", "vlm", "zamba2", "encdec"):
        logits, state = model.prefill(params, batch, max_len=pos + 4)
    else:
        logits, state = model.prefill(params, batch)
    assert logits.shape[0] == B and logits.shape[-1] == cfg.vocab
    assert not bool(torch.isnan(logits).any()), arch
    # one decode step
    tok = logits[:, -1].argmax(-1)[:, None]
    logits2, state2 = model.decode_step(params, tok, state, pos)
    assert logits2.shape == (B, 1, cfg.vocab)
    assert not bool(torch.isnan(logits2).any()), arch


def test_decode_past_the_cache_raises():
    """A decode position past the dense cache raises; JAX's
    ``dynamic_update_slice`` clamps it into the last row instead (ROADMAP
    §3), which ``tests/test_arch_smoke.py``'s VLM case runs into."""
    cfg = get_reduced("internvl2-76b")
    model = api.get_model(cfg)
    params = init(cfg)
    S = 16
    logits, state = model.prefill(params, make_batch(cfg, 2, S, labels=False),
                                  max_len=S + 4)
    assert state["k"].shape[2] == S + cfg.n_patches
    with pytest.raises(IndexError):
        model.decode_step(params, logits[:, -1].argmax(-1)[:, None], state,
                          S + cfg.n_patches)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_config_builds_with_jax_settings(arch):
    """The port's FULL configs carry the JAX package's settings, and the
    model they build has its parameter count (meta device)."""
    jconfigs = pytest.importorskip("repro.configs")
    japi = pytest.importorskip("repro.models.api")
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    for f in ("family", "n_layers", "n_enc_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "resolved_head_dim", "norm",
              "mlp", "qkv_bias", "tie_embeddings", "n_frames", "n_patches",
              "attn_every", "full_attention", "attn_dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
    lm = weights._LM[cfg.family][0](cfg, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    assert n == japi.param_count(jcfg), arch
