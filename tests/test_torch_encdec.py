"""The encoder-decoder family (whisper) of the PyTorch port vs the JAX
package, on the CPU, from the same weights.

The JAX parameter pytree goes across as numpy arrays
(``repro_torch.weights.from_jax_params``); both packages then run
``encode``, ``prefill``, greedy ``decode_step``s, ``train_loss`` with its
gradients, and the ``Trainer`` (``comm="single"``) on the same numpy
inputs.  The JAX side runs its jnp attention (its encdec reaches no Pallas
kernel); the port's runs the plain version of K2 (``ref.mha_attention``),
as every CPU tensor does.  Config: the reduced ``encdec`` (2 + 2 layers, 8
frames, 4 heads over 2 KV heads of 16).  Tolerances: fp32 3e-4, bf16 6e-2
(the bars of ``tests/test_kernels.py``); Trainer losses rtol 1e-5.

The port keeps the cross-attention K/V in the kernel's (L, B, Hkv, F, hd)
layout where JAX keeps (L, B, F, Hkv, hd): the comparisons transpose them.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

NAME = "whisper-large-v3"
F32 = dict(rtol=3e-4, atol=3e-4)
BF16 = dict(rtol=6e-2, atol=6e-2)
TOL = {"f32": F32, "bf16": BF16}
B, S, STEPS = 2, 6, 8


def both(dtype: str = "f32", **over):
    """(jax cfg, jax params, port cfg, port model) from the same weights."""
    jover, tover = dict(over), dict(over)
    if dtype == "bf16":
        jover["dtype"], tover["dtype"] = jnp.bfloat16, torch.bfloat16
    jcfg = jconfigs.get_config(NAME).reduced(**jover)
    tcfg = tconfigs.get_config(NAME).reduced(**tover)
    jp = jencdec.init_lm(jcfg, jax.random.key(0))
    tp = weights.from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jcfg, jp, tcfg, tp


def inputs(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, cfg.n_frames, cfg.d_model)) \
        .astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return frames, tokens


def jbatch(frames, tokens, labels=None):
    out = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    if labels is not None:
        out["labels"] = jnp.asarray(labels)
    return out


def tbatch(frames, tokens, labels=None):
    out = {"frames": torch.from_numpy(frames),
           "tokens": torch.from_numpy(tokens).long()}
    if labels is not None:
        out["labels"] = torch.from_numpy(labels).long()
    return out


def assert_close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weights_round_trip_bit_for_bit(dtype):
    """from_jax_params -> to_jax_params gives JAX's tree back, bits and
    all; the two stacked keys keep their own depths."""
    jcfg, jp, tcfg, tp = both(dtype, n_enc_layers=3)
    assert weights.stacked_axes(tcfg) == {"enc_layers": 3, "dec_layers": 2}
    assert len(tp.enc_layers) == 3 and len(tp.dec_layers) == 2
    want = jax.tree.map(np.asarray, jp)
    back = weights.to_jax_params(tcfg, tp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_jax_leaves_follow_the_jax_tree():
    """The optimizer's leaves are JAX's, in JAX's order and shapes: the
    stacked norms and ``enc_pos`` are 2-D, so AdamW decays them as JAX's
    ``ndim >= 2`` rule does; ``enc_norm`` and ``final_norm`` are 1-D."""
    jcfg, jp, tcfg, tp = both()
    leaves = weights.jax_leaves(tcfg, tp)
    want, _ = jax.tree_util.tree_flatten_with_path(jp)
    assert list(leaves) == ["/".join(p.key for p in path)
                            for path, _ in want]
    for (_, a), (path, ps) in zip(want, leaves.items()):
        assert tuple(weights.leaf_tensor(tcfg, path, ps).shape) == a.shape
    assert weights.leaf_tensor(tcfg, "enc_layers/ln1/scale",
                               leaves["enc_layers/ln1/scale"]).dim() == 2
    assert leaves["enc_pos"][0].dim() == 2
    assert leaves["enc_norm/scale"][0].dim() == 1


def test_layers_and_init_follow_the_jax_names():
    """EncLayer / DecLayer name their parameters as JAX's init_enc_layer /
    init_dec_layer key theirs; init_lm draws from the generator (the same
    seed, the same weights)."""
    jcfg = jconfigs.get_reduced(NAME)
    tcfg = tconfigs.get_reduced(NAME)
    key = jax.random.key(0)

    def names(tree):
        return sorted("/".join(p.key for p in path) for path, _ in
                      jax.tree_util.tree_flatten_with_path(tree)[0])

    for jinit, layer_cls in ((jencdec.init_enc_layer, tencdec.EncLayer),
                             (jencdec.init_dec_layer, tencdec.DecLayer)):
        layer = layer_cls(tcfg, torch.Generator().manual_seed(0), "cpu")
        assert sorted(n.replace(".", "/") for n, _ in
                      layer.named_parameters()) == names(jinit(jcfg, key))
    a = tencdec.init_lm(tcfg, torch.Generator().manual_seed(4))
    b = tencdec.init_lm(tcfg, torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert abs(float(a.enc_pos.std()) - 0.02) < 0.005


def test_from_jax_params_checks_each_stack_depth():
    jcfg, jp, tcfg, tp = both()
    bad = dataclasses.replace(tcfg, n_enc_layers=3)
    with pytest.raises(ValueError, match="enc_layers"):
        weights.from_jax_params(bad, jax.tree.map(np.asarray, jp),
                                device="cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attn_cross_matches_jax(dtype):
    """attn_cross (K2's non-causal route) against JAX's, Sq != Skv, with
    the K/V in each package's layout."""
    jcfg, jp, tcfg, tp = both(dtype)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 5, jcfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(B, 11, jcfg.n_kv_heads, 16)).astype(np.float32)
            for _ in range(2))
    jp_l = jax.tree.map(lambda a: a[0], jp["dec_layers"])["cross_attn"]
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    want = jattn.attn_cross(jcfg, jp_l, jnp.asarray(x, jdt),
                            (jnp.asarray(k, jdt), jnp.asarray(v, jdt)))
    tdt = tcfg.dtype
    tkv = tuple(torch.from_numpy(a).to(tdt).transpose(1, 2).contiguous()
                for a in (k, v))
    got = tattn.attn_cross(tcfg, tp.dec_layers[0].cross_attn,
                           torch.from_numpy(x).to(tdt), tkv)
    assert got.dtype == tdt
    assert_close(got, want, TOL[dtype])


def test_attn_cross_over_no_keys_gives_zero():
    """Non-causal rows are empty only when there is no key (F = 0): they
    give 0, as K2 does and as JAX's attn_cross does (ROADMAP §3)."""
    jcfg, jp, tcfg, tp = both()
    x = np.random.default_rng(2).normal(size=(B, 3, jcfg.d_model)) \
        .astype(np.float32)
    jp_l = jax.tree.map(lambda a: a[0], jp["dec_layers"])["cross_attn"]
    jk = jnp.zeros((B, 0, jcfg.n_kv_heads, 16))
    want = jattn.attn_cross(jcfg, jp_l, jnp.asarray(x), (jk, jk))
    k = torch.zeros(B, tcfg.n_kv_heads, 0, 16)
    got = tattn.attn_cross(tcfg, tp.dec_layers[0].cross_attn,
                           torch.from_numpy(x), (k, k))
    assert got.shape == (B, 3, tcfg.d_model)
    assert not got.any() and not np.asarray(want).any()


def test_plain_attention_over_no_keys_gives_zero_and_no_gradient():
    """The plain version of K2 (the CPU path) at Skv = 0: zeros (it raised
    on the empty softmax before), and a zero gradient for q."""
    from repro_torch.kernels import ops
    q = torch.randn(1, 4, 3, 16, requires_grad=True)
    k = torch.zeros(1, 2, 0, 16)
    out = ops.flash_attention(q, k, k, causal=False)
    assert out.shape == q.shape and not out.any()
    out.sum().backward()
    assert not q.grad.any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_matches_jax(dtype):
    jcfg, jp, tcfg, tp = both(dtype)
    frames, _ = inputs(jcfg)
    want = jencdec.encode(jcfg, jp, jnp.asarray(frames), remat=False)
    got = tencdec.encode(tcfg, tp, torch.from_numpy(frames), remat=False)
    assert got.dtype == tcfg.dtype and got.shape == want.shape
    assert_close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_logits_and_state_match_jax(dtype):
    jcfg, jp, tcfg, tp = both(dtype)
    frames, tokens = inputs(jcfg)
    jl, js = jencdec.prefill(jcfg, jp, jbatch(frames, tokens),
                             max_len=S + STEPS, remat=False)
    tl, ts = tapi.get_model(tcfg).prefill(tp, tbatch(frames, tokens),
                                          max_len=S + STEPS)
    assert set(ts) == set(js) == {"k", "v", "cross_k", "cross_v"}
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert_close(tl, jl, TOL[dtype])
    for key in ("k", "v"):
        assert tuple(ts[key].shape) == js[key].shape
        assert_close(ts[key], js[key], TOL[dtype])
    for key in ("cross_k", "cross_v"):     # (L, B, Hkv, F, hd) in the port
        assert ts[key].is_contiguous()
        assert_close(ts[key].transpose(2, 3), js[key], TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_greedy_decode_matches_jax(dtype):
    """Prefill, then 8 greedy steps in each package: identical tokens, and
    each step's logits within the bar."""
    jcfg, jp, tcfg, tp = both(dtype)
    frames, tokens = inputs(jcfg, seed=2)
    model = tapi.get_model(tcfg)
    jl, js = jencdec.prefill(jcfg, jp, jbatch(frames, tokens),
                             max_len=S + STEPS, remat=False)
    tl, ts = model.prefill(tp, tbatch(frames, tokens), max_len=S + STEPS)
    jtok, ttok = [], []
    jstep = jax.jit(lambda p, t, s, pos: jencdec.decode_step(jcfg, p, t, s,
                                                             pos))
    for i in range(STEPS):
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tt = tl[:, -1].argmax(-1)[:, None]
        jtok.append(np.asarray(jt))
        ttok.append(tt.numpy())
        jl, js = jstep(jp, jt, js, S + i)
        tl, ts = model.decode_step(tp, tt, ts, S + i)
        assert tl.shape == (B, 1, tcfg.vocab)
        assert_close(tl, jl, TOL[dtype])
    np.testing.assert_array_equal(np.concatenate(ttok, 1),
                                  np.concatenate(jtok, 1))
    # the self-attention caches were written in place, row by row
    assert_close(ts["k"], js["k"], TOL[dtype])


@pytest.mark.parametrize("remat", [True, False])
def test_train_loss_and_every_gradient_match_jax(remat):
    jcfg, jp, tcfg, tp = both()
    frames, tokens = inputs(jcfg, seed=3)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)],
                            1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jencdec.train_loss(jcfg, p, jbatch(frames, tokens, labels),
                                     remat=remat))(jp)
    for p in tp.parameters():
        p.requires_grad_(True)
    loss = tapi.get_model(tcfg).train_loss(
        tp, tbatch(frames, tokens, labels), remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32)
    leaves = weights.jax_leaves(tcfg, tp)
    want, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    assert len(want) == len(leaves)
    for path, g in want:
        key = "/".join(p.key for p in path)
        got = weights.leaf_tensor(tcfg, key, [p.grad for p in leaves[key]])
        assert_close(got, g, F32)


def test_remat_changes_no_loss_or_gradient():
    _, _, tcfg, tp = both()
    frames, tokens = inputs(tcfg, seed=4)
    batch = tbatch(frames, tokens, tokens)
    for p in tp.parameters():
        p.requires_grad_(True)
    out = {}
    for remat in (True, False):
        tp.zero_grad()
        loss = tencdec.train_loss(tcfg, tp, batch, remat=remat)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad.clone()
                                      for p in tp.parameters()])
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1],
                                                 out[False][1]))


def test_encdec_has_no_zero_decode_state():
    """JAX's encdec Model has no init_decode_state: the state comes from
    prefill.  The port's field raises rather than invent one."""
    model = tapi.get_model(tconfigs.get_reduced(NAME))
    with pytest.raises(TypeError, match="prefill"):
        model.init_decode_state(2, 16)
    with pytest.raises(TypeError, match="max_len"):
        model.init_decode_state(2, 16, device="cpu")


def test_full_whisper_builds_with_jax_parameter_count():
    """get_model(whisper-large-v3) at full width: the same parameters as
    JAX's (counted on the meta device, nothing allocated)."""
    cfg = tconfigs.get_config(NAME)
    model = tapi.get_model(cfg)
    assert model.cfg is cfg
    lm = tencdec.EncDecLM(cfg, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    assert n == japi.param_count(jconfigs.get_config(NAME))
    assert 1.5e9 < n < 1.7e9
    assert len(lm.enc_layers) == len(lm.dec_layers) == 32
    assert tuple(lm.enc_pos.shape) == (1500, 1280)


# ----------------------------------------------------------------------------
# the trainer (comm="single") and checkpoints across the packages
# ----------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=0, total_steps=50)
TB, TS = 4, 12


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer on the reduced fp32 encdec: its initial weights, 4
    losses, a checkpoint written at step 3."""
    out = tmp_path_factory.mktemp("encdec_trainer")
    cfg = jconfigs.get_reduced(NAME)
    tr = jtrainer.Trainer(cfg, jtrainer.TrainerConfig(
        ckpt_dir=str(out / "jax"), ckpt_every=3, batch=TB, seq_len=TS,
        opt=JAdamW(**OPT), comm="single"))
    init = jax.tree.map(np.asarray, tr.params)
    losses = [m["loss"] for m in tr.train(4)]
    tr.store.wait()
    return {"dir": out, "init": init, "losses": losses}


def port_trainer(run, tag, **kw):
    cfg = tconfigs.get_reduced(NAME)
    tc = TrainerConfig(ckpt_dir=str(run["dir"] / tag),
                       **{"ckpt_every": 0, "batch": TB, "seq_len": TS,
                          "opt": AdamWConfig(**OPT), "comm": "single", **kw})
    init = weights.from_jax_params(cfg, run["init"], device="cpu")
    return Trainer(cfg, tc, device="cpu", init_params=init)


def test_trainer_losses_match_jax(jax_run):
    tr = port_trainer(jax_run, "port")
    got = [m["loss"] for m in tr.train(3)]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, jax_run["losses"][:3], rtol=1e-5)


def test_jax_checkpoint_restores_into_the_port(jax_run):
    tr = port_trainer(jax_run, "from_jax")
    tr.store.directory = str(jax_run["dir"] / "jax")
    tr.resume()
    assert tr.data.step == 3 and int(tr.opt_state["step"]) == 3
    np.testing.assert_allclose(tr.train(1)[0]["loss"], jax_run["losses"][3],
                               rtol=1e-5)


def test_port_checkpoint_restores_into_jax(jax_run):
    tr = port_trainer(jax_run, "to_jax", ckpt_every=3)
    port_losses = [m["loss"] for m in tr.train(4)]
    ckpt = str(jax_run["dir"] / "to_jax")
    assert os.path.isdir(os.path.join(ckpt, "step_00000003"))
    jt = jtrainer.Trainer(jconfigs.get_reduced(NAME), jtrainer.TrainerConfig(
        ckpt_dir=ckpt, ckpt_every=0, batch=TB, seq_len=TS,
        opt=JAdamW(**OPT), comm="single"))
    jt.resume()
    assert jt.data.step == 3
    np.testing.assert_allclose(jt.train(1)[0]["loss"], port_losses[3],
                               rtol=1e-5)
