"""Models of the PyTorch port vs the JAX package, from the same weights.

The JAX parameter pytree goes across as numpy arrays
(``repro_torch.weights.from_jax_params``); both packages then run
``prefill`` (and ``train_loss``) on the same tokens.  Tolerances: fp32
3e-4, and 6e-2 where bf16 rounds inside the computation (bf16 weights, or
``attn_dtype="bf16"``), the bars of ``tests/test_kernels.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.weights import from_jax_params, to_torch  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=3e-4, atol=3e-4)
BF16 = dict(rtol=6e-2, atol=6e-2)


def both(name, **over):
    jover = dict(over)
    tover = dict(over)
    if over.get("dtype") == "bf16":
        jover["dtype"], tover["dtype"] = jnp.bfloat16, torch.bfloat16
    jcfg = jconfigs.get_config(name).reduced(**jover)
    tcfg = tconfigs.get_config(name).reduced(**tover)
    jp = jtf.init_lm(jcfg, jax.random.key(0))
    tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_from_jax_params_round_trip(dtype):
    over = {"dtype": dtype} if dtype else {}
    jcfg, jp, tcfg, tp = both("qwen2-0.5b", **over)
    flat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    state = tp.state_dict()
    n = 0
    for path, leaf in flat.items():
        keys = [k.key for k in path]
        a = np.asarray(leaf)
        if keys[0] == "layers":
            for i in range(tcfg.n_layers):
                t = state[".".join(["layers", str(i)] + keys[1:])]
                assert t.dtype == to_torch(a).dtype
                assert torch.equal(t, to_torch(a[i]))
                n += 1
        else:
            t = state[".".join(keys)]
            assert torch.equal(t, to_torch(a))
            n += 1
    assert n == len(state)


def test_to_torch_keeps_bf16_bits():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.1415926, 1e-3], jnp.bfloat16))
    t = to_torch(a)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                          a.view(np.uint16))


CASES = [  # name, overrides, tolerance, moe_dropless
    ("qwen2-0.5b", {}, F32, False),                # GQA, bias, tied
    ("deepseek-7b", {}, BF16, False),              # attn_dtype="bf16"
    ("olmoe-1b-7b", {}, F32, True),                # MoE, dropless
    ("olmoe-1b-7b", {}, F32, False),               # MoE, capacity drops
    ("smollm-135m", {}, F32, False),               # group 3 (9H / 3KV)
    ("starcoder2-3b", {}, F32, False),             # LayerNorm + gelu
    ("qwen2-0.5b", {"dtype": "bf16"}, BF16, False),
]


@pytest.mark.parametrize("name,over,tol,dropless", CASES)
def test_prefill_matches_jax(name, over, tol, dropless):
    jcfg, jp, tcfg, tp = both(name, **over)
    if name == "deepseek-7b":
        assert tcfg.attn_dtype == "bf16"
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, size=(2, 24)).astype(np.int32)
    jl, jc, jh = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)},
                             max_len=32, remat=False, return_hidden=True,
                             moe_dropless=dropless)
    tl, tc, th = ttf.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        tokens).long()}, max_len=32, return_hidden=True,
        moe_dropless=dropless)
    assert tuple(tl.shape) == jl.shape and tl.dtype == torch.float32
    assert tuple(tc["k"].shape) == jc["k"].shape
    assert_close(tl, jl, tol)
    assert_close(th, jh, tol)
    assert_close(tc["k"], jc["k"], tol)
    assert_close(tc["v"], jc["v"], tol)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_train_loss_matches_jax(name):
    jcfg, jp, tcfg, tp = both(name)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, size=(2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    jl = jtf.train_loss(jcfg, jp, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(labels)},
                        remat=False)
    tl = tapi.get_model(tcfg).train_loss(
        tp, {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(tl), float(jl), **F32)


def test_vlm_prefix_embeddings_extend_the_cache():
    jcfg, jp, tcfg, tp = both("internvl2-76b")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab, size=(1, 8)).astype(np.int32)
    pre = rng.normal(size=(1, jcfg.n_patches, jcfg.d_model)) \
        .astype(np.float32)
    jl, jc = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens),
                                    "prefix_embeds": jnp.asarray(pre)},
                         remat=False)
    tl, tc = ttf.prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens).long(),
                                    "prefix_embeds": torch.from_numpy(pre)})
    assert tc["k"].shape[2] == 8 + jcfg.n_patches
    assert_close(tl, jl, F32)


def test_init_lm_is_seeded_and_scaled():
    cfg = tconfigs.get_config("qwen2-0.5b").reduced()
    m1 = tapi.get_model(cfg).init(torch.Generator().manual_seed(5))
    m2 = tapi.get_model(cfg).init(torch.Generator().manual_seed(5))
    for (n, a), (_, b) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), n
    wq = m1.layers[0].attn["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.2 * \
        cfg.d_model ** -0.5
    assert abs(float(m1.embed["tok"].std()) - 0.02) < 0.004


DECODE_CASES = [  # name, overrides, tolerance
    ("qwen2-0.5b", {}, F32),             # GQA group 2, bias, tied
    ("deepseek-7b", {}, F32),            # attn_dtype="bf16" branch
    ("olmoe-1b-7b", {}, F32),            # MoE (capacity dispatch)
    ("qwen2-0.5b", {"dtype": "bf16"}, BF16),
]


@pytest.mark.parametrize("name,over,tol", DECODE_CASES)
def test_dense_cache_decode_matches_jax(name, over, tol):
    """Prefill into a dense cache, then greedy decode_step against it: the
    same tokens as JAX, logits and cache within the bar."""
    jcfg, jp, tcfg, tp = both(name, **over)
    rng = np.random.default_rng(4)
    S, steps, max_len = 12, 5, 20
    tokens = rng.integers(0, jcfg.vocab, size=(2, S)).astype(np.int32)
    jl, jc = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)},
                         max_len=max_len, remat=False)
    model = tapi.get_model(tcfg)
    tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(tokens).long()},
                           max_len=max_len)
    decode = jax.jit(functools.partial(jtf.decode_step, jcfg))
    for step in range(steps):
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tt = tl[:, -1].argmax(-1)[:, None]
        assert np.array_equal(np.asarray(jt), tt.numpy()), step
        jl, jc = decode(jp, jt, jc, S + step)
        tl, tc = model.decode_step(tp, tt, tc, S + step)
        assert_close(tl, jl, tol)
    assert_close(tc["k"], jc["k"], tol)
    assert_close(tc["v"], jc["v"], tol)


def test_dense_cache_decode_writes_in_place_and_inits_zeros():
    jcfg, jp, tcfg, tp = both("qwen2-0.5b")
    model = tapi.get_model(tcfg)
    cache = model.init_decode_state(2, 8, device="cpu")
    want = jax.eval_shape(lambda: jattn.init_kv_cache(
        jcfg, 2, 8, layers=jcfg.n_layers))
    assert tuple(cache["k"].shape) == want["k"].shape
    assert cache["k"].device.type == "cpu" and not cache["k"].any()
    tok = torch.ones((2, 1), dtype=torch.long)
    _, out = model.decode_step(tp, tok, cache, 3)
    assert out["k"] is cache["k"]
    assert cache["k"][:, :, 3].any() and not cache["k"][:, :, 4:].any()
    assert not cache["k"][:, :, :3].any()
