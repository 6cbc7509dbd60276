"""Recurrent serving of the PyTorch port vs the JAX package.

For reduced rwkv6, zamba2 and a pure-mamba2 config (zamba2's with
``family="mamba2"``), the JAX parameters go across as numpy arrays
(``repro_torch.weights.from_jax_params``), and both packages run the uniform
model API: ``prefill`` (logits and every leaf of the decode state), eight
greedy ``decode_step``s (the same tokens, logits within the bar), and
``train_loss``.  Tolerances: fp32 3e-4, and 6e-2 for bf16 weights, the bars
of ``tests/test_kernels.py``.  On the CPU the scans run their chunked plain
versions in both packages (JAX's ``impl="auto"`` off the TPU).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models.common import SsmCfg as TSsm  # noqa: E402
from repro_torch.weights import from_jax_params, to_torch  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=3e-4, atol=3e-4)
BF16 = dict(rtol=6e-2, atol=6e-2)

# name, family override (None: the config's own)
CASES = [("rwkv6-1.6b", None), ("zamba2-1.2b", None),
         ("zamba2-1.2b", "mamba2")]
IDS = ["rwkv6", "zamba2", "mamba2"]
PROMPT, MAX_LEN, STEPS = 21, 32, 8


def cfgs(name, family=None, **over):
    jover, tover = dict(over), dict(over)
    if over.get("dtype") == "bf16":
        jover["dtype"], tover["dtype"] = jnp.bfloat16, torch.bfloat16
    if "ssm" in over:
        from repro.models.common import SsmCfg as JSsm
        jover["ssm"] = JSsm(**over["ssm"])
        tover["ssm"] = TSsm(**over["ssm"])
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    if family:
        jcfg = dataclasses.replace(jcfg, family=family)
        tcfg = dataclasses.replace(tcfg, family=family)
    return jcfg.reduced(**jover), tcfg.reduced(**tover)


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg):
    return japi.get_model(jcfg).init(jax.random.key(0))


def both(name, family=None, **over):
    """(jcfg, JAX model, JAX params, tcfg, port model, port params)."""
    jcfg, tcfg = cfgs(name, family, **over)
    jp = _jax_params(jcfg)
    tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, japi.get_model(jcfg), jp, tcfg, tapi.get_model(tcfg), tp


def prefill_kw(cfg, prompt_len):
    """zamba2 pads its shared-block caches for the decode steps to come."""
    if cfg.family != "zamba2":
        return {}
    return {"max_len": max(MAX_LEN, prompt_len + STEPS)}


def tokens(cfg, seed, B=2, S=PROMPT):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def leaves(state):
    """{path: leaf} of a nested dict state (JAX arrays or torch tensors)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update({(k,) + p: x for p, x in leaves(v).items()})
        else:
            out[(k,)] = v
    return out


def assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def run_prefill(jcfg, jm, jp, tcfg, tm, tp, toks):
    kw = prefill_kw(jcfg, toks.shape[1])
    jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, remat=False, **kw)
    tl, ts = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, **kw)
    return (jl, js), (tl, ts)


@pytest.mark.parametrize("name,family", CASES, ids=IDS)
def test_from_jax_params_round_trip(name, family):
    jcfg, _, jp, tcfg, _, tp = both(name, family)
    stacked = "mamba" if tcfg.family == "zamba2" else "layers"
    state = tp.state_dict()
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [k.key for k in path]
        a = np.asarray(leaf)
        if keys[0] == stacked:
            for i in range(tcfg.n_layers):
                t = state[".".join([stacked, str(i)] + keys[1:])]
                assert torch.equal(t, to_torch(a[i]))
                n += 1
        else:
            assert torch.equal(state[".".join(keys)], to_torch(a))
            n += 1
    assert n == len(state)


@pytest.mark.parametrize("name,family", CASES, ids=IDS)
def test_prefill_matches_jax(name, family):
    setup = both(name, family)
    (jl, js), (tl, ts) = run_prefill(*setup, tokens(setup[0], 1))
    assert tuple(tl.shape) == jl.shape and tl.dtype == torch.float32
    assert_close(tl, jl, F32)
    jleaves, tleaves = leaves(js), leaves(ts)
    assert set(jleaves) == set(tleaves)
    for path, want in jleaves.items():
        got = tleaves[path]
        assert tuple(got.shape) == want.shape, path
        assert_close(got, want, F32)


@pytest.mark.parametrize("name,family", CASES, ids=IDS)
def test_prefill_matches_jax_bf16(name, family):
    """bf16 weights: logits and the bf16 state leaves at the bf16 bar.  The
    fp32 scan states sum S products of bf16-rounded inputs, so one rounding
    flip moves them in proportion to their own scale: their absolute bar is
    1e-2 of the leaf's largest magnitude (a flip is 2^-8 relative)."""
    setup = both(name, family, dtype="bf16")
    (jl, js), (tl, ts) = run_prefill(*setup, tokens(setup[0], 2))
    assert_close(tl, jl, BF16)
    jleaves, tleaves = leaves(js), leaves(ts)
    for path, want in jleaves.items():
        got = tleaves[path]
        assert got.dtype == to_torch(np.asarray(want)).dtype, path
        tol = BF16 if got.dtype == torch.bfloat16 else dict(
            rtol=6e-2, atol=1e-2 * float(np.abs(np.asarray(want)).max()))
        assert_close(got, want, tol)


@pytest.mark.parametrize("name,family", CASES, ids=IDS)
def test_one_token_prompt_matches_jax(name, family):
    setup = both(name, family)
    (jl, js), (tl, ts) = run_prefill(*setup, tokens(setup[0], 3, S=1))
    assert_close(tl, jl, F32)
    for path, want in leaves(js).items():
        assert_close(leaves(ts)[path], want, F32)


@pytest.mark.parametrize("name,family", CASES, ids=IDS)
def test_greedy_decode_matches_jax(name, family):
    jcfg, jm, jp, tcfg, tm, tp = both(name, family)
    (jl, js), (tl, ts) = run_prefill(jcfg, jm, jp, tcfg, tm, tp,
                                     tokens(jcfg, 4))
    decode = jax.jit(jm.decode_step)
    jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = tl[:, -1].argmax(-1)[:, None]
    for step in range(STEPS):
        assert np.array_equal(np.asarray(jt), tt.numpy()), step
        pos = PROMPT + step
        jl, js = decode(jp, jt, js, pos)
        tl, ts = tm.decode_step(tp, tt, ts, pos)
        assert tuple(tl.shape) == jl.shape
        assert_close(tl, jl, F32)
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tt = tl[:, -1].argmax(-1)[:, None]
    for path, want in leaves(js).items():
        assert_close(leaves(ts)[path], want, F32)


@pytest.mark.parametrize("name,family", CASES, ids=IDS)
def test_decode_from_zero_state_matches_jax(name, family):
    """``init_decode_state`` gives JAX's shapes and dtypes, and one step
    from it matches."""
    jcfg, jm, jp, tcfg, tm, tp = both(name, family)
    js = jm.init_decode_state(2, MAX_LEN)
    ts = tm.init_decode_state(2, MAX_LEN, device="cpu")
    for path, want in leaves(js).items():
        got = leaves(ts)[path]
        assert tuple(got.shape) == want.shape, path
        assert got.dtype == to_torch(np.asarray(want)).dtype, path
        assert got.device.type == "cpu" and not got.any()
    tok = tokens(jcfg, 5, S=1)
    jl, _ = jm.decode_step(jp, jnp.asarray(tok), js, 0)
    tl, _ = tm.decode_step(tp, torch.from_numpy(tok).long(), ts, 0)
    assert_close(tl, jl, F32)


@pytest.mark.parametrize("name,family", CASES, ids=IDS)
def test_train_loss_matches_jax(name, family):
    jcfg, jm, jp, tcfg, tm, tp = both(name, family)
    toks = tokens(jcfg, 6, S=16)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jl = jm.train_loss(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)}, remat=False)
    tl = tm.train_loss(tp, {"tokens": torch.from_numpy(toks).long(),
                            "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(tl), float(jl), **F32)


# the reduced configs that chip_smoke.py serves on the card, shaped so the
# kernels take them (head_dim 64; ssm head_dim 64 and d_state 64)
@pytest.mark.parametrize("name,over", [
    ("rwkv6-1.6b", dict(head_dim=64)),
    ("zamba2-1.2b", dict(head_dim=64, ssm=dict(d_state=64, head_dim=64)))],
    ids=["rwkv6", "zamba2"])
def test_kernel_shaped_reduced_config_matches_jax(name, over):
    setup = both(name, **over)
    (jl, js), (tl, ts) = run_prefill(*setup, tokens(setup[0], 7, S=70))
    assert_close(tl, jl, F32)
    for path, want in leaves(js).items():
        assert_close(leaves(ts)[path], want, F32)


def test_hybrid_decode_writes_the_shared_caches_in_place():
    jcfg, jm, jp, tcfg, tm, tp = both("zamba2-1.2b")
    _, (tl, ts) = run_prefill(jcfg, jm, jp, tcfg, tm, tp, tokens(jcfg, 8))
    k = ts["kv"]["k"]
    assert not k[:, :, PROMPT].any()
    _, ts2 = tm.decode_step(tp, tl[:, -1].argmax(-1)[:, None], ts, PROMPT)
    assert ts2["kv"]["k"] is k and k[:, :, PROMPT].any()
    assert not k[:, :, PROMPT + 1:].any()


@pytest.mark.parametrize("family", ["mamba2", "rwkv6", "zamba2"])
def test_get_model_serves_the_recurrent_families(family):
    name = "rwkv6-1.6b" if family == "rwkv6" else "zamba2-1.2b"
    cfg = dataclasses.replace(tconfigs.get_config(name), family=family)
    m = tapi.get_model(cfg.reduced())
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 5), dtype=torch.long)
    logits, state = m.prefill(params, {"tokens": toks},
                              **prefill_kw(cfg, 5))
    assert tuple(logits.shape) == (1, 1, cfg.reduced().vocab)
    logits, _ = m.decode_step(params, toks[:, :1], state, 5)
    assert torch.isfinite(logits).all()
