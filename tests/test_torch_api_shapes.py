"""The port's shape specs and parameter counts (``repro_torch.models.api``)
against the JAX package's (``repro.models.api``).

``SHAPES``, ``applicable_shapes``, ``param_count`` and
``active_param_count`` equal JAX's exactly for all ten configs; the
meta-tensor ``input_specs`` have the shapes of JAX's ShapeDtypeStructs at
the smoke shapes of every ``.reduced()`` config and at ``train_4k`` and
``decode_32k`` of two full configs.  One layout differs by design: the
port keeps whisper's cross-attention K/V as (L, B, Hkv, F, hd), the
kernel's layout, where JAX has (L, B, F, Hkv, hd); the comparison swaps
those two dims.  Token ids are int64 in the port (PyTorch's index type),
int32 in JAX.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import api  # noqa: E402

ARCHS = list(configs.ALL_ARCHS)


def _shapes(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_shapes(tree[k], path + (k,)))
        return out
    return {"/".join(path): tuple(tree.shape)}


def _port_shapes(cfg, tree) -> dict:
    out = _shapes(tree)
    if cfg.family == "encdec":       # (L, B, Hkv, F, hd) -> JAX's layout
        for k in ("state/cross_k", "state/cross_v"):
            if k in out:
                L, B, H, F, hd = out[k]
                out[k] = (L, B, F, H, hd)
    return out


def test_shapes_equal_jax():
    assert {k: dataclasses.astuple(v) for k, v in api.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in japi.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_shapes_and_counts_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert api.applicable_shapes(cfg) == japi.applicable_shapes(jcfg)
    assert api.param_count(cfg) == japi.param_count(jcfg)
    assert api.active_param_count(cfg) == japi.active_param_count(jcfg)


def test_active_count_takes_top_k_of_the_experts():
    cfg = configs.get_config("olmoe-1b-7b")
    m = cfg.moe
    dense = api.param_count(cfg) - cfg.n_layers * 3 * m.n_experts \
        * cfg.d_model * m.d_expert
    assert api.active_param_count(cfg) == dense + cfg.n_layers * 3 \
        * m.top_k * cfg.d_model * m.d_expert
    dense_cfg = configs.get_config("qwen2-0.5b")
    assert api.active_param_count(dense_cfg) == api.param_count(dense_cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_input_specs_equal_jax(arch):
    cfg = configs.get_config(arch).reduced()
    jcfg = jconfigs.get_config(arch).reduced()
    for name in ("smoke_train", "smoke_prefill", "smoke_decode"):
        shape, spec = api.input_specs(cfg, name)
        jshape, jspec = japi.input_specs(jcfg, name)
        assert shape == api.SHAPES[name]
        assert _port_shapes(cfg, spec) == _shapes(jspec), name
        assert all(t.device.type == "meta" for t in _leaves(spec))
        tok = spec["token"] if shape.kind == "decode" else spec["tokens"]
        assert tok.dtype == api.TOKEN_DTYPE


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b"])
@pytest.mark.parametrize("name", ["train_4k", "decode_32k"])
def test_full_input_specs_equal_jax(arch, name):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    _, spec = api.input_specs(cfg, name)
    _, jspec = japi.input_specs(jcfg, name)
    assert _port_shapes(cfg, spec) == _shapes(jspec)
    # meta tensors hold no memory, however large the cell
    assert all(t.device.type == "meta" for t in _leaves(spec))
