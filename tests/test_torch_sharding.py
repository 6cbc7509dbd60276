"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
JAX package's, spec for spec.

Every config of ``configs/`` at full size, on the 16x16 and 2x16x16
production meshes and the (8, 1), (4, 2), (2, 4) test meshes (abstract:
no ranks): ``param_specs``, ``zero1_specs``, ``batch_specs`` of every
applicable train / prefill shape and ``decode_state_specs`` of every
decode shape equal JAX's, after padding each spec to its leaf's rank (a
one-axis tuple entry reads as the axis).  The inputs are JAX's own shape
trees (``api.param_shapes``, ``api.input_specs``) as meta tensors, so the
two rule sets see the same shapes; ``param_shapes`` of the port is held to
JAX's key for key.  The cases of ``tests/test_sharding.py`` are mirrored.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.sharding import P  # noqa: E402

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def norm(spec, ndim: int) -> tuple:
    """A spec's entries, one a dimension; a one-axis tuple as the axis."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


def jflat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in leaves}


def to_meta(tree):
    """A JAX shape tree as nested dicts of meta tensors."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), device="meta")


@functools.lru_cache(maxsize=None)
def jax_shapes(name):
    return japi.param_shapes(jconfigs.get_config(name))


@functools.lru_cache(maxsize=None)
def port_shapes(name):
    return api.param_shapes(configs.get_config(name))


def same_specs(port_tree, jax_tree, shapes):
    got, want = sh.flatten(port_tree), jflat(jax_tree)
    assert list(got) == list(want)
    for k, s in sh.flatten(shapes).items():
        nd = len(s.shape)
        assert norm(got[k], nd) == norm(want[k], nd), (k, got[k], want[k])


@pytest.mark.parametrize("name", configs.ALL_ARCHS)
def test_param_shapes_equal_jax(name):
    got = {k: tuple(t.shape) for k, t in sh.flatten(port_shapes(name))
           .items()}
    want = {k: tuple(v.shape) for k, v in jflat(jax_shapes(name)).items()}
    assert got == want
    assert all(t.device.type == "meta"
               for t in sh.flatten(port_shapes(name)).values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", configs.ALL_ARCHS)
def test_specs_equal_jax(name, mesh):
    shape, axes = MESHES[mesh]
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    m, jm = sh.abstract_mesh(shape, axes), jsh.abstract_mesh(shape, axes)
    shapes = port_shapes(name)
    same_specs(sh.param_specs(cfg, shapes, m),
               jsh.param_specs(jcfg, jax_shapes(name), jm), shapes)
    same_specs(sh.zero1_specs(cfg, shapes, m),
               jsh.zero1_specs(jcfg, jax_shapes(name), jm), shapes)
    for cell in japi.applicable_shapes(jcfg):
        sc, spec = japi.input_specs(jcfg, cell)
        if sc.kind in ("train", "prefill"):
            same_specs(sh.batch_specs(cfg, to_meta(spec), m),
                       jsh.batch_specs(jcfg, spec, jm), to_meta(spec))
        else:
            state = spec["state"]
            same_specs(sh.decode_state_specs(cfg, to_meta(state), m,
                                             sc.global_batch),
                       jsh.decode_state_specs(jcfg, state, jm,
                                              sc.global_batch),
                       to_meta(state))


def test_specs_take_a_mesh_with_only_shape_and_axis_names():
    class Bare:
        shape = {"data": 4, "model": 2}
        axis_names = ("data", "model")
    cfg = configs.get_config("deepseek-7b")
    assert sh.param_specs(cfg, port_shapes("deepseek-7b"), Bare()) == \
        sh.param_specs(cfg, port_shapes("deepseek-7b"),
                       sh.abstract_mesh((4, 2), ("data", "model")))


# ----------------------------------------------------------------------------
# mirrors of tests/test_sharding.py
# ----------------------------------------------------------------------------

def mesh_pod():
    return sh.abstract_mesh((16, 16), ("data", "model"))


def mesh_multipod():
    return sh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))


def _cfg(name, **over):
    c = configs.get_config(name)
    return dataclasses.replace(c, **over) if over else c


def meta(*shape):
    return torch.empty(shape, device="meta")


def test_dp_prefix_divides():
    m = mesh_pod()
    cfg = _cfg("smollm-135m")  # dp_only in production
    assert cfg.parallelism == "dp_only"
    axes, n = sh._dp_prefix(m, cfg, 256)
    assert axes == ("data", "model") and n == 256
    axes, n = sh._dp_prefix(m, cfg, 32)
    assert axes == ("data",) and n == 16
    axes, n = sh._dp_prefix(m, cfg, 1)
    assert axes == () and n == 1


def test_batch_specs_never_replicate_when_seq_can_shard():
    m = mesh_pod()
    cfg = _cfg("qwen2-0.5b")
    spec = sh.batch_specs(cfg, {"tokens": meta(32, 32768)}, m)["tokens"]
    assert spec == P(("data",), "model")


def test_batch_specs_tp_dp_unchanged():
    m = mesh_pod()
    cfg = _cfg("deepseek-7b")
    assert sh.batch_specs(cfg, {"tokens": meta(256, 4096)}, m)["tokens"] \
        == P(("data",), None)


def test_param_specs_dp_only_replicates():
    m = mesh_pod()
    cfg = _cfg("smollm-135m")
    specs = sh.param_specs(cfg, port_shapes("smollm-135m"), m)
    assert all(all(ax is None for ax in s)
               for s in sh.flatten(specs).values())


def test_zero1_dp_only_shards_moments_over_grid():
    m = mesh_pod()
    cfg = _cfg("smollm-135m")
    specs = sh.zero1_specs(cfg, port_shapes("smollm-135m"), m)
    assert any(("data", "model") in s for s in sh.flatten(specs).values())


def test_moe_expert_sharding():
    m = mesh_pod()
    cfg = _cfg("olmoe-1b-7b")
    specs = sh.param_specs(cfg, port_shapes("olmoe-1b-7b"), m)
    assert specs["layers"]["moe"]["w_gate"] == P(None, "model", None, None)


def test_decode_state_long500k_seq_over_data():
    m = mesh_pod()
    jcfg = jconfigs.get_config("rwkv6-1.6b")
    _, spec = japi.input_specs(jcfg, "long_500k")
    st = sh.decode_state_specs(_cfg("rwkv6-1.6b"), to_meta(spec["state"]),
                               m, 1)
    for s in sh.flatten(st).values():
        for ax in s:
            assert ax in (None, "data", "model") or isinstance(ax, tuple)


def test_decode_state_batch_prefix_multipod():
    m = mesh_multipod()
    cfg = _cfg("deepseek-7b")
    st = sh.decode_state_specs(cfg, {"k": meta(30, 128, 32768, 32, 128)},
                               m, 128)
    assert st["k"][1] == ("pod", "data")
    assert "model" in st["k"]


# ----------------------------------------------------------------------------
# the runtime registry, the constraint, the production mesh's twin
# ----------------------------------------------------------------------------

def test_runtime_mesh_registry_and_constraint_without_a_mesh():
    assert sh.runtime_mesh() is None
    x = torch.arange(24.).reshape(2, 4, 3)
    assert sh.constrain_activations(x, seq_axis="model") is x
    m = sh.abstract_mesh((2, 2), ("data", "model"))
    sh.set_runtime_mesh(m)
    try:
        assert sh.runtime_mesh() is m
        assert sh.constrain_activations(x) is x     # Megatron: replicated
    finally:
        sh.set_runtime_mesh(None)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_torus_is_jaxs(multi_pod):
    got = tmesh.production_torus(multi_pod=multi_pod)
    want = jmesh.production_torus(multi_pod=multi_pod)
    assert got.dims == want.dims
    # rank i of the torus is device i of the mesh, both row-major
    for r in (0, 1, 17, got.size - 1):
        assert got.coords(r) == want.coords(r)
