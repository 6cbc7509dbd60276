"""The PyTorch port stands alone: no JAX and nothing of ``repro``.

Importing every module of ``repro_torch`` in a fresh interpreter must load
no ``jax*`` and no ``repro.*`` module; no source line of the package or of
``chip_smoke.py`` may import either; and the entry points run on the card
unless the caller asks for the CPU.
"""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s,]|$)")


def port_modules() -> list[str]:
    return ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="repro_torch.")]


def test_port_modules_load_no_jax_and_no_repro():
    mods = port_modules()
    assert "repro_torch.serving.engine" in mods
    assert "repro_torch.kernels.paged_attention" in mods
    for m in ("kernels.mamba2_scan", "kernels.rwkv6_scan", "kernels.ops",
              "kernels.ref", "kernels._build", "models.rwkv",
              "models.ssm", "models.hybrid", "models.encdec", "core.rdma",
              "core.fabric.sim", "core.fabric.fluid",
              "core.fabric.telemetry", "core.fabric.qosctl",
              "core.fabric.autotune", "serving.cluster", "serving.trace",
              "core.lofamo", "core.collectives", "core.fabric.execute",
              "data.pipeline", "checkpoint.store", "optim.adamw",
              "launch.mesh", "launch.train", "runtime.trainer",
              "parallel.sharding", "parallel.spmd", "models.moe",
              "models.transformer", "models.api", "kernels.cost",
              "launch.dryrun", "launch.op_analysis"):
        assert f"repro_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


EXAMPLES = ["ep_moe_demo_torch.py", "quickstart_torch.py",
            "paged_serving_torch.py", "cluster_serving_torch.py",
            "torus_demo_torch.py", "fault_tolerant_train_torch.py"]


def test_no_source_line_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "examples" / e for e in EXAMPLES]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if IMPORT_RE.match(line)]
    assert not bad, bad


def test_every_kernel_source_is_built_and_bound():
    """Each ``kernels/csrc/*.cu`` (the backward kernels K2-bwd, K3-bwd and
    K4-bwd among them) is in ``_build.KERNELS``, built by ``build_all``,
    and has a C signature to bind."""
    from repro_torch.kernels import _build
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert {"mamba2_scan_bwd", "rwkv6_scan_bwd",
            "flash_attention_bwd"} <= sources
    assert sources == set(_build.KERNELS) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_load_no_jax_and_no_repro(name):
    """Each example, imported in a fresh interpreter (its ``main`` not
    run), loads no ``jax*`` and no ``repro.*`` module."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('ex', "
            f"{str(ROOT / 'examples' / name)!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("name", ["quickstart_torch.py",
                                  "paged_serving_torch.py",
                                  "cluster_serving_torch.py"])
def test_single_device_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is then valid")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name[:-3], ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError):
        mod.main([])


def test_import_pattern_catches_what_it_must():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.core import fabric", "import repro.models",
                 "    import jax"):
        assert IMPORT_RE.match(line), line
    for line in ("import repro_torch", "from repro_torch.core import tlb",
                 "import jaxtyping", "from reprox import y"):
        assert not IMPORT_RE.match(line), line


def test_paged_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is then valid")
    from repro_torch import configs
    from repro_torch.serving.engine import PagedLM
    cfg = configs.get_config("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedLM(cfg, None, max_batch=2, max_seq=32, modelled=True)
    lm = PagedLM(cfg, None, max_batch=2, max_seq=32, modelled=True,
                 device="cpu")
    assert lm.device.type == "cpu"


def test_paged_lm_shared_sim_is_not_ported():
    """The shared fabric simulator is ported now (it raised before): a
    ``PagedLM`` takes any tier of the port's own ``make_sim`` and hands
    it to its RDMA endpoint, as the JAX engine does."""
    from repro_torch import configs
    from repro_torch.core import fabric
    from repro_torch.core.topology import Torus
    from repro_torch.serving.engine import PagedLM
    cfg = configs.get_config("qwen2-0.5b")
    for fidelity in fabric.FIDELITIES:
        sim = fabric.make_sim(Torus((4, 4)), fidelity=fidelity)
        lm = PagedLM(cfg, None, max_batch=2, max_seq=32, modelled=True,
                     sim=sim, device="cpu")
        assert lm.sim is sim and lm.endpoint.sim is sim


def test_cluster_and_torch_solver_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is then valid")
    from repro_torch import configs
    from repro_torch.core.fabric import make_sim
    from repro_torch.core.topology import Torus
    from repro_torch.serving.cluster import ServingCluster
    cfg = configs.get_config("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingCluster(cfg, None, torus=Torus((2,)), modelled=True,
                       n_params=1)
    cl = ServingCluster(cfg, None, torus=Torus((2,)), modelled=True,
                        n_params=1, device="cpu")
    assert {n.lm.device.type for n in cl.nodes.values()} == {"cpu"}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_sim(Torus((2,)), fidelity="fluid", solver="torch")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the kernels cannot build, and the build says so."""
    from torch.utils import cpp_extension

    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    # a failed build leaves nothing behind in the build directory
    build = tmp_path / "build"
    assert not build.exists() or not any(build.iterdir())
    # libraries are keyed by their source: one name per kernel and source
    names = {_build.library_path(k).name for k in _build.KERNELS}
    assert len(names) == len(_build.KERNELS)
    assert all(n.endswith(".so") for n in names)


def test_serve_launcher_runs_on_cpu(capsys, monkeypatch):
    from repro_torch.core.fabric import Telemetry, telemetry
    from repro_torch.launch import serve
    # a fresh process hub: the summary is this run's alone
    monkeypatch.setattr(telemetry, "_PROCESS_HUB", Telemetry())
    rc = serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                     "--max-new", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "requests=3" in out
    # the process hub's span summary: count, total and self ms a name
    assert "== spans ==" in out
    rows = {ln.split()[0]: ln.split()[1:] for ln in out.splitlines()
            if ln.strip().startswith(("engine.", "decode"))}
    assert {"engine.step", "engine.queued", "engine.prefill", "decode",
            "decode.layers", "decode.wait"} <= set(rows)
    assert rows["engine.queued"][0] == "3"
    assert all(float(r[2]) <= float(r[1]) + 1e-3 for r in rows.values())


def test_trainer_and_weight_bridges_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is then valid")
    from repro_torch import configs, weights
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = configs.get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainerConfig(ckpt_dir="unused", comm="single"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        weights.from_jax_opt_state({"m": {}, "v": {}, "step": 0})
