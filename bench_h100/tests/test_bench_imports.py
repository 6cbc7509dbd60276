"""What the harness and the reference load: never JAX or the JAX package
(compared by whole top-level names: ``repro_torch`` is not ``repro``),
and the reference nothing of the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = {"repro_torch"}


def _sources(*parts):
    for part in parts:
        p = HERE / part
        yield from ([p] if p.is_file() else sorted(p.rglob("*.py")))


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", list(_sources("run.py", "control.py",
                                               "benchkit", "metrics",
                                               "layouts", "reference")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_in_sources(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", list(_sources("reference")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert not names & PROGRAM
    text = path.read_text()
    assert "benchkit.port" not in text and "import port" not in text


def _modules_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_program():
    """The reference and every layout, whose program functions import the
    program only when called."""
    layouts = sorted(p.stem for p in (HERE / "layouts").glob("*.py"))
    mods = _modules_after(
        f"import sys; sys.path[:0] = [{str(HERE)!r}]\n"
        "from reference import ops, serve, train\n"
        "from benchkit import manifest\n"
        f"for name in {layouts!r}:\n"
        "    manifest.layout(name)")
    assert not mods & (FORBIDDEN | PROGRAM)


def test_a_run_loads_no_jax():
    """A whole small run on the CPU, the program included."""
    code = (f"import sys; sys.path[:0] = [{str(HERE / 'tests')!r}, "
            f"{str(HERE)!r}, {str(ROOT / 'src')!r}]\n"
            "from conftest import small, SEED\n"
            "from benchkit.cell import run_cell\n"
            "for c in ('deepseek7b-decode-chat', 'olmoe-train-4k'):\n"
            "    run_cell(c, SEED, 0.5, False, device='cpu', cell=small(c))")
    mods = _modules_after(code)
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN


def test_no_card_no_result():
    """Without enough CUDA devices a run exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "deepseek7b-decode-chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
