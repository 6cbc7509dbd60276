"""The port's examples (``examples/*_torch.py``) run and print their claims.

Each runs as a subprocess on the CPU (``--device cpu`` where it takes
one; the two 8-rank examples start gloo CPU ranks themselves) with a
timeout, exits 0 and prints the claim lines of its JAX counterpart.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

# example -> (arguments, claim lines it must print)
EXAMPLES = {
    "quickstart_torch.py": (["--device", "cpu"], [
        "step 40: loss", "resumed at step 40", "generated tokens:",
        "quickstart OK"]),
    "paged_serving_torch.py": (["--device", "cpu"], [
        "finished 10/10 requests", "TLB hit rate:", "req 0:",
        "paged serving OK"]),
    "cluster_serving_torch.py": (["--device", "cpu"], [
        "migrated request", "rerouted over 3 hops", "rerouted=True",
        "finished 4/4 requests", "cluster serving OK"]),
    "torus_demo_torch.py": ([], [
        "moved every rank's row to its +X neighbour: True",
        "ring all-reduce == sum: True",
        "every rank holds the same fp32 bits: True",
        "APElink efficiency          0.784", "torus demo OK"]),
    "fault_tolerant_train_torch.py": ([], [
        "rerouted collectives around [(2, 3)]", "no restart",
        "elastic re-mesh: 8 -> 4", "restored step 5",
        "fault-tolerant training OK"]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_and_prints_its_claims(name):
    args, claims = EXAMPLES[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                        *args], capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for claim in claims:
        assert claim in r.stdout, (claim, r.stdout[-3000:])
