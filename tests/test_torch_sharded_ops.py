"""The port's per-rank attention wrappers (``ops.sharded_flash_attention``,
``ops.sharded_paged_attention``) against the JAX package's shard_map'd
ones, on the CPU.

One module fixture runs ``tests/torch_dist_checks.py``'s "sharded" mode
once: JAX's wrappers on 8 forced host devices in one subprocess, the
port's 8 gloo ranks in 8 more, from the same numpy inputs, on the (2, 4)
and (4, 2) ("data", "model") meshes and the (2, 2, 2) ("pod", "data",
"model") one with both DP axes.  Each rank passes its blocks under JAX's
specs and gets its block back; ``spmd.unshard`` of the blocks is held to
JAX's output at the fp32 bar 3e-4.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ops, ref  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_checks as tdc  # noqa: E402

OUTPUTS = ["flash/1", "flash/0", "paged"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    tdc.launch("sharded", out, timeout=600)
    with np.load(os.path.join(out, "jax_sharded.npz")) as z:
        jref = {k: z[k] for k in z.files}
    ranks, shapes = [], []
    for r in range(8):
        with np.load(os.path.join(out, f"rank{r}_sharded.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
        with open(os.path.join(out, f"rank{r}_sharded.json")) as f:
            shapes.append(json.load(f))
    return {"jax": jref, "ranks": ranks, "shapes": shapes}


@pytest.mark.parametrize("mesh", list(tdc.SHARDED_MESHES))
@pytest.mark.parametrize("what", OUTPUTS)
def test_sharded_attention_matches_jax_shard_map(run, mesh, what):
    key = f"{mesh}/{what}"
    for r in run["ranks"]:
        np.testing.assert_allclose(r[key], run["jax"][key], rtol=3e-4,
                                   atol=3e-4)


@pytest.mark.parametrize("mesh", list(tdc.SHARDED_MESHES))
def test_each_rank_computes_only_its_block(run, mesh):
    """Batch over the DP axes, query heads and KV heads over "model": a
    rank's blocks are the global shapes divided so, and so is its
    output."""
    shape, names = tdc.SHARDED_MESHES[mesh]
    tp = shape[names.index("model")]
    dp = int(np.prod(shape)) // tp
    for s in run["shapes"]:
        q, k, v, o = s[f"{mesh}/flash"]
        assert q == o == [4 // dp, 8 // tp, 24, 16]
        assert k == v == [4 // dp, 4 // tp, 24, 16]
        q, kp, vp, pt, sl, o = s[f"{mesh}/paged"]
        assert q == o == [4 // dp, 8 // tp, 16]
        assert kp == vp == [20, 8, 4 // tp, 16]
        assert pt == [4 // dp, 4] and sl == [4 // dp]


def test_sharded_wrappers_run_the_plain_version_on_cpu_blocks():
    """Off the card a block takes the plain version, as ``ops`` does; the
    wrapper adds nothing to the call and keeps JAX's specs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, h, 8, 16, generator=g) for h in (4, 2, 2))
    fn = ops.sharded_flash_attention(None, causal=False)
    assert fn.in_specs == ((("data",), "model", None, None),) * 3
    assert torch.equal(fn(q, k, v), ref.mha_attention(q, k, v, causal=False))
    kp, vp = (torch.randn(6, 4, 2, 16, generator=g) for _ in range(2))
    pt = torch.tensor([[0, 2], [5, 1]], dtype=torch.int32)
    sl = torch.tensor([3, 7], dtype=torch.int32)
    fn = ops.sharded_paged_attention(None, data_axes=("pod", "data"))
    assert fn.in_specs[1] == (None, None, "model", None)
    assert fn.out_spec == (("pod", "data"), "model", None)
    assert torch.equal(fn(q[:, :, 0], kp, vp, pt, sl),
                       ref.paged_attention(q[:, :, 0], kp, vp, pt, sl))
