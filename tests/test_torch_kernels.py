"""Attention of the PyTorch port vs the JAX package.

The port's plain versions (``repro_torch.kernels.ref``) are held against
``repro.kernels.ref`` and against the Pallas kernels in interpret mode, on
the same numpy inputs, at the bars of ``tests/test_kernels.py``: 3e-4 for
fp32, 6e-2 for bf16.  Rows that see no key return 0 in the port and in the
Pallas kernels but NaN in the JAX references, so the references are
compared only on rows that see at least one key.

The CUDA kernels themselves run only on the card: see
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from repro.kernels.paged_attention import \
    paged_attention as pallas_paged  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.weights import to_torch  # noqa: E402

torch.set_num_threads(1)

TOL = {"f32": dict(rtol=3e-4, atol=3e-4), "bf16": dict(rtol=6e-2, atol=6e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def pair(rng, shape, dt):
    """The same values as a JAX array and a torch tensor (bit-identical)."""
    j = jnp.asarray(rng.normal(size=shape).astype(np.float32), JDT[dt])
    return j, to_torch(np.asarray(j))


def close(got, want, dt, rows=None):
    """got: a torch tensor; want: a JAX array."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, **TOL[dt])


# ----------------------------------------------------------------------------
# mha_attention (K2's function)
# ----------------------------------------------------------------------------

MHA_CASES = [  # B, H, Hkv, Sq, Skv, D
    (1, 2, 2, 32, 32, 16),      # MHA square
    (2, 4, 2, 24, 24, 32),      # GQA group 2, ragged (not a block multiple)
    (1, 6, 2, 17, 17, 64),      # qwen2-like group 3, odd length
    (1, 8, 1, 16, 40, 16),      # MQA, Sq < Skv (right-aligned)
    (1, 4, 4, 40, 16, 32),      # Sq > Skv: causal rows with no key
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D", MHA_CASES)
def test_mha_attention_matches_jax_ref(B, H, Hkv, Sq, Skv, D, causal,
                                       compute, dt):
    rng = np.random.default_rng(B * 1000 + Sq * 10 + Skv)
    qj, qt = pair(rng, (B, H, Sq, D), dt)
    kj, kt = pair(rng, (B, Hkv, Skv, D), dt)
    vj, vt = pair(rng, (B, Hkv, Skv, D), dt)
    got = tref.mha_attention(qt, kt, vt, causal=causal,
                             compute_dtype=TDT[compute])
    want = jref.mha_attention(qj, kj, vj, causal=causal,
                              compute_dtype=JDT[compute])
    assert got.dtype == qt.dtype and got.shape == qt.shape
    # rows that see at least one key (the JAX reference gives NaN on others)
    seen = (np.arange(Sq) + Skv - Sq >= 0) if causal else np.ones(Sq, bool)
    close(got, want, dt if compute == "f32" else "bf16",
          rows=(slice(None), slice(None), seen))
    if not seen.all():
        assert not got[:, :, ~seen].any(), "empty rows must give 0"


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,bq,bk", [
    (1, 2, 2, 64, 64, 32, 32, 32),
    (1, 4, 2, 32, 64, 16, 16, 32),
    (1, 2, 2, 64, 32, 16, 32, 32),   # Sq > Skv: Pallas gives 0 on empty rows
])
def test_mha_attention_matches_pallas_interpret(B, H, Hkv, Sq, Skv, D, bq,
                                                bk, dt):
    rng = np.random.default_rng(Sq + Skv + D)
    qj, qt = pair(rng, (B, H, Sq, D), dt)
    kj, kt = pair(rng, (B, Hkv, Skv, D), dt)
    vj, vt = pair(rng, (B, Hkv, Skv, D), dt)
    got = tref.mha_attention(qt, kt, vt, causal=True)
    want = pallas_flash(qj, kj, vj, causal=True, block_q=bq, block_k=bk,
                        interpret=True)
    close(got, want, dt)    # every row, empty ones included


# ----------------------------------------------------------------------------
# paged_attention (K1's function)
# ----------------------------------------------------------------------------

def paged_inputs(rng, B, H, Hkv, D, page, max_pages, seq_lens, dt):
    P = B * max_pages + 3
    qj, qt = pair(rng, (B, H, D), dt)
    kj, kt = pair(rng, (P, page, Hkv, D), dt)
    vj, vt = pair(rng, (P, page, Hkv, D), dt)
    pt = rng.permutation(P)[:B * max_pages].reshape(B, max_pages)
    pt = pt.astype(np.int32)
    sl = np.asarray(seq_lens, np.int32)
    jax_in = (qj, kj, vj, jnp.asarray(pt), jnp.asarray(sl))
    torch_in = (qt, kt, vt, torch.from_numpy(pt), torch.from_numpy(sl))
    return jax_in, torch_in


PAGED_CASES = [  # B, H, Hkv, D, page, max_pages, seq_lens
    (2, 4, 4, 16, 8, 4, [5, 32]),
    (3, 6, 2, 32, 16, 3, [1, 17, 48]),
    (4, 14, 2, 64, 16, 5, [16, 33, 80, 2]),     # qwen2 heads
    (2, 8, 1, 16, 4, 6, [0, 23]),                # an empty row
    (2, 4, 2, 32, 8, 2, [16, 40]),               # seq_len past the table
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,D,page,max_pages,seq_lens", PAGED_CASES)
def test_paged_attention_matches_jax_ref(B, H, Hkv, D, page, max_pages,
                                         seq_lens, dt):
    rng = np.random.default_rng(B * 100 + D + page)
    jin, tin = paged_inputs(rng, B, H, Hkv, D, page, max_pages, seq_lens, dt)
    got = ops.paged_attention(*tin)
    want = jref.paged_attention(*jin)
    rows = np.asarray(seq_lens) > 0
    close(got, want, dt, rows=rows)
    assert not got[~torch.from_numpy(rows)].any(), "empty rows must give 0"


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,D,page,max_pages,seq_lens",
                         PAGED_CASES[:4])
def test_paged_attention_matches_pallas_interpret(B, H, Hkv, D, page,
                                                  max_pages, seq_lens, dt):
    rng = np.random.default_rng(B * 100 + D + page)
    jin, tin = paged_inputs(rng, B, H, Hkv, D, page, max_pages, seq_lens, dt)
    got = ops.paged_attention(*tin)
    want = pallas_paged(*jin, interpret=True)
    close(got, want, dt)    # every row, empty ones included


def test_paged_attention_reads_through_the_page_table():
    """Permuting the physical pool together with the table changes nothing
    — the translation is the only coupling (the TLB invariant)."""
    rng = np.random.default_rng(7)
    _, (q, kp, vp, pt, sl) = paged_inputs(rng, 3, 4, 2, 16, 8, 4,
                                          [9, 32, 20], "f32")
    perm = torch.from_numpy(rng.permutation(kp.shape[0]))
    inv = torch.argsort(perm)
    a = tref.paged_attention(q, kp, vp, pt, sl)
    b = tref.paged_attention(q, kp[perm], vp[perm], inv[pt.long()].int(), sl)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ----------------------------------------------------------------------------
# dispatch by device
# ----------------------------------------------------------------------------

def test_ops_dispatch_cpu_runs_plain_version():
    rng = np.random.default_rng(3)
    _, (q, kp, vp, pt, sl) = paged_inputs(rng, 2, 4, 2, 16, 8, 3, [5, 24],
                                          "f32")
    torch.testing.assert_close(ops.paged_attention(q, kp, vp, pt, sl),
                               tref.paged_attention(q, kp, vp, pt, sl),
                               rtol=0, atol=0)
    x = torch.randn(1, 2, 8, 16)
    torch.testing.assert_close(ops.flash_attention(x, x, x),
                               tref.mha_attention(x, x, x), rtol=0, atol=0)


def test_ops_dispatch_rejects_other_devices():
    x = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ops.flash_attention(x, x, x)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back to the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    x = torch.randn(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(x, x, x)
    rng = np.random.default_rng(0)
    _, tin = paged_inputs(rng, 2, 4, 2, 64, 8, 2, [3, 9], "f32")
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(*tin)
