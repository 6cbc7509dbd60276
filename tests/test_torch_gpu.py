"""The port's CUDA kernels vs their plain versions, on the card.

Every case carries the ``gpu`` marker and skips without a CUDA device (the
decision is taken in a fixture, not at import).  This file imports neither
JAX nor ``repro``, so it runs on a machine with only PyTorch and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the bars of ``tests/test_kernels.py``: 3e-4 for fp32,
6e-2 where bf16 rounds (bf16 inputs or ``compute_dtype``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def tol(dtype):
    return 3e-4 if dtype == torch.float32 else 6e-2


def paged_inputs(device, dtype, *, B, H, Hkv, D, page, seq_lens, seed=0):
    rng = np.random.default_rng(seed)
    max_pages = max(-(-s // page) for s in seq_lens) + 1
    P = B * max_pages + 5
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, D, generator=g).to(device, dtype)
    kp = torch.randn(P, page, Hkv, D, generator=g).to(device, dtype)
    vp = torch.randn(P, page, Hkv, D, generator=g).to(device, dtype)
    pt = torch.from_numpy(rng.permutation(P)[:B * max_pages]
                          .reshape(B, max_pages).astype(np.int32)).to(device)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=device)
    return q, kp, vp, pt, sl


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,Hkv,page", [(64, 14, 2, 16), (128, 8, 8, 16),
                                          (64, 8, 1, 8)])
def test_paged_attention_kernel_matches_plain(cuda, D, H, Hkv, page, dtype):
    args = paged_inputs(cuda, dtype, B=5, H=H, Hkv=Hkv, D=D, page=page,
                        seq_lens=[0, 1, 17, 95, 64])
    n = pa.paged_attention.launches
    got = ops.paged_attention(*args)
    assert pa.paged_attention.launches == n + 1
    want = ref.paged_attention(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol(dtype),
                               atol=tol(dtype))
    assert not got[0].any(), "a row with no key gives 0"


@pytest.mark.gpu
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,D,causal", [(100, 100, 64, True),
                                             (70, 200, 128, True),
                                             (130, 60, 64, True),
                                             (77, 150, 64, False)])
def test_flash_attention_kernel_matches_plain(cuda, Sq, Skv, D, causal,
                                              dtype, compute):
    g = torch.Generator().manual_seed(Sq + Skv)
    q = torch.randn(2, 6, Sq, D, generator=g).to(cuda, dtype)
    k = torch.randn(2, 2, Skv, D, generator=g).to(cuda, dtype)
    v = torch.randn(2, 2, Skv, D, generator=g).to(cuda, dtype)
    n = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, compute_dtype=compute)
    assert fa.flash_attention.launches == n + 1
    want = ref.mha_attention(q, k, v, causal=causal, compute_dtype=compute)
    t = max(tol(dtype), tol(compute))
    torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_build(cuda):
    q = torch.randn(1, 2, 8, 32, device=cuda)          # D = 32
    with pytest.raises(ValueError, match="D must be"):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    args = paged_inputs(cuda, torch.float32, B=2, H=4, Hkv=2, D=64, page=8,
                        seq_lens=[3, 9])
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(*args[:3], args[3].long(), args[4])
