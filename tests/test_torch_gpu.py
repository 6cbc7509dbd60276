"""The port's CUDA kernels vs their plain versions, on the card.

Every case carries the ``gpu`` marker and skips without a CUDA device (the
decision is taken in a fixture, not at import).  This file imports neither
JAX nor ``repro``, so it runs on a machine with only PyTorch and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the bars of ``tests/test_kernels.py``: 3e-4 for fp32,
6e-2 where bf16 rounds (bf16 inputs or ``compute_dtype``); bf16 attention
under ``compute_dtype=fp32`` is also held to two bf16 ulps plus 2.5e-4.  The scans'
final states are fp32 on both sides, summed in another order: 3e-4 (scaled
by the state's magnitude) in either input dtype.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def tol(dtype):
    return 3e-4 if dtype == torch.float32 else 6e-2


def paged_inputs(device, dtype, *, B, H, Hkv, D, page, seq_lens, seed=0,
                 max_pages=None):
    """``max_pages`` below a row's pages clamps that row's keys."""
    rng = np.random.default_rng(seed)
    if max_pages is None:
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


def garbage_tail(pt, seq_lens, page):
    """The page table with every entry past a row's resident pages set to
    an id far outside the pool: a kernel that reads one faults."""
    pt = pt.clone()
    for b, s in enumerate(seq_lens):
        pt[b, -(-min(s, pt.shape[1] * page) // page):] = 2 ** 30
    return pt


# seq_lens: B = len(seq_lens); PART_KEYS = 128 keys a partition
PAGED_LENS = {
    "ragged": ([0, 1, 17, 95, 64], None),
    "partition_edges": ([127, 128, 129, 255, 256, 257, 0, 1000], None),
    "one_16k_sequence": ([16384], None),
    "clamped_to_table": ([40, 500, 0, 48], 3),   # 3 pages hold 48 / 24 keys
}


@pytest.mark.gpu
@pytest.mark.parametrize("lens", list(PAGED_LENS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,Hkv,page", [(64, 14, 2, 16), (128, 8, 8, 16),
                                          (64, 8, 1, 8), (64, 24, 2, 16)])
def test_paged_attention_kernel_matches_plain(cuda, D, H, Hkv, page, dtype,
                                              lens):
    """Split-K partitions at, below and above their edges, one long row
    (many partitions), seq_len 0 beside long rows, seq_len clamped to the
    table, and page-table entries past every row's length that must never
    be read; H/Hkv = 12 takes two head chunks of a block."""
    seq_lens, max_pages = PAGED_LENS[lens]
    args = paged_inputs(cuda, dtype, B=len(seq_lens), H=H, Hkv=Hkv, D=D,
                        page=page, seq_lens=seq_lens, max_pages=max_pages)
    q, kp, vp, pt, sl = args
    n = pa.paged_attention.launches
    got = ops.paged_attention(q, kp, vp, garbage_tail(pt, seq_lens, page),
                              sl)
    assert pa.paged_attention.launches == n + 1
    # the grid as launched: partitions from the table's shape alone, times
    # KV heads, head chunks of 8 and rows
    n_split = -(-pt.shape[1] * page // pa.PART_KEYS)
    assert pa.paged_attention.last_blocks == \
        n_split * Hkv * -(-(H // Hkv) // 8) * len(seq_lens)
    want = ref.paged_attention(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol(dtype),
                               atol=tol(dtype))
    for b, s in enumerate(seq_lens):
        if s == 0:
            assert not got[b].any(), "a row with no key gives 0"


@pytest.mark.gpu
def test_paged_attention_kernel_does_not_synchronise(cuda):
    """The wrapper never reads seq_lens on the host: it runs under the sync
    debug mode set to raise, and inside a captured CUDA graph, whose replay
    follows seq_lens changed on the card."""
    seq_lens = [300, 5, 0, 129]
    q, kp, vp, pt, sl = paged_inputs(cuda, torch.bfloat16, B=4, H=14, Hkv=2,
                                     D=64, page=16, seq_lens=seq_lens)
    pa.paged_attention(q, kp, vp, pt, sl)          # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pa.paged_attention(q, kp, vp, pt, sl)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention(q, kp, vp, pt, sl)
    sl.copy_(torch.tensor([17, 300, 64, 0], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(),
                               ref.paged_attention(q, kp, vp, pt, sl).float(),
                               rtol=tol(torch.bfloat16),
                               atol=tol(torch.bfloat16))
    assert not out[3].any()


@pytest.mark.gpu
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,D,causal", [(100, 100, 64, True),
                                             (70, 200, 128, True),
                                             (130, 60, 64, True),
                                             (77, 150, 64, False),
                                             (63, 63, 64, True),
                                             (64, 64, 128, True),
                                             (65, 65, 64, True),
                                             (127, 127, 128, True),
                                             (129, 129, 64, True),
                                             (2048, 2048, 64, True)])
def test_flash_attention_kernel_matches_plain(cuda, Sq, Skv, D, causal,
                                              dtype, compute):
    """Tile edges (63/64/65, 127/129 rows and keys), a long prompt, D = 128
    with the scale applied after the product, Sq > Skv (empty rows give
    0), non-causal."""
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
    if dtype == torch.bfloat16 and compute == torch.float32:
        # P is not rounded (hi + lo products): two bf16 ulps + 2.5e-4
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                                   atol=2.5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Skv,D,causal", [(8, 20, 1, 375, 64, False),
                                                 (2, 4, 1, 4, 16, False),
                                                 (2, 6, 70, 65, 64, True),
                                                 (2, 4, 9, 3, 128, True)])
def test_flash_attention_lse_route_matches_plain(cuda, B, H, Sq, Skv, D,
                                                 causal, dtype):
    """K2's LSE route (``fa.flash_attention_lse``, ``ops.flash_attention(
    ..., return_lse=True)``): the output as K2's, the fp32 LSE within 1e-4
    of the plain version's (+inf where a causal row sees no key: Sq >
    Skv); one count of its own, none of ``flash_attention``'s.  The first
    case is a rank's frames slice of whisper-large-v3's decode (375 of
    1500 frames, 20 heads of 64)."""
    g = torch.Generator().manual_seed(Sq + Skv)
    q = torch.randn(B, H, Sq, D, generator=g).to(cuda, dtype)
    k = torch.randn(B, H // 2, Skv, D, generator=g).to(cuda, dtype)
    v = torch.randn(B, H // 2, Skv, D, generator=g).to(cuda, dtype)
    n, m = fa.flash_attention_lse.launches, fa.flash_attention.launches
    got, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert fa.flash_attention_lse.launches == n + 1
    assert fa.flash_attention.launches == m
    want, wlse = ref.mha_attention(q, k, v, causal=causal, return_lse=True)
    t = tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert torch.equal(torch.isinf(lse), torch.isinf(wlse))
    seen = torch.isfinite(wlse)
    torch.testing.assert_close(lse[seen], wlse[seen], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_build(cuda):
    q = torch.randn(1, 2, 8, 160, device=cuda)         # D = 160 > 128
    with pytest.raises(ValueError, match="D=160"):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    args = paged_inputs(cuda, torch.float32, B=2, H=4, Hkv=2, D=64, page=8,
                        seq_lens=[3, 9])
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(*args[:3], args[3].long(), args[4])


# ----------------------------------------------------------------------------
# K3 / K4: the recurrent scans
# ----------------------------------------------------------------------------

def close_scaled(got, want, t):
    """|got - want| <= t * (1 + max|want|): the sums run over up to S
    steps, so the bar scales with the output's magnitude."""
    scale = 1.0 + float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=t,
                               atol=t * scale)


def mamba_inputs(device, dtype, *, B, S, H, dh=64, ds=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, dh, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.1 + 0.01
    A = -torch.rand(H, generator=g) * 2 - 0.1
    Bm = torch.randn(B, S, ds, generator=g)
    Cm = torch.randn(B, S, ds, generator=g)
    D = torch.randn(H, generator=g)
    h0 = torch.randn(B, H, ds, dh, generator=g)
    return (x.to(device, dtype), dt.to(device), A.to(device),
            Bm.to(device, dtype), Cm.to(device, dtype), D.to(device),
            h0.to(device))


def rwkv_inputs(device, dtype, *, B, S, H, dh=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(B, S, H, dh, generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, S, H, dh, generator=g) * 0.5
                             - 1.5))
    u = torch.randn(H, dh, generator=g) * 0.1
    s0 = torch.randn(B, H, dh, dh, generator=g)
    return (r.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            w.to(device, dtype), u.to(device), s0.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 100, 256])
def test_mamba2_scan_kernel_matches_plain(cuda, S, dtype, state):
    x, dt, A, Bm, Cm, D, h0 = mamba_inputs(cuda, dtype, B=2, S=S, H=3)
    h0 = h0 if state else None
    n = m2.mamba2_scan.launches
    y, h = ops.mamba2_scan(x, dt, A, Bm, Cm, D, h0=h0, return_state=True)
    assert m2.mamba2_scan.launches == n + 1
    wy, wh = ref.mamba2_scan_chunked(x, dt, A, Bm, Cm, D, h0=h0,
                                     return_state=True)
    assert y.dtype == dtype and h.dtype == torch.float32
    close_scaled(y, wy, tol(dtype))
    close_scaled(h, wh, 3e-4)
    # without return_state: the same output, no state
    y2 = ops.mamba2_scan(x, dt, A, Bm, Cm, D, h0=h0)
    assert torch.equal(y2, y)


@pytest.mark.gpu
def test_mamba2_scan_kernel_takes_strided_views(cuda):
    """x, B, C as the mixer hands them over: views into one (B, S, C)
    tensor, neither contiguous nor copied."""
    B, S, H, dh, ds = 2, 130, 2, 64, 64
    g = torch.Generator().manual_seed(4)
    xbc = torch.randn(B, S, H * dh + 2 * ds, generator=g).to(cuda)
    x, Bm, Cm = torch.split(xbc, [H * dh, ds, ds], -1)
    xh = x.reshape(B, S, H, dh)
    assert not xh.is_contiguous() and not Bm.is_contiguous()
    _, dt, A, _, _, D, h0 = mamba_inputs(cuda, torch.float32, B=B, S=S, H=H)
    got = ops.mamba2_scan(xh, dt, A, Bm, Cm, D, h0=h0)
    want = ref.mamba2_scan_chunked(xh.contiguous(), dt, A, Bm.contiguous(),
                                   Cm.contiguous(), D, h0=h0)
    close_scaled(got, want, 3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_mamba2_scan_kernel_does_not_depend_on_the_chunk(cuda, chunk):
    """The kernel's chunk is 64 steps; the plain version's may be any."""
    x, dt, A, Bm, Cm, D, h0 = mamba_inputs(cuda, torch.float32, B=1, S=200,
                                           H=2, seed=5)
    got = ops.mamba2_scan(x, dt, A, Bm, Cm, D, h0=h0)
    want = ref.mamba2_scan_chunked(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk)
    close_scaled(got, want, 3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 100, 256])
def test_rwkv6_scan_kernel_matches_plain(cuda, S, dtype, state):
    r, k, v, w, u, s0 = rwkv_inputs(cuda, dtype, B=2, S=S, H=3)
    s0 = s0 if state else None
    n = rw.rwkv6_scan.launches
    y, s = ops.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
    assert rw.rwkv6_scan.launches == n + 1
    wy, ws = ref.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
    assert y.dtype == dtype and s.dtype == torch.float32
    close_scaled(y, wy, tol(dtype))
    close_scaled(s, ws, 3e-4)
    y2 = ops.rwkv6_scan(r, k, v, w, u, s0=s0)
    assert torch.equal(y2, y)


@pytest.mark.gpu
def test_rwkv6_scan_kernel_strong_decay_stays_finite(cuda):
    """w underflowing to 0 and denormal: the kernel multiplies by w (no
    log), and is built without flush-to-zero."""
    r, k, v, w, u, s0 = rwkv_inputs(cuda, torch.float32, B=1, S=70, H=2)
    w = torch.exp(-torch.exp(torch.randn_like(w) * 2 + 1.0))
    w[0, :5] = 1e-40                     # denormal in fp32
    got = ops.rwkv6_scan(r, k, v, w, u, s0=s0)
    want = ref.rwkv6_scan(r, k, v, w, u, s0=s0)
    assert torch.isfinite(got).all()
    close_scaled(got, want, 3e-4)


# bf16 prefill on the tensor-core kernels, at the edges of their chunks
# (64 steps) and K4's sub-chunks (16) and quadrants (8)
EDGE_S = [15, 16, 63, 64, 65, 1000]


@pytest.mark.gpu
@pytest.mark.parametrize("S", EDGE_S)
def test_rwkv6_scan_bf16_chunk_edges(cuda, S):
    r, k, v, w, u, s0 = rwkv_inputs(cuda, torch.bfloat16, B=2, S=S, H=4,
                                    seed=S)
    y, s = ops.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
    assert rw.rwkv6_scan.last_kernel == "rwkv6_scan_mma_kernel"
    wy, ws = ref.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
    close_scaled(y, wy, tol(torch.bfloat16))
    close_scaled(s, ws, 3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("S", EDGE_S)
def test_mamba2_scan_bf16_chunk_edges(cuda, S):
    x, dt, A, Bm, Cm, D, h0 = mamba_inputs(cuda, torch.bfloat16, B=2, S=S,
                                           H=4, seed=S)
    y, h = ops.mamba2_scan(x, dt, A, Bm, Cm, D, h0=h0, return_state=True)
    assert m2.mamba2_scan.last_kernel == "mamba2_scan_mma_kernel"
    wy, wh = ref.mamba2_scan_chunked(x, dt, A, Bm, Cm, D, h0=h0,
                                     return_state=True)
    close_scaled(y, wy, tol(torch.bfloat16))
    close_scaled(h, wh, 3e-4)


@pytest.mark.gpu
def test_rwkv6_scan_bf16_strong_decay_stays_finite(cuda):
    """w = 0, bf16 denormal w and strong decays on the tensor-core kernel:
    its logs take the 1e-30 floor, its diagonal blocks multiply the w's."""
    r, k, v, _, u, s0 = rwkv_inputs(cuda, torch.bfloat16, B=1, S=200, H=2)
    g = torch.Generator().manual_seed(9)
    w = torch.exp(-torch.exp(torch.randn(1, 200, 2, 64, generator=g) * 2
                             + 1.0))
    w[0, 5:9] = 0.0
    w[0, 40:44] = 1e-39
    w = w.to(cuda, torch.bfloat16)
    y, s = ops.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
    assert rw.rwkv6_scan.last_kernel == "rwkv6_scan_mma_kernel"
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    wy, ws = ref.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
    close_scaled(y, wy, tol(torch.bfloat16))
    close_scaled(s, ws, 3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_decode_steps(cuda, dtype):
    """S = 1 with a state in and out takes the decode kernel; two decode
    steps give the state of one two-step scan."""
    r, k, v, w, u, s0 = rwkv_inputs(cuda, dtype, B=4, S=2, H=32, seed=3)
    y0, s1 = ops.rwkv6_scan(r[:, :1].contiguous(), k[:, :1].contiguous(),
                            v[:, :1].contiguous(), w[:, :1].contiguous(), u,
                            s0=s0, return_state=True)
    assert rw.rwkv6_scan.last_kernel == "rwkv6_scan_decode_kernel"
    y1, s2 = ops.rwkv6_scan(r[:, 1:].contiguous(), k[:, 1:].contiguous(),
                            v[:, 1:].contiguous(), w[:, 1:].contiguous(), u,
                            s0=s1, return_state=True)
    wy, ws = ref.rwkv6_scan(r, k, v, w, u, s0=s0, return_state=True)
    close_scaled(torch.cat([y0, y1], 1), wy, tol(dtype))
    close_scaled(s2, ws, 3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,S,want", [
    (torch.bfloat16, 100, "rwkv6_scan_mma_kernel"),
    (torch.float32, 100, "rwkv6_scan_kernel"),
    (torch.bfloat16, 1, "rwkv6_scan_decode_kernel"),
    (torch.float32, 1, "rwkv6_scan_decode_kernel")])
def test_rwkv6_scan_route(cuda, dtype, S, want):
    r, k, v, w, u, _ = rwkv_inputs(cuda, dtype, B=1, S=S, H=2)
    rw.rwkv6_scan(r, k, v, w, u)
    assert rw.rwkv6_scan.last_kernel == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, "mamba2_scan_mma_kernel"),
    (torch.float32, "mamba2_scan_kernel")])
def test_mamba2_scan_route(cuda, dtype, want):
    x, dt, A, Bm, Cm, D, _ = mamba_inputs(cuda, dtype, B=1, S=70, H=2)
    m2.mamba2_scan(x, dt, A, Bm, Cm, D)
    assert m2.mamba2_scan.last_kernel == want


def mixer_views(device, *, B, S, H, extra=0, offset=0, seed=4):
    """x, B, C as the mixer hands them over in bf16: views into one
    (B, S, offset + H*64 + 128 + extra) projection (ssm.py's split)."""
    g = torch.Generator().manual_seed(seed)
    xbc = torch.randn(B, S, offset + H * 64 + 128 + extra,
                      generator=g).to(device, torch.bfloat16)
    x, Bm, Cm = torch.split(xbc[..., offset:offset + H * 64 + 128],
                            [H * 64, 64, 64], -1)
    return x.reshape(B, S, H, 64), Bm, Cm


@pytest.mark.gpu
def test_mamba2_scan_bf16_takes_the_mixers_strided_views(cuda):
    B, S, H = 2, 130, 4
    xh, Bm, Cm = mixer_views(cuda, B=B, S=S, H=H)
    assert not xh.is_contiguous() and not Bm.is_contiguous()
    _, dt, A, _, _, D, h0 = mamba_inputs(cuda, torch.float32, B=B, S=S, H=H)
    y, h = ops.mamba2_scan(xh, dt, A, Bm, Cm, D, h0=h0, return_state=True)
    assert m2.mamba2_scan.last_kernel == "mamba2_scan_mma_kernel"
    wy, wh = ref.mamba2_scan_chunked(xh.contiguous(), dt, A, Bm.contiguous(),
                                     Cm.contiguous(), D, h0=h0,
                                     return_state=True)
    close_scaled(y, wy, tol(torch.bfloat16))
    close_scaled(h, wh, 3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("extra,offset", [(1, 0), (0, 1)])
def test_mamba2_scan_bf16_refuses_a_misaligned_view(cuda, extra, offset):
    """A step stride that is not a multiple of 8 bf16 (extra), or a base
    pointer off 16 bytes (offset): the kernel copies 16-byte rows."""
    B, S, H = 1, 20, 2
    xh, Bm, Cm = mixer_views(cuda, B=B, S=S, H=H, extra=extra, offset=offset)
    _, dt, A, _, _, D, _ = mamba_inputs(cuda, torch.float32, B=B, S=S, H=H)
    with pytest.raises(ValueError, match="16-byte"):
        m2.mamba2_scan(xh, dt, A, Bm, Cm, D)


@pytest.mark.gpu
def test_scan_kernels_do_not_synchronise_and_replay_in_a_graph(cuda):
    """K3 and K4 (bf16 prefill and the decode step) run under the sync
    debug mode set to raise, and inside a captured CUDA graph whose replay
    follows inputs changed in place."""
    rk = rwkv_inputs(cuda, torch.bfloat16, B=2, S=100, H=4, seed=5)
    rd = rwkv_inputs(cuda, torch.bfloat16, B=2, S=1, H=4, seed=6)
    mk = mamba_inputs(cuda, torch.bfloat16, B=2, S=100, H=4, seed=7)
    calls = [
        (lambda a: rw.rwkv6_scan(*a[:5], s0=a[5], return_state=True),
         lambda a: ref.rwkv6_scan(*a[:5], s0=a[5], return_state=True), rk),
        (lambda a: rw.rwkv6_scan(*a[:5], s0=a[5], return_state=True),
         lambda a: ref.rwkv6_scan(*a[:5], s0=a[5], return_state=True), rd),
        (lambda a: m2.mamba2_scan(*a[:6], h0=a[6], return_state=True),
         lambda a: ref.mamba2_scan_chunked(*a[:6], h0=a[6],
                                           return_state=True), mk)]
    for run, _, args in calls:
        run(args)                                  # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for run, _, args in calls:
            run(args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for run, plain, args in calls:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run(args)
        for t in args:
            if t is not None and t.is_floating_point():
                t.mul_(0.5 if t.dtype == torch.float32 else 0.75)
        graph.replay()
        torch.cuda.synchronize()
        want = plain(args)
        close_scaled(out[0], want[0], tol(torch.bfloat16))
        close_scaled(out[1], want[1], 3e-4)


@pytest.mark.gpu
def test_scan_kernels_refuse_what_they_do_not_build(cuda):
    r, k, v, w, u, _ = rwkv_inputs(cuda, torch.float32, B=1, S=4, H=2, dh=96)
    with pytest.raises(ValueError, match="dh=96"):
        rw.rwkv6_scan(r, k, v, w, u)
    r, k, v, w, u, _ = rwkv_inputs(cuda, torch.float32, B=1, S=4, H=2)
    with pytest.raises(TypeError):
        rw.rwkv6_scan(r, k.bfloat16(), v, w, u)
    x, dt, A, Bm, Cm, D, _ = mamba_inputs(cuda, torch.float32, B=1, S=4, H=2,
                                          ds=96)
    with pytest.raises(ValueError, match="ds=96"):
        m2.mamba2_scan(x, dt, A, Bm, Cm, D)


# ---------------------------------------------------------------------------
# the fabric's torch rate solver and a serving cluster on the card
# ---------------------------------------------------------------------------

def _fluid_finishes(dims, n, seed, **kw):
    import random

    from repro_torch.core import fabric
    from repro_torch.core.topology import Torus
    fabric.clear_route_cache()
    torus = Torus(dims)
    rnd = random.Random(seed)
    sim = fabric.make_sim(torus, fidelity="fluid", qos=fabric.QosPolicy(),
                          **kw)
    fids = []
    for _ in range(n):
        src = rnd.randrange(torus.size)
        dst = rnd.randrange(torus.size - 1)
        dst += dst >= src
        fids.append(sim.inject(src, dst, rnd.randint(64 << 10, 2 << 20),
                               cls=rnd.choice(list(fabric.TrafficClass)),
                               start_s=rnd.randint(0, 4) * 200e-6))
    sim.run()
    return np.array([sim.finish_s(f) for f in fids]), sim


@pytest.mark.gpu
@pytest.mark.parametrize("dims,n", [((4, 4), 12), ((4, 4, 4), 120),
                                    ((8, 8, 8), 400)])
def test_torch_solver_on_the_card_with_tf32_enabled(cuda, dims, n):
    """TF32 matmuls on (a process-wide setting a caller may hold) must not
    reach the solver: its finishes stay within 5e-4 of the numpy solver's,
    and byte accounting is exact.  Every drain re-solves (``exact_below``
    above the flow count): the default lazy re-solve schedule turns a
    last-bit difference in the rates into a different schedule (the numpy
    solver's own rates scaled by 1 + 1e-7 move finish times by 1.2 % at
    8x8x8 x 400), so finish times are compared where the schedule is
    exact."""
    kw = {"exact_below": 10 ** 9}
    want, ref_sim = _fluid_finishes(dims, n, n, **kw)
    prec = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        got, sim = _fluid_finishes(dims, n, n, solver="torch", **kw)
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert sim.device == "cuda"
    np.testing.assert_allclose(got, want, rtol=5e-4)
    assert sim.class_stats() == ref_sim.class_stats()


def _reduced_cluster_run(device, **kw):
    import copy

    from repro_torch import configs
    from repro_torch.core.topology import Torus
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving.cluster import ServingCluster
    from repro_torch.serving.engine import Request
    cfg = configs.get_config("qwen2-0.5b").reduced(head_dim=64)  # K1's D
    params = copy.deepcopy(init_lm(cfg, torch.Generator().manual_seed(0)))
    cl = ServingCluster(cfg, params, torus=Torus((2, 2)), max_batch=2,
                        max_seq=64, page_tokens=8, device=device, **kw)
    rng = np.random.default_rng(0)
    for rid in range(5):
        cl.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, size=(5 + 3 * rid,)).astype(np.int32),
            max_new_tokens=8))
    for _ in range(3):
        cl.step()
    cl.fail_link(0, 1)
    reps = [cl.migrate(next(iter(cl.nodes[0].engine.running.values())).rid,
                       1)]
    reps.append(cl.rebalance(threshold=1))
    cl.run_to_completion()
    wall = ("measured_step_s", "decode_stall_s")
    stats = cl.stats()
    for node in stats["nodes"].values():
        for k in wall:
            node.pop(k)
    return {r.rid: r.out_tokens for r in cl.finished}, reps, stats


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, {"fidelity": "fluid",
                                     "sim_kw": {"solver": "torch"}}])
def test_reduced_cluster_on_the_card_gives_the_cpus_run(cuda, kw):
    """A reduced fp32 qwen2 cluster with a migration through a failed
    link and a rebalance: the card (K1, K2) gives the CPU's tokens, and
    the timeline numbers, host arithmetic, are equal (on the fluid tier
    the torch solver runs on the card, the CPU's on the host, so the
    timeline there is held to the solver's bar)."""
    cpu_kw = dict(kw)
    if "sim_kw" in kw:
        cpu_kw["sim_kw"] = {"solver": "torch", "device": "cpu"}
    want = _reduced_cluster_run("cpu", **cpu_kw)
    got = _reduced_cluster_run("cuda", **kw)
    assert got[0] == want[0] and len(got[0]) == 5
    if not kw:
        assert got[1] == want[1] and got[2] == want[2]
    else:
        for a, b in zip(got[1], want[1]):
            assert a.hops == b.hops and a.nbytes == b.nbytes
            assert a.modelled_s == pytest.approx(b.modelled_s, rel=5e-4)


# ----------------------------------------------------------------------------
# K2-bwd and the training path on the card
# ----------------------------------------------------------------------------

def grad_bar_held(got, want, dtype, compute):
    """max |got - want| <= bar * max |want|, bar 3e-4 (fp32) or 6e-2 (bf16
    inputs or compute)."""
    bar = max(tol(dtype), tol(compute))
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= bar * float(w.float().abs().max()), (err, bar)


def plain_grads(q, k, v, dout, causal, compute):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    ref.mha_attention(q, k, v, causal=causal,
                      compute_dtype=compute).backward(dout)
    return q.grad, k.grad, v.grad


@pytest.mark.gpu
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal", [
    (2, 14, 2, 100, 100, 64, True), (1, 4, 2, 129, 129, 64, True),
    (1, 4, 4, 300, 100, 64, True), (1, 8, 1, 77, 200, 128, False),
    (1, 4, 2, 70, 150, 128, True)])
def test_flash_attention_gradient_matches_plain(cuda, B, H, Hkv, Sq, Skv, D,
                                                causal, dtype, compute):
    """ops.flash_attention under grad goes through K2 with its LSE and
    K2-bwd; its gradients hold the plain version's (autograd through
    ref.mha_attention): GQA, tile edges, empty causal rows (Sq > Skv),
    right-aligned causal keys, non-causal D = 128."""
    g = torch.Generator().manual_seed(Sq + Skv + D)
    mk = lambda h, s: torch.randn(B, h, s, D, generator=g).to(  # noqa: E731
        cuda, dtype).requires_grad_(True)
    q, k, v = mk(H, Sq), mk(Hkv, Skv), mk(Hkv, Skv)
    dout = torch.randn(B, H, Sq, D, generator=g).to(cuda, dtype)
    n_f, n_b = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = ops.flash_attention(q, k, v, causal=causal, compute_dtype=compute)
    assert out.grad_fn is not None
    out.backward(dout)
    assert fa.flash_attention.launches == n_f + 1
    assert fa.flash_attention_bwd.launches == n_b + 1
    want = plain_grads(q, k, v, dout, causal, compute)
    grad_bar_held((q.grad, k.grad, v.grad), want, dtype, compute)
    if causal and Sq > Skv:          # rows that see no key: zero gradient
        assert not q.grad[:, :, :Sq - Skv].any()


@pytest.mark.gpu
def test_flash_attention_lse_is_the_rows_logsumexp(cuda):
    g = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(1, 4, 150, 64, generator=g).to(cuda, dtype)
        k = torch.randn(1, 2, 90, 64, generator=g).to(cuda, dtype)
        lse = torch.empty(1, 4, 150, device=cuda)
        fa._forward(q, k, k, True, 64 ** -0.5, torch.float32, lse)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float() * 64 ** -0.5,
                         k.float().repeat_interleave(2, 1))
        qi = torch.arange(150, device=cuda)[:, None] - 60
        s = s.masked_fill(torch.arange(90, device=cuda)[None] > qi,
                          float("-inf"))
        want = torch.logsumexp(s, -1)
        assert bool(torch.isinf(lse[..., :60]).all())
        torch.testing.assert_close(lse[..., 60:], want[..., 60:], rtol=1e-5,
                                   atol=1e-5)


def bwd_inputs(cuda, B, H, Hkv, Sq, Skv, seed, dtype=torch.bfloat16, D=64):
    g = torch.Generator().manual_seed(seed)
    mk = lambda h, s: torch.randn(B, h, s, D, generator=g).to(  # noqa: E731
        cuda, dtype)
    return mk(H, Sq), mk(Hkv, Skv), mk(Hkv, Skv), mk(H, Sq)


@pytest.mark.gpu
def test_flash_attention_backward_reruns_bitwise(cuda):
    """No floating-point atomics: the same inputs give the same bits, at
    ragged shapes and at the training shapes of each wgmma pair (qwen2's
    batch 8 x 1024 at D = 64, olmoe's 4 x 1024 at D = 128; starcoder2's GQA
    12:1 at a ragged S)."""
    for B, H, Hkv, S, D in ((2, 14, 2, 257, 64), (8, 14, 2, 1024, 64),
                            (2, 24, 2, 257, 128), (4, 16, 16, 1024, 128)):
        q, k, v, dout = bwd_inputs(cuda, B, H, Hkv, S, S, 6, D=D)
        for compute in (torch.float32, torch.bfloat16):
            lse = torch.empty(B, H, S, device=cuda)
            out = fa._forward(q, k, v, True, D ** -0.5, compute, lse)
            a = fa.flash_attention_bwd(q, k, v, out, dout, lse,
                                       compute_dtype=compute)
            assert fa.flash_attention_bwd.last_kernel == fa.BWD_KERNELS[
                fa.BWD_WGMMA[D]]
            b = fa.flash_attention_bwd(q, k, v, out, dout, lse,
                                       compute_dtype=compute)
            assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv", [
    (1, 14, 2, 65, 65), (1, 14, 2, 127, 127), (1, 14, 2, 1000, 1000),
    (2, 14, 2, 1024, 1024), (1, 4, 4, 300, 100), (1, 4, 4, 127, 127),
    (1, 4, 2, 70, 150), (1, 24, 2, 200, 200)])
def test_flash_attention_backward_wgmma_route(cuda, B, H, Hkv, Sq, Skv,
                                              compute, D):
    """bf16 with D = 64 or 128 takes that width's wgmma pair: ragged tails
    (65, 127, 200, 1000), whole tiles, GQA 7:1, 12:1 and 1:1, empty causal
    rows (Sq > Skv) with zero gradients, right-aligned keys (Skv > Sq);
    held to the plain version."""
    q, k, v, dout = bwd_inputs(cuda, B, H, Hkv, Sq, Skv, Sq + Skv + H, D=D)
    lse = torch.empty(B, H, Sq, device=cuda)
    out = fa._forward(q, k, v, True, D ** -0.5, compute, lse)
    routes = dict(fa.flash_attention_bwd.routes)
    got = fa.flash_attention_bwd(q, k, v, out, dout, lse,
                                 compute_dtype=compute)
    assert fa.flash_attention_bwd.last_kernel == fa.BWD_KERNELS[
        fa.BWD_WGMMA[D]] == (f"attn_bwd_dkdv_wgmma_kernel<{D}>",
                            f"attn_bwd_dq_wgmma_kernel<{D}>")
    name = fa.BWD_ROUTES[fa.BWD_WGMMA[D]]
    assert fa.flash_attention_bwd.routes[name] == routes.get(name, 0) + 1
    want = plain_grads(q, k, v, dout, True, compute)
    grad_bar_held(got, want, torch.bfloat16, compute)
    if Sq > Skv:                     # rows that see no key: zero gradient
        assert not got[0][:, :, :Sq - Skv].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.float32, 128)])
def test_flash_attention_backward_fma_route(cuda, dtype, D):
    """fp32 inputs keep the FMA pair at both widths (their exact fp32
    products are the reduced fp32 models' contract)."""
    g = torch.Generator().manual_seed(D)
    q, k, v, dout = (torch.randn(1, 4, 70, D, generator=g).to(cuda, dtype)
                     for _ in range(4))
    lse = torch.empty(1, 4, 70, device=cuda)
    out = fa._forward(q, k, v, True, D ** -0.5, torch.float32, lse)
    fa.flash_attention_bwd(q, k, v, out, dout, lse)
    assert fa.flash_attention_bwd.last_kernel == fa.BWD_KERNELS[0]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_backward_takes_a_misaligned_view(cuda, D):
    """A contiguous view that starts off the 16-byte grid TMA needs is
    copied, not refused, on either wgmma pair."""
    q, k, v, dout = bwd_inputs(cuda, 1, 4, 2, 96, 96, 11, D=D)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    qv = buf[1:].view(q.shape)
    qv.copy_(q)
    assert qv.data_ptr() % 16
    lse = torch.empty(1, 4, 96, device=cuda)
    out = fa._forward(q, k, v, True, D ** -0.5, torch.float32, lse)
    got = fa.flash_attention_bwd(qv, k, v, out, dout, lse)
    assert fa.flash_attention_bwd.last_kernel == fa.BWD_KERNELS[
        fa.BWD_WGMMA[D]]
    want = fa.flash_attention_bwd(q, k, v, out, dout, lse)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.gpu
def test_kernels_without_a_backward_raise_under_grad(cuda):
    """No output cut off from its inputs' graph: K1 (paged attention, which
    only serving runs) has no backward kernel, so it raises when autograd
    would need one; K3 and K4 now go through their backward kernels."""
    args = paged_inputs(cuda, torch.float32, B=2, H=4, Hkv=2, D=64, page=8,
                        seq_lens=[3, 9])
    q = args[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="K1"):
        ops.paged_attention(q, *args[1:])
    # K2's plain wrapper refuses too (its gradient is FlashAttentionFn's)
    qa = torch.randn(1, 2, 8, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="FlashAttentionFn"):
        fa.flash_attention(qa, qa.detach(), qa.detach())
    with torch.no_grad():           # inference is unaffected
        ops.paged_attention(q, *args[1:])
        fa.flash_attention(qa, qa, qa)


@pytest.mark.gpu
def test_reduced_trainer_on_the_card_gives_the_cpus_losses(cuda, tmp_path):
    """A reduced fp32 qwen2 (D = 64 heads, so K2 takes it) trained on the
    card and on the CPU from the same weights: losses within rtol 1e-4,
    with TF32 off."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config("qwen2-0.5b").reduced(head_dim=64)
    init = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", "cuda"):
        tc = TrainerConfig(ckpt_dir=str(tmp_path / dev), ckpt_every=0,
                           batch=4, seq_len=96, comm="single",
                           opt=AdamWConfig(lr=3e-3, warmup_steps=0))
        n_b = fa.flash_attention_bwd.launches
        tr = Trainer(cfg, tc, device=dev, init_params=init)
        losses[dev] = [m["loss"] for m in tr.train(4)]
        if dev == "cuda":
            assert fa.flash_attention_bwd.launches == n_b + 4 * cfg.n_layers
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ----------------------------------------------------------------------------
# the encoder-decoder family (whisper): K2 and K2-bwd at its shapes
# ----------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv", [(1500, 1500), (224, 1500), (1, 1500),
                                    (1, 200), (5, 0)])
def test_flash_attention_kernel_whisper_shapes(cuda, Sq, Skv, dtype,
                                               compute):
    """Non-causal at whisper's shapes: the encoder (1500 frames, a ragged
    key tail), cross-attention in prefill (Sq = 224) and in a decode step
    (Sq = 1, 63 of the query tile's 64 rows masked), and no key at all
    (Skv = 0: zeros)."""
    g = torch.Generator().manual_seed(Sq + Skv)
    q = torch.randn(2, 4, Sq, 64, generator=g).to(cuda, dtype)
    k = torch.randn(2, 4, Skv, 64, generator=g).to(cuda, dtype)
    v = torch.randn(2, 4, Skv, 64, generator=g).to(cuda, dtype)
    n = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=False, compute_dtype=compute)
    assert fa.flash_attention.launches == n + 1
    want = ref.mha_attention(q, k, v, causal=False, compute_dtype=compute)
    t = max(tol(dtype), tol(compute))
    torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)
    if Skv == 0:
        assert not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv", [
    (1, 4, 4, 1500, 1500), (1, 4, 4, 448, 1500), (1, 4, 2, 70, 150),
    (1, 4, 4, 150, 70), (2, 4, 4, 1, 1500)])
def test_flash_attention_backward_wgmma_route_non_causal(cuda, B, H, Hkv, Sq,
                                                         Skv, compute, D):
    """Either wgmma pair without the causal mask, at whisper's training
    shapes (the encoder's 1500 frames; cross-attention Sq = 448 against
    1500) and Sq far from Skv either way; held to the plain version."""
    q, k, v, dout = bwd_inputs(cuda, B, H, Hkv, Sq, Skv, Sq + 2 * Skv, D=D)
    lse = torch.empty(B, H, Sq, device=cuda)
    out = fa._forward(q, k, v, False, D ** -0.5, compute, lse)
    got = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=False,
                                 compute_dtype=compute)
    assert fa.flash_attention_bwd.last_kernel == fa.BWD_KERNELS[
        fa.BWD_WGMMA[D]]
    want = plain_grads(q, k, v, dout, False, compute)
    grad_bar_held(got, want, torch.bfloat16, compute)


# ----------------------------------------------------------------------------
# K3-bwd and K4-bwd: the scans' backward kernels
# ----------------------------------------------------------------------------

def rwkv_bwd_inputs(device, dtype, *, B, S, H, seed=0, floor=False):
    """K4-bwd's inputs: rwkv6's decay (w ~ 0.95), and with ``floor`` w = 0
    and denormal w (under the plain version's 1e-30 floor) every few
    entries."""
    r, k, v, w, u, s0 = rwkv_inputs("cpu", torch.float32, B=B, S=S, H=H,
                                    seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    w = torch.exp(-torch.exp(-3.0 + 0.5 * torch.randn(w.shape, generator=g)))
    if floor:
        w.view(-1)[::7] = 0.0
        w.view(-1)[3::11] = 1e-39
    dy = torch.randn(r.shape, generator=g)
    ds_out = torch.randn(s0.shape, generator=g)
    lo = lambda t: t.to(device, dtype)  # noqa: E731
    return (lo(r), lo(k), lo(v), lo(w), u.to(device), s0.to(device), lo(dy),
            ds_out.to(device))


def grads_within(got, want, bar, names):
    """max |got - want| <= bar * max |want| for each named gradient."""
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        err = float((g.float() - w.float()).abs().max())
        assert err <= bar * float(w.float().abs().max()), (name, err, bar)


RWKV_GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")
MAMBA_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


@pytest.mark.gpu
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 8, 9, 37, 130])
def test_rwkv6_scan_backward_kernel_matches_plain(cuda, S, dtype, state):
    r, k, v, w, u, s0, dy, ds_out = rwkv_bwd_inputs(cuda, dtype, B=2, S=S,
                                                    H=3, seed=S)
    s0, ds_out = (s0, ds_out) if state else (None, None)
    n = rw.rwkv6_scan_bwd.launches
    got = rw.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
    assert rw.rwkv6_scan_bwd.launches == n + 1
    # fp32 takes the sequential route, bf16 the chunk-parallel one
    assert rw.rwkv6_scan_bwd.last_kernel == rw.BWD_KERNELS[
        int(dtype == torch.bfloat16)]
    want = ref.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
    grads_within(got, want, tol(dtype), RWKV_GRADS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_backward_kernel_under_the_floor(cuda, dtype):
    """w = 0 and denormal w: dw is 0 there, as the plain version's floor
    gives it, and every gradient stays within the bar."""
    r, k, v, w, u, s0, dy, ds_out = rwkv_bwd_inputs(
        cuda, dtype, B=2, S=70, H=2, seed=3, floor=True)
    got = rw.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
    want = ref.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
    under = w.float() < 1e-30
    assert under.any() and not got[3][under].any()
    grads_within(got, want, tol(dtype), RWKV_GRADS)


@pytest.mark.gpu
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 8, 9, 37, 130])
def test_mamba2_scan_backward_kernel_matches_plain(cuda, S, dtype, state):
    x, dt, A, Bm, Cm, D, h0 = mamba_inputs(cuda, dtype, B=2, S=S, H=3,
                                           seed=S)
    g = torch.Generator().manual_seed(S + 1)
    dy = torch.randn(x.shape, generator=g).to(cuda, dtype)
    dh_out = torch.randn(h0.shape, generator=g).to(cuda)
    h0, dh_out = (h0, dh_out) if state else (None, None)
    n = m2.mamba2_scan_bwd.launches
    got = m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0, dh_out=dh_out)
    assert m2.mamba2_scan_bwd.launches == n + 1
    assert m2.mamba2_scan_bwd.last_kernel == m2.BWD_KERNELS[
        int(dtype == torch.bfloat16)]
    want = ref.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0,
                               dh_out=dh_out)
    grads_within(got, want, tol(dtype), MAMBA_GRADS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_scan_backward_kernel_takes_strided_views(cuda, dtype):
    """x, B and C as the mixer hands them over (views into one projection):
    read in place, their gradients contiguous and equal to the contiguous
    inputs' bitwise."""
    B, S, H, dh, ds = 2, 70, 3, 64, 64
    x, dt, A, Bm, Cm, D, h0 = mamba_inputs(cuda, dtype, B=B, S=S, H=H,
                                           seed=8)
    xbc = torch.cat([x.reshape(B, S, H * dh), Bm, Cm], -1)
    xv, bv, cv = torch.split(xbc, [H * dh, ds, ds], -1)
    xv = xv.reshape(B, S, H, dh)
    assert not xv.is_contiguous() and not bv.is_contiguous()
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(9)) \
        .to(cuda, dtype)
    got = m2.mamba2_scan_bwd(xv, dt, A, bv, cv, D, dy, h0=h0)
    same = m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0)
    assert all(torch.equal(a, b) for a, b in zip(got, same))
    assert got[0].is_contiguous() and got[3].is_contiguous()
    want = ref.mamba2_scan_bwd(xv, dt, A, bv, cv, D, dy, h0=h0)
    grads_within(got, want, tol(dtype), MAMBA_GRADS)


@pytest.mark.gpu
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("S", [63, 64, 65, 128, 130])
def test_scan_backward_bf16_routes_at_chunk_edges(cuda, S, state):
    """The chunk-parallel routes (chunks of 64 steps) at and around chunk
    edges, with and without a state in and its gradient out."""
    r, k, v, w, u, s0, dy, ds_out = rwkv_bwd_inputs(
        cuda, torch.bfloat16, B=2, S=S, H=3, seed=20 + S)
    s0, ds_out = (s0, ds_out) if state else (None, None)
    got = rw.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
    assert rw.rwkv6_scan_bwd.last_kernel == rw.BWD_KERNELS[1] == (
        "rwkv6_scan_bwd_chunk_kernel")
    want = ref.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
    grads_within(got, want, 6e-2, RWKV_GRADS)
    x, dt, A, Bm, Cm, D, h0 = mamba_inputs(cuda, torch.bfloat16, B=2, S=S,
                                           H=3, seed=30 + S)
    g = torch.Generator().manual_seed(S)
    dy = torch.randn(x.shape, generator=g).to(cuda, torch.bfloat16)
    dh_out = torch.randn(h0.shape, generator=g).to(cuda)
    h0, dh_out = (h0, dh_out) if state else (None, None)
    got = m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0, dh_out=dh_out)
    assert m2.mamba2_scan_bwd.last_kernel == m2.BWD_KERNELS[1] == (
        "mamba2_scan_bwd_chunk_kernel")
    want = ref.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0,
                               dh_out=dh_out)
    grads_within(got, want, 6e-2, MAMBA_GRADS)


@pytest.mark.gpu
def test_rwkv6_scan_backward_bf16_strong_decay_equals_the_fp32_route(cuda):
    """Strong decay (w down to e^-150, w = 0, denormal w), where the plain
    version's dw is lost: the bf16 route's every gradient is held to the
    fp32 route (both direct forms) on the same values, and dw is 0 under
    the floor."""
    g = torch.Generator().manual_seed(41)
    shape = (2, 200, 3, 64)
    r, k, v, dy = (torch.randn(shape, generator=g) for _ in range(4))
    w = torch.exp(-torch.exp(2.0 * torch.randn(shape, generator=g) + 1.0))
    w.view(-1)[::7] = 0.0
    w.view(-1)[3::11] = 1e-39
    u = 0.1 * torch.randn(3, 64, generator=g)
    s0, ds_out = (torch.randn(2, 3, 64, 64, generator=g) for _ in range(2))
    bf = [t.to(cuda, torch.bfloat16) for t in (r, k, v, w, dy)]
    u, s0, ds_out = u.to(cuda), s0.to(cuda), ds_out.to(cuda)
    got = rw.rwkv6_scan_bwd(*bf[:4], u, bf[4], s0=s0, ds_out=ds_out)
    assert rw.rwkv6_scan_bwd.last_kernel == rw.BWD_KERNELS[1]
    f = [t.float() for t in bf]
    want = rw.rwkv6_scan_bwd(*f[:4], u, f[4], s0=s0, ds_out=ds_out)
    assert rw.rwkv6_scan_bwd.last_kernel == rw.BWD_KERNELS[0]
    assert all(bool(torch.isfinite(t).all()) for t in got)
    grads_within([t.float() for t in got], want, 6e-2, RWKV_GRADS)
    under = bf[3].float() < 1e-30
    assert under.any() and not got[3][under].any()


@pytest.mark.gpu
def test_mamba2_scan_backward_bf16_equals_the_fp32_route(cuda):
    """zamba2's widths (H = 64), 300 steps, the mixer's views: the bf16
    route's gradients held to the fp32 route's on the same values."""
    B, S, H = 2, 300, 64
    x, dt, A, Bm, Cm, D, h0 = mamba_inputs(cuda, torch.bfloat16, B=B, S=S,
                                           H=H, seed=42)
    xbc = torch.cat([x.reshape(B, S, H * 64), Bm, Cm], -1)
    xv, bv, cv = torch.split(xbc, [H * 64, 64, 64], -1)
    xv = xv.reshape(B, S, H, 64)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(43)) \
        .to(cuda, torch.bfloat16)
    got = m2.mamba2_scan_bwd(xv, dt, A, bv, cv, D, dy, h0=h0)
    assert m2.mamba2_scan_bwd.last_kernel == m2.BWD_KERNELS[1]
    want = m2.mamba2_scan_bwd(x.float(), dt, A, Bm.float(), Cm.float(), D,
                              dy.float(), h0=h0)
    assert m2.mamba2_scan_bwd.last_kernel == m2.BWD_KERNELS[0]
    grads_within([t.float() for t in got], want, 6e-2, MAMBA_GRADS)


@pytest.mark.gpu
@pytest.mark.parametrize("extra,offset", [(4, 0), (0, 4)])
def test_mamba2_scan_backward_bf16_refuses_a_misaligned_view(cuda, extra,
                                                            offset):
    """The bf16 route copies rows 16 bytes at a time, as the bf16 forward
    does: a step stride or a start off 16 bytes raises."""
    B, S, H = 1, 70, 2
    x, dt, A, Bm, Cm, D, _ = mamba_inputs(cuda, torch.bfloat16, B=B, S=S,
                                          H=H, seed=44)
    width = offset + H * 64 + 128 + extra
    buf = torch.zeros(B, S, width, device=cuda, dtype=torch.bfloat16)
    xv = buf[..., offset:offset + H * 64].view(B, S, H, 64)
    bv = buf[..., offset + H * 64:offset + H * 64 + 64]
    cv = buf[..., offset + H * 64 + 64:offset + H * 64 + 128]
    dy = torch.zeros(B, S, H, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        m2.mamba2_scan_bwd(xv, dt, A, bv, cv, D, dy)


@pytest.mark.gpu
def test_scan_backward_kernels_rerun_bitwise(cuda):
    """No atomics: the same inputs give the same bits (du, dA, dD, dB, dC
    are sums in a fixed order), at the models' training shapes' widths."""
    args = rwkv_bwd_inputs(cuda, torch.bfloat16, B=2, S=257, H=32, seed=4)
    r, k, v, w, u, s0, dy, ds_out = args
    a = rw.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
    b = rw.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0, ds_out=ds_out)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    x, dt, A, Bm, Cm, D, h0 = mamba_inputs(cuda, torch.bfloat16, B=2,
                                           S=257, H=64, seed=5)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)) \
        .to(cuda, torch.bfloat16)
    a = m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0)
    b = m2.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_functions_under_grad_reach_the_backward_kernels(
        cuda, dtype, return_state):
    """ops.rwkv6_scan and ops.mamba2_scan under grad on the card: K3/K4
    forward, K3-bwd/K4-bwd backward (one launch each), every gradient in its
    input's dtype and within the bar of autograd through the plain
    versions; a final state without a gradient counts as zero."""
    r, k, v, w, u, s0, dy, _ = rwkv_bwd_inputs(cuda, dtype, B=2, S=40, H=2,
                                               seed=10)
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    n_f, n_b = rw.rwkv6_scan.launches, rw.rwkv6_scan_bwd.launches
    out = ops.rwkv6_scan(*ins[:5], s0=ins[5], return_state=return_state)
    y = out[0] if return_state else out
    (y.float() * dy.float()).sum().backward()
    assert rw.rwkv6_scan.launches == n_f + 1
    assert rw.rwkv6_scan_bwd.launches == n_b + 1
    want = ref.rwkv6_scan_bwd(r, k, v, w, u, dy, s0=s0)
    grads_within([t.grad for t in ins], want, tol(dtype), RWKV_GRADS)

    x, dt, A, Bm, Cm, D, h0 = mamba_inputs(cuda, dtype, B=2, S=40, H=2,
                                           seed=11)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(12)) \
        .to(cuda, dtype)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm, D, h0)]
    n_f, n_b = m2.mamba2_scan.launches, m2.mamba2_scan_bwd.launches
    out = ops.mamba2_scan(*ins[:6], h0=ins[6], return_state=return_state)
    y = out[0] if return_state else out
    (y.float() * dy.float()).sum().backward()
    assert m2.mamba2_scan.launches == n_f + 1
    assert m2.mamba2_scan_bwd.launches == n_b + 1
    want = ref.mamba2_scan_bwd(x, dt, A, Bm, Cm, D, dy, h0=h0)
    grads_within([t.grad for t in ins], want, tol(dtype), MAMBA_GRADS)


@pytest.mark.gpu
def test_reduced_recurrent_training_on_the_card_gives_the_cpus_losses(
        cuda, tmp_path):
    """Reduced fp32 rwkv6 and zamba2, shaped for the kernels, trained 3 steps
    on the card (K3/K4 twice a layer a step under remat, K3-bwd/K4-bwd
    once) and on the CPU from the same weights: losses within rtol 1e-4."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.models.common import SsmCfg
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, over, fwd, bwd in (
            ("rwkv6-1.6b", dict(head_dim=64), rw.rwkv6_scan,
             rw.rwkv6_scan_bwd),
            ("zamba2-1.2b", dict(head_dim=64, ssm=SsmCfg(
                d_state=64, head_dim=64, expand=2, conv_width=4)),
             m2.mamba2_scan, m2.mamba2_scan_bwd)):
        cfg = configs.get_config(name).reduced(**over)
        init = api.get_model(cfg).init(torch.Generator().manual_seed(0))
        losses = {}
        for dev in ("cpu", "cuda"):
            tc = TrainerConfig(ckpt_dir=str(tmp_path / name / dev),
                               ckpt_every=0, batch=2, seq_len=40,
                               comm="single",
                               opt=AdamWConfig(lr=3e-3, warmup_steps=0))
            n_f, n_b = fwd.launches, bwd.launches
            tr = Trainer(cfg, tc, device=dev, init_params=init)
            losses[dev] = [m["loss"] for m in tr.train(3)]
            if dev == "cuda":
                assert fwd.launches == n_f + 3 * 2 * cfg.n_layers
                assert bwd.launches == n_b + 3 * cfg.n_layers
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ----------------------------------------------------------------------------
# the MoE family (olmoe-1b-7b): K1, K2 and K2-bwd at head width 128
# ----------------------------------------------------------------------------

@pytest.mark.gpu
def test_paged_attention_kernel_olmoe_decode_shape(cuda):
    """The engine's decode batch of 8, 16 heads and 16 KV heads of 128,
    a 67-page table, bf16: the split-K route, held to the plain
    version."""
    rng = np.random.default_rng(8)
    seq_lens = [int(s) for s in rng.integers(128, 1057, size=8)]
    args = paged_inputs(cuda, torch.bfloat16, B=8, H=16, Hkv=16, D=128,
                        page=16, seq_lens=seq_lens, max_pages=67)
    n = pa.paged_attention.routes.get("split_k", 0)
    got = ops.paged_attention(*args)
    assert pa.paged_attention.routes["split_k"] == n + 1
    want = ref.paged_attention(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                               atol=2.5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(1, 1024), (4, 1024)])
def test_flash_attention_kernel_olmoe_shapes(cuda, B, S):
    """Causal MHA, 16 heads of 128, bf16: the engine's longest prompt and
    the training forward (4 x 1024), on the tensor-core route."""
    g = torch.Generator().manual_seed(B + S)
    q, k, v = (torch.randn(B, 16, S, 128, generator=g).to(
        cuda, torch.bfloat16) for _ in range(3))
    n = fa.flash_attention.routes.get("mma", 0)
    got = ops.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.routes["mma"] == n + 1
    want = ref.mha_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                               atol=2.5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_olmoe_training_shape(cuda, compute):
    """K2-bwd at olmoe's training shape (B = 4, 16 heads of 128, S =
    1024, causal, bf16): the wgmma pair at D = 128, held to autograd
    through the plain attention, and bitwise on a rerun."""
    g = torch.Generator().manual_seed(128)
    q, k, v, dout = (torch.randn(4, 16, 1024, 128, generator=g).to(
        cuda, torch.bfloat16) for _ in range(4))
    lse = torch.empty(4, 16, 1024, device=cuda)
    out = fa._forward(q, k, v, True, 128 ** -0.5, compute, lse)
    got = fa.flash_attention_bwd(q, k, v, out, dout, lse,
                                 compute_dtype=compute)
    assert fa.flash_attention_bwd.last_kernel == fa.BWD_KERNELS[3]
    grad_bar_held(got, plain_grads(q, k, v, dout, True, compute),
                  torch.bfloat16, compute)
    again = fa.flash_attention_bwd(q, k, v, out, dout, lse,
                                   compute_dtype=compute)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_reduced_olmoe_on_the_card_gives_the_cpus_losses(cuda, tmp_path):
    """The reduced fp32 olmoe (head_dim 16: the small-width routes; the
    MoE dispatch global on one rank) trained 3 steps on the card and on
    the CPU from the same weights: losses within rtol 1e-4, TF32 off."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_reduced("olmoe-1b-7b")
    init = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", "cuda"):
        tc = TrainerConfig(ckpt_dir=str(tmp_path / dev), ckpt_every=0,
                           batch=4, seq_len=64, comm="single",
                           opt=AdamWConfig(lr=3e-3, warmup_steps=0))
        n_b = fa.flash_attention_bwd.routes.get("small", 0)
        tr = Trainer(cfg, tc, device=dev, init_params=init)
        losses[dev] = [m["loss"] for m in tr.train(3)]
        if dev == "cuda":
            assert fa.flash_attention_bwd.routes["small"] == \
                n_b + 3 * cfg.n_layers
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ----------------------------------------------------------------------------
# the AdamW kernel pair (kernels/adamw.py) vs its plain version
# ----------------------------------------------------------------------------

def adamw_mix(device, seed=0):
    """({leaf: [tensors]}, state, grads a step): bf16 stacked matrices, an
    fp32 stacked router, 1-D norm gains inside a stacked leaf (decayed), a
    lone 1-D final norm (not), a lone bf16 matrix of 3 chunks and an odd
    size, and a leaf without a gradient in one layer and one whole."""
    from repro_torch.optim import adamw_init
    g = torch.Generator().manual_seed(seed)
    shapes = {"embed": (1001, 41), "final_norm": (37,),
              "layers/ln": (2, 37), "layers/router": (2, 24, 8),
              "layers/w": (2, 40, 24), "unused": (3, 5)}
    stacked = {k: (0.02 * torch.randn(s, generator=g)).to(
        torch.float32 if k == "layers/router" else torch.bfloat16)
        for k, s in shapes.items()}
    params = {k: [t.clone().to(device) for t in v] if k.startswith("layers/")
              else [v.clone().to(device)] for k, v in stacked.items()}
    state = adamw_init({k: v.to(device) for k, v in stacked.items()})
    grads = [{k: [(torch.randn(p.shape, generator=g) * 0.1).to(device,
                                                                  p.dtype)
                  for p in ps] for k, ps in params.items()}
             for _ in range(3)]
    for gs in grads:
        gs["unused"] = [None]
        gs["layers/w"][1] = None
    return params, state, grads


def adamw_copy(params, state):
    return ({k: [p.clone() for p in ps] for k, ps in params.items()},
            {"m": {k: t.clone() for k, t in state["m"].items()},
             "v": {k: t.clone() for k, t in state["v"].items()},
             "step": state["step"].clone()})


def within_ulp(got, want, bits):
    """|got - want| at most one unit in the last place of a ``bits``-bit
    significand (bf16: 8) at want's magnitude."""
    e = torch.frexp(want.float()).exponent
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), e - bits)
    return bool(((got.float() - want.float()).abs() <= ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("clip_norm", [1e9, 0.05])
def test_adamw_kernel_matches_plain(cuda, clip_norm):
    """Three steps of the kernel pair and of its plain version from one
    state.  Clipping inactive (scale 1): parameters, m and v bitwise.
    Active: the kernel's norm is summed in another order, so the clip
    scale may differ in its last bits, and so may every g * scale: bf16
    parameters within one bf16 ulp; fp32 parameters (a step lr * delta as
    large as the parameter at this lr, so a few of its ulps) and the
    moments within 1e-6 of the leaf's largest magnitude.  One launch a
    step; the counters grow by every element the kernel updated, the
    eager one not at all."""
    from repro_torch import configs
    from repro_torch.core.fabric import process_hub
    from repro_torch.kernels import adamw as ka
    from repro_torch.optim import (AdamWConfig, adamw_update_,
                                   adamw_update_plain_)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                      clip_norm=clip_norm)
    arch = configs.get_reduced("qwen2-0.5b")   # stacks "layers/..." leaves
    params, state, grads = adamw_mix(cuda)
    ref_p, ref_s = adamw_copy(params, state)
    hub = process_hub()
    n = sum(p.numel() for ps in params.values() for p in ps)
    for gs in grads:
        for ps, rs, k in ((params[k], ref_p[k], k) for k in params):
            for p, r, g in zip(ps, rs, gs[k]):
                p.grad = r.grad = g
        n0, e0 = ka.fused_adamw.launches, hub.value("adamw.eager_elems")
        f0 = hub.value("adamw.fused_elems")
        got = adamw_update_(cfg, params, state)
        assert ka.fused_adamw.launches == n0 + 1
        assert hub.value("adamw.fused_elems") - f0 == n
        assert hub.value("adamw.eager_elems") == e0
        want = adamw_update_plain_(cfg, ref_p, ref_s, arch=arch)
        torch.cuda.synchronize()
        assert int(state["step"]) == int(ref_s["step"])
        torch.testing.assert_close(got["lr"], want["lr"], rtol=0, atol=0)
        torch.testing.assert_close(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-6, atol=0)
        for k in params:
            pairs = [(p, r) for p, r in zip(params[k], ref_p[k])] + [
                (state[mom][k], ref_s[mom][k]) for mom in ("m", "v")]
            for a, b in pairs:
                if clip_norm > 1e6:
                    assert torch.equal(a, b), k
                elif a.dtype == torch.bfloat16:
                    assert within_ulp(a, b, 8), k
                else:
                    assert float((a - b).abs().max()) <= \
                        1e-6 * float(b.abs().max()), k
    assert ka.fused_adamw.last_blocks[0] > 0


@pytest.mark.gpu
def test_adamw_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels import adamw as ka
    from repro_torch.optim import AdamWConfig
    one = torch.ones((), device=cuda)
    p = torch.zeros(4, 6, device=cuda, dtype=torch.float16)
    m = {"w": torch.zeros(4, 6, device=cuda)}
    with pytest.raises(TypeError, match="adamw kernel"):
        ka.fused_adamw(AdamWConfig(), {"w": [p]}, m, m, one, one, one)
    with pytest.raises(ValueError, match="adamw kernel"):
        ka.fused_adamw(AdamWConfig(), {"w": [p.float().t()]}, m, m, one,
                       one, one)


@pytest.mark.gpu
def test_trainer_on_the_card_updates_in_place(cuda, tmp_path, monkeypatch):
    """``Trainer(comm="single")`` on the card takes the kernel pair once a
    step over every parameter and no stacked copy; with its plain version
    in the kernel's place the same steps give the same weights bitwise
    (clipping inactive), and gradient accumulation keeps the eager
    update."""
    from repro_torch import configs
    from repro_torch.core.fabric import process_hub
    from repro_torch.kernels import adamw as ka
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_update_plain_
    from repro_torch.runtime import trainer as trainer_mod
    cfg = configs.get_reduced("qwen2-0.5b")
    init = api.get_model(cfg).init(torch.Generator().manual_seed(0))
    hub = process_hub()

    def run(tag, stacked=True, **kw):
        tc = trainer_mod.TrainerConfig(
            ckpt_dir=str(tmp_path / tag), ckpt_every=0, batch=4, seq_len=32,
            comm="single", opt=AdamWConfig(lr=3e-3, warmup_steps=0,
                                           clip_norm=1e9), **kw)
        tr = trainer_mod.Trainer(cfg, tc, device=cuda, init_params=init)
        if not stacked:   # no leaf stacked, nothing copied back

            def boom(*a):
                raise AssertionError("a stacked copy on the card's path")
            tr._leaf_grads = tr._leaf_values = tr._assign = boom
        n0, e0 = ka.fused_adamw.launches, hub.value("adamw.eager_elems")
        f0 = hub.value("adamw.fused_elems")
        losses = [m["loss"] for m in tr.train(3)]
        return (tr, losses, ka.fused_adamw.launches - n0,
                hub.value("adamw.fused_elems") - f0,
                hub.value("adamw.eager_elems") - e0)

    tr, losses, launches, fused, eager = run("fused", stacked=False)
    assert (launches, fused, eager) == (3, 3 * tr.n_params, 0)
    monkeypatch.setattr(trainer_mod, "adamw_update_", functools.partial(
        adamw_update_plain_, arch=cfg))
    ref, ref_losses, launches, fused, eager = run("plain")
    assert (launches, fused, eager) == (0, 0, 3 * tr.n_params)
    assert losses == ref_losses
    for a, b in zip(tr.params.parameters(), ref.params.parameters()):
        assert torch.equal(a, b)
    _, _, launches, fused, eager = run("accum", grad_accum=2)
    assert (launches, fused, eager) == (0, 0, 3 * tr.n_params)
