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
    r, k, v, w, u, _ = rwkv_inputs(cuda, torch.float32, B=1, S=4, H=2, dh=32)
    with pytest.raises(ValueError, match="dh must be"):
        rw.rwkv6_scan(r, k, v, w, u)
    with pytest.raises(TypeError):
        rw.rwkv6_scan(r, k.bfloat16(), v, w, u)
    x, dt, A, Bm, Cm, D, _ = mamba_inputs(cuda, torch.float32, B=1, S=4, H=2,
                                          ds=32)
    with pytest.raises(ValueError, match="ds one of"):
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
