"""Where a chunk's time goes inside the bf16 scan kernels K3 and K4.

    python -m repro_torch.kernels.phase_profile      # on a machine with a card

Copies ``csrc/mamba2_scan.cu`` and ``csrc/rwkv6_scan.cu`` into the build
directory with ``clock64()`` stamps between the phases of each chunk of
``mamba2_scan_mma_kernel`` and ``rwkv6_scan_mma_kernel`` (summed per warp
in registers, flushed once per block with ``atomicAdd``), builds them with
``nvcc`` beside the real libraries, puts their entry points in place of
the real ones for the wrappers, runs one call of each at the timed shapes
(K3: B=4, S=1024, H=64; K4: B=4, S=1024, H=32; bf16, state out) and prints
the mean SM cycles a chunk spends in each phase, per warp.  The stamps are
anchored on comments and statements of the sources: when a kernel changes,
the anchors below change with it (a missing anchor raises).  Phase times
are the span between two stamps of one warp, so a phase ending in a
barrier includes the wait for the slowest warp; the compiler may move
work across a stamp, so neighbouring phases blur.
"""
from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.kernels import _build

# per kernel: a stamp goes before each anchor and names the phase that ends
# there; "last" puts one more at the end of the chunk loop (its "@"), and
# "first" one after the loop's barrier
PHASES = {
    "rwkv6_scan": dict(
        loop="  for (int c = 0; c < n_chunks; ++c) {",
        first="    const bool more = c + 1 < n_chunks;",
        last=("      store_state_split();\n    }\n  }\n\n  if (s_out)",
              "      store_state_split();\n    }\n@  }\n\n  if (s_out)"),
        flush="  if (s_out) {\n#pragma unroll\n    for (int nt = 0; nt < 4;",
        anchors=[
            ("issue tile 0", "    const bf16* rs = stage + (c & 1) * 4 * "
                             "kTile;"),
            ("scan", "    __syncthreads();\n    if (more) load_tile(c + 1, "
                     "1);"),
            ("barrier, issue tile 1", "    // -- split operands"),
            ("split operands", "    // -- the two 8 x 8 diagonal blocks"),
            ("diagonal blocks", "    __syncthreads();     // kf, k2, ri, kq "
                                "and the diagonal blocks are"),
            ("barrier, issue tile 2", "    // -- this warp's partial "
                                      "scores"),
            ("scores", "    // the partner warp holds"),
            ("exchange, issue tile 3", "    // -- y, columns"),
            ("r'' S_in", "#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)"
                         " {\n      if (kk > a) continue;"),
            ("A V, store y", "    __syncthreads();     // every read of "
                             "S_in's split is done"),
            ("barrier", "    // -- S_out = "),
        ],
        last_name="state update"),
    "mamba2_scan": dict(
        loop="  for (int c = 0; c < n_chunks; ++c) {\n    cp_async_wait<0>();",
        first="    const bool more = c + 1 < n_chunks;",
        last=None,
        flush="  if (h_out) {\n#pragma unroll\n    for (int nt = 0; nt < 4;",
        anchors=[
            ("issue tile 0, dt", "    const bf16* xs = stage + (c & 1) * 3 "
                                 "* kTile;"),
            ("G = C B^T", "    // the chunk's cumulative decay"),
            ("decay scan (warp 0)", "    __syncthreads();     // s, exp(s), "
                                    "wd are written"),
            ("barrier, issue tile 1", "    // B o wd, split"),
            ("B o wd", "    // -- 2. att = G"),
            ("att", "    // -- 3. y = exp"),
            ("C h_in", "    {\n      const float e0 = es_s[row0]"),
            ("att X, store y", "    __syncthreads();     // h_in's split is "
                               "read"),
            ("barrier, issue tile 2", "    // -- 4. h_out"),
            ("state update", "    if (tid < kL) dt_s[((c + 1) & 1) * kL + "
                             "tid] = dt_next;"),
        ],
        last_name=None),
}
STAMP = "    PROF({i});\n"
HEADER = """
__device__ unsigned long long g_prof[8 * 16];
#define PROF(i) { const long long t_now = clock64(); \\
  pacc[i] += (unsigned long long)(t_now - t_prev); t_prev = t_now; }
"""
FOOTER = """
extern "C" int prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" int prof_reset() {
  static unsigned long long z[8 * 16] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""
WAIT = 15           # the stamp after the chunk loop's first barrier


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"phase_profile: anchor found {src.count(old)} "
                           f"times, expected once: {old!r}")
    return src.replace(old, new)


def instrumented(name: str) -> tuple[str, list[str]]:
    """The source of ``name`` with its stamps, and the phase names by
    stamp index."""
    spec = PHASES[name]
    src = (_build.CSRC / f"{name}.cu").read_text()
    names = [""] * 16
    for i, (phase, anchor) in enumerate(spec["anchors"]):
        src = _sub(src, anchor, STAMP.format(i=i) + anchor)
        names[i] = phase
    i = len(spec["anchors"])
    if spec["last"]:
        old, new = spec["last"]
        src = _sub(src, old, new.replace("@", STAMP.format(i=i)))
        names[i] = spec["last_name"]
    src = _sub(src, spec["first"], STAMP.format(i=WAIT) + spec["first"])
    names[WAIT] = "loop, wait, barrier"
    src = _sub(src, spec["loop"], "  long long t_prev = clock64();\n"
               "  unsigned long long pacc[16] = {0};\n" + spec["loop"])
    src = _sub(src, spec["flush"], "  if (lane == 0)\n    for (int i = 0; i "
               "< 16; ++i) atomicAdd(&g_prof[warp * 16 + i], pacc[i]);\n"
               + spec["flush"])
    src = src.replace("namespace {\n", "namespace {\n" + HEADER, 1) + FOOTER
    return src, names


def build(name: str):
    """Compile the instrumented ``name`` into the build directory."""
    src, names = instrumented(name)
    out = _build.build_dir() / "phase_profile"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(so)), names


def profile(name: str, call, blocks: int, chunks: int) -> None:
    lib, names = build(name)
    sym, argtypes = _build.SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    real = _build.load(name)
    _build._loaded[name] = fn
    try:
        call()                                   # warm
        torch.cuda.synchronize()
        if lib.prof_reset():
            raise RuntimeError("phase_profile: reset failed")
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 128)()
        if lib.prof_read(buf):
            raise RuntimeError("phase_profile: read failed")
    finally:
        _build._loaded[name] = real
    print(f"[phase_profile {name}] mean SM cycles a chunk, per warp, by "
          f"phase ({blocks} blocks x {chunks} chunks)")
    used = [i for i, n in enumerate(names) if n]
    for w in range(8):
        row = {names[i]: buf[w * 16 + i] / (blocks * chunks) for i in used}
        print(f"  warp {w}: " + ", ".join(f"{k} {v:.0f}"
                                         for k, v in row.items())
              + f"; total {sum(row.values()):.0f}")


def main() -> None:
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as rw
    if not torch.cuda.is_available():
        raise SystemExit("phase_profile: needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    bf = torch.bfloat16
    x, Bm, Cm = rn(4, 1024, 64, 64).to(bf), rn(4, 1024, 64).to(bf), \
        rn(4, 1024, 64).to(bf)
    dt = torch.nn.functional.softplus(rn(4, 1024, 64))
    A = -torch.linspace(1.0, 16.0, 64, device="cuda")
    D = torch.ones(64, device="cuda")
    profile("mamba2_scan", lambda: m2.mamba2_scan(
        x, dt, A, Bm, Cm, D, return_state=True), 256, 16)
    r, k, v = (rn(4, 1024, 32, 64).to(bf) for _ in range(3))
    w = torch.exp(-torch.exp(-3.0 + 0.5 * rn(4, 1024, 32, 64))).to(bf)
    u = 0.1 * rn(32, 64)
    profile("rwkv6_scan", lambda: rw.rwkv6_scan(r, k, v, w, u,
                                                return_state=True), 128, 16)


if __name__ == "__main__":
    main()
