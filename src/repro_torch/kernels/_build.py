"""Build and load the CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes).  Libraries land in
``build/repro_torch/`` at the root of the checkout (or in
``$REPRO_TORCH_BUILD_DIR``), named by a hash of the source and the flags,
so a changed source is rebuilt and an unchanged one is built once.

The build happens at first use (``load``); ``build_all`` compiles every
kernel at once, one ``nvcc`` per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("paged_attention", "flash_attention", "flash_attention_bwd",
           "mamba2_scan", "mamba2_scan_bwd", "mamba2_scan_bwd_chunk",
           "rwkv6_scan", "rwkv6_scan_bwd", "rwkv6_scan_bwd_chunk", "adamw")
# no --use_fast_math / -ftz: flushing denormals to zero would break the
# scans' guards (the exponent selected before exp, w floored before log)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_vp, _i, _f, _ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
# C signatures of the entry points: every pointer and the stream are void*
SIGNATURES = {
    "paged_attention": ("paged_attention_launch",
                        [_vp] * 7 + [_i] * 7
                        + [_f, _i, ctypes.POINTER(_i), _vp]),
    "flash_attention": ("flash_attention_launch",
                        [_vp] * 5 + [_i] * 7 + [_f, _i, _i, _vp, _vp]),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [_vp] * 10 + [_i] * 7 + [_f, _i, _i, _vp, _vp]),
    "mamba2_scan": ("mamba2_scan_launch",
                    [_vp] * 9 + [_i] * 5 + [_ll] * 6 + [_i, _vp, _vp]),
    "mamba2_scan_bwd": ("mamba2_scan_bwd_launch",
                        [_vp] * 17 + [_i] * 5 + [_ll] * 6 + [_i, _vp, _vp]),
    "mamba2_scan_bwd_chunk": ("mamba2_scan_bwd_chunk_launch",
                              [_vp] * 17 + [_i] * 5 + [_ll] * 6
                              + [_vp, _vp]),
    "rwkv6_scan": ("rwkv6_scan_launch", [_vp] * 8 + [_i] * 5 + [_vp, _vp]),
    "rwkv6_scan_bwd": ("rwkv6_scan_bwd_launch",
                       [_vp] * 16 + [_i] * 5 + [_vp, _vp]),
    "rwkv6_scan_bwd_chunk": ("rwkv6_scan_bwd_chunk_launch",
                             [_vp] * 15 + [_i] * 4 + [_vp, _vp]),
    "adamw": ("adamw_launch", [_vp, _i, _ll, _vp, _i] + [_vp] * 4 + [_f] * 7
              + [ctypes.POINTER(_i), _vp]),
}

# second entry points of a kernel's source: name -> (source, signature)
ENTRIES = {"rwkv6_scan_split": ("rwkv6_scan", (
    "rwkv6_scan_split_launch", [_vp] * 8 + [_i] * 5 + [_vp]))}

_loaded: dict[str, ctypes._CFuncPtr] = {}


# where the one kernel without a backward stands in ROADMAP.md: K1, which
# only serving runs
NO_BACKWARD = "ROADMAP section 2 (K1, paged attention, has no backward " \
    "kernel: only serving runs it)"


def count(fn, route: str) -> None:
    """One launch of ``fn``'s kernel by ``route``: ``fn.launches`` counts
    every launch, ``fn.routes[route]`` those of the route (the fast route
    of a width and dtype, or the small-width route)."""
    fn.launches += 1
    fn.routes[route] = fn.routes.get(route, 0) + 1


def refuse_grad(name: str, hint: str, *tensors) -> None:
    """A wrapper's output is a fresh tensor filled through ctypes, cut off
    from its inputs' graph: raise where autograd would need a gradient
    through it, instead of letting that gradient go missing."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} kernel: its output would carry no gradient; {hint}")


def fp32(t):
    """``t`` as a contiguous, 16-byte aligned fp32 tensor, copied only where
    it is not one (the scan kernels read their fp32 states and vectors a
    whole row at a time); None stays None."""
    import torch
    if t is None or (t.dtype == torch.float32 and t.is_contiguous()
                     and t.data_ptr() % 16 == 0):
        return t
    return torch.empty(t.shape, dtype=torch.float32,
                       device=t.device).copy_(t)


def raw_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, without making a
    ``torch.cuda.Stream`` object (the wrappers run once a layer of every
    decode step)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME`` or PyTorch's idea of the CUDA home."""
    from torch.utils import cpp_extension

    for home in (os.environ.get("CUDA_HOME"), cpp_extension.CUDA_HOME):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "repro_torch are built from source at first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one kernel unless its library is already built."""
    out = library_path(name)
    if out.is_file():
        return None
    nvcc = nvcc_path()     # raises before any file is made
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent builder sees all or none


def build_all(names=KERNELS) -> None:
    """Compile every listed kernel, one ``nvcc`` each, all in parallel."""
    started = {n: _start(n) for n in names}
    errors = []
    for n, s in started.items():
        if s is None:
            continue
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str):
    """The C entry point ``name`` (a kernel's, or one of ``ENTRIES``),
    building its source if needed."""
    fn = _loaded.get(name)
    if fn is None:
        src, (sym, argtypes) = ENTRIES.get(name) or (name, SIGNATURES[name])
        build_all((src,))
        lib = ctypes.CDLL(str(library_path(src)))
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
