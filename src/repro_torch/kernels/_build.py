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
KERNELS = ("paged_attention", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points: every pointer and the stream are void*
SIGNATURES = {
    "paged_attention": ("paged_attention_launch",
                        [_vp, _vp, _vp, _vp, _vp, _vp,
                         _i, _i, _i, _i, _i, _i, _f, _i, _vp]),
    "flash_attention": ("flash_attention_launch",
                        [_vp, _vp, _vp, _vp,
                         _i, _i, _i, _i, _i, _i, _i, _f, _i, _i, _vp]),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}


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
    """The C entry point of kernel ``name``, building it if needed."""
    fn = _loaded.get(name)
    if fn is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        sym, argtypes = SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
