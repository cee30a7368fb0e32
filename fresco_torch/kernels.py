"""Build and load the hand-written CUDA kernels of ``fresco_torch/csrc``.

The sources are compiled with ``nvcc`` at first use into one shared
library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/libfresco_kernels_<hash>.so csrc/*.cu

No PyTorch headers are included, so the build takes seconds.  The library
name carries a hash of the sources and flags, so an edited source is
rebuilt; the build directory ``fresco_torch/_build`` is listed in
``.gitignore``.  Nothing here runs at import time: the CPU tests import
every module of the package.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "fresco_flash_attn_fwd": [_P] * 5 + [_I] * 5 + [_L] * 13 + [ctypes.c_float, _P],
    "fresco_sign_gram_sign": [_P] * 3 + [_I] * 5 + [_P],
    "fresco_sign_gram_apply": [_P] * 3 + [_I] * 5 + [_P],
}


class BuildInfo:
    """What the last ``load`` did: library path and build seconds (0.0 when
    a built library was reused)."""

    path: str | None = None
    seconds: float = 0.0


_lib: ctypes.CDLL | None = None
build_info = BuildInfo()


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    flags = ARCH_FLAGS + NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libfresco_kernels_{h.hexdigest()[:16]}.so")
    build_info.path = path
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *flags, "-o", tmp,
               *[s for s in _sources() if s.endswith(".cu")]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_info.seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
