"""Build and bind the C++ patch-synthesis backend through ctypes.

Counterpart of ``fresco_tpu/propagate/native/binding.py``, over the port's
own copy of ``patchmatch.cpp``.  The library is compiled with ``g++`` at
first use into ``fresco_torch/_build`` (git-ignored, beside the CUDA
kernels' libraries), never beside the source:

    g++ -O3 -march=native -fopenmp -shared -fPIC -std=c++17 patchmatch.cpp
        -o fresco_torch/_build/libpatchmatch_<hash>.so

The name carries a hash of the source, the flags and the CPU that
``-march=native`` resolves to, so an edited source or another host
rebuilds it.  A failed build raises; nothing falls back to the device
backend.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "patchmatch.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None


def _native_arch() -> str:
    """The -march that ``-march=native`` resolves to on this host."""
    p = subprocess.run(["g++", "-march=native", "-###", "-E", "-"], input="", capture_output=True, text=True)
    found = re.findall(r"-march=([\w.-]+)", p.stderr)
    return found[-1] if found else "unknown"


def library_path() -> str:
    h = hashlib.sha256((" ".join(FLAGS) + " " + _native_arch()).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpatchmatch_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile the shared library if it is not built yet; returns its
    path.  Raises ``RuntimeError`` with g++'s output when the build fails."""
    with _lock:
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                p = subprocess.run(["g++", *FLAGS, SRC, "-o", tmp], capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError("the native patch-synthesis backend needs g++, which is not on PATH") from e
            if p.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SRC} ({p.returncode}):\n{p.stderr}")
            os.replace(tmp, path)
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.pm_synthesize_level.argtypes = [
            f32p, f32p, f32p, f32p, f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_uint64,
            i32p, f32p, f32p,
        ]
        lib.pm_synthesize_level.restype = None
        _lib = lib
    return _lib


def is_available() -> bool:
    """Whether the library builds and loads here (for tests that skip
    without g++ or OpenMP)."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def synthesize_level_native(
    style_src: np.ndarray,      # [sh, sw, cs] float32
    guides_src: np.ndarray,     # [sh, sw, cg]
    guides_tgt: np.ndarray,     # [th, tw, cg]
    style_weights: np.ndarray,  # [cs]
    guide_weights: np.ndarray,  # [cg]
    nnf: np.ndarray,            # [th, tw, 2] int32, modified in place
    *,
    patch: int,
    pm_iters: int,
    sv_iters: int,
    uniformity: float,
    seed: int = 0,
):
    """One pyramid level on the host: (out_style [th, tw, cs], error
    [th, tw], nnf); see patchmatch.cpp for the semantics."""
    lib = _load()
    sh, sw, cs = style_src.shape
    th, tw, cg = guides_tgt.shape
    out_style = np.zeros((th, tw, cs), np.float32)
    out_error = np.zeros((th, tw), np.float32)
    lib.pm_synthesize_level(
        np.ascontiguousarray(style_src, np.float32),
        np.ascontiguousarray(guides_src, np.float32),
        np.ascontiguousarray(guides_tgt, np.float32),
        np.ascontiguousarray(style_weights, np.float32),
        np.ascontiguousarray(guide_weights, np.float32),
        sh, sw, th, tw, cs, cg,
        patch, pm_iters, sv_iters, float(uniformity), int(seed),
        nnf, out_style, out_error,
    )
    return out_style, out_error, nnf
