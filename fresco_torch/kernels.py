"""Build and load the hand-written CUDA kernels of ``fresco_torch/csrc``.

Each ``csrc/*.cu`` is compiled with ``nvcc`` at first use into a shared
library of its own with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/lib<source>_<hash>.so csrc/<source>.cu

All the ``nvcc`` processes are started together and waited for, so the
build takes as long as the slowest source.  No PyTorch headers are
included, so that is seconds.  A library's name carries a hash of its
source, the shared headers and the flags, so an edited source is
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
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "fresco_flash_attn_fwd": [_P] * 5 + [_I] * 5 + [_L] * 13 + [_F, _P],
    # v, c, s, B, hw, ch, lds, f32, stream
    "fresco_sign_gram_sign": [_P] * 3 + [_I] * 5 + [_P],
    # s, vt, out, B, hw, ch, lds, stream
    "fresco_sign_gram_apply_f32": [_P] * 3 + [_I] * 4 + [_P],
    # table, idx, out, n_rows, k, row_bytes, stream
    "fresco_row_gather": [_P] * 3 + [_L, _L, _L, _P],
    # src, tgt, weights, omega, nnf_in, e_in, nnf_out, e_out, deltas, tiles, mask,
    # sh, sw, th, tw, cp, patch, n_shift, shift values (host), n_rand, n_tiles, stream
    "fresco_patch_eval": [_P] * 11 + [_I] * 7 + [_P, _I, _I, _P],
    # a, x, out, B, M, N, K, a_period, stream
    "fresco_bmm": [_P] * 3 + [_I] * 5 + [_P],
}


class BuildInfo:
    """What the last ``load`` did: library paths and wall seconds of the
    parallel build (0.0 when every library was reused)."""

    paths: list[str] = []
    seconds: float = 0.0


class _Kernels:
    """The loaded libraries; attribute access finds a function in any."""

    def __init__(self, libs: list[ctypes.CDLL]):
        self._libs = libs

    def __getattr__(self, name: str):
        for lib in self._libs:
            try:
                return getattr(lib, name)
            except AttributeError:
                continue
        raise AttributeError(name)


_lib: _Kernels | None = None
build_info = BuildInfo()


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(src: str, flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def load() -> _Kernels:
    """Compile (if needed, all sources at once) and load the kernel
    libraries; idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    flags = ARCH_FLAGS + NVCC_FLAGS
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    paths = [_library_path(s, flags) for s in srcs]
    build_info.paths = paths
    t0 = time.perf_counter()
    procs = []
    for src, path in zip(srcs, paths):
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            procs.append((src, path, tmp, subprocess.Popen(
                [_nvcc(), *flags, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, path, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{os.path.basename(src)} ({p.returncode}):\n{out}")
        else:
            os.replace(tmp, path)
    build_info.seconds = time.perf_counter() - t0 if procs else 0.0
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    lib = _Kernels([ctypes.CDLL(p) for p in paths])
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


def launch_card(name: str, **tensors) -> torch.device:
    """The card a launch of ``name`` runs on: the one device that every
    tensor given (``None`` skipped) lies on, which must be a card; tensors
    on two devices raise, naming each."""
    card = None
    for t in tensors.values():
        if t is None:
            continue
        if card is None:
            card = t.device
        elif t.device != card:
            raise ValueError(f"{name}: inputs on different devices: "
                             + ", ".join(f"{n} on {u.device}" for n, u in tensors.items() if u is not None))
    if card.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on a card, the inputs lie on {card}")
    return card


def call(wrapper, entry: str, card: torch.device, *args, shape=None) -> None:
    """Launch the C entry point ``fresco_<entry>`` with ``args`` and
    ``card``'s current stream, on ``card``; raise on its return code; given
    a ``wrapper``, count the launch (``count_launch``, by ``shape`` and on
    ``card``).  The CUDA runtime launches on the calling thread's current
    device, so ``card`` is made current around the call where it is not:
    a kernel runs on its tensors' card whichever card the caller has
    current (F27)."""
    fn = getattr(load(), "fresco_" + entry)
    args = (*args, torch.cuda.current_stream(card).cuda_stream)
    if torch.cuda.current_device() == card.index:
        rc = fn(*args)
    else:
        with torch.cuda.device(card):
            rc = fn(*args)
    check(rc, entry)
    if wrapper is not None:
        count_launch(wrapper, shape, card)


_count_lock = threading.Lock()


def count_launch(wrapper, shape=None, card: torch.device | None = None) -> None:
    """Add one to ``wrapper.launches``, given ``shape`` to
    ``wrapper.launches_by_shape[shape]`` and, given ``card``, to
    ``wrapper.launches_by_card[card.index]``.  A wrapper may be called from
    any thread (propagation synthesizes on worker threads), so the count is
    taken under a lock and no launch is lost."""
    with _count_lock:
        wrapper.launches += 1
        if shape is not None:
            wrapper.launches_by_shape[shape] = wrapper.launches_by_shape.get(shape, 0) + 1
        if card is not None:
            wrapper.launches_by_card[card.index] = wrapper.launches_by_card.get(card.index, 0) + 1


def wrappers() -> dict:
    """The wrappers of the five hand-written kernels by name, each with its
    ``launches`` count; ``bmm`` is launched on the main path as the
    sign-gram pair's apply."""
    from fresco_torch.attention.flash import flash_attention
    from fresco_torch.ops.gemm import bmm
    from fresco_torch.ops.gram_kernel import sign_gram_apply
    from fresco_torch.propagate.gather import gather_rows
    from fresco_torch.propagate.patch_eval import patch_eval

    return {"flash_attn_fwd": flash_attention, "sign_gram": sign_gram_apply, "bmm": bmm,
            "row_gather": gather_rows, "patch_eval": patch_eval}


def launches() -> dict[str, int]:
    """Each kernel's launch count so far, by the names of ``wrappers``."""
    return {name: w.launches for name, w in wrappers().items()}


def launches_by_card() -> dict[str, dict[int, int]]:
    """Each kernel's launches so far by card index, by the names of ``wrappers``."""
    return {name: dict(w.launches_by_card) for name, w in wrappers().items()}


def reset_launches() -> None:
    """Set every kernel's launch count to 0, its counts by card too, and
    clear the work counts (``work_counts``)."""
    ws = wrappers()
    with _count_lock:
        for w in ws.values():
            w.launches = 0
            w.launches_by_card.clear()
        for counts in _work.values():
            counts.clear()


# calls of the layers whose work a roofline reads, by shape, counted where
# the work is decided whatever implements it: "gram" by (B, hw, c) of
# ``guidance._gram_l1_grad``, "attention" by (B, H, Sq, Sk, D) of
# ``flash.flash_attention``
_work: dict[str, dict[tuple, int]] = {"gram": {}, "attention": {}}


def count_work(layer: str, shape: tuple) -> None:
    """Add one call of ``layer`` ("gram" or "attention") at ``shape``, under
    the launch counters' lock; no device work, no read of a tensor."""
    with _count_lock:
        counts = _work[layer]
        counts[shape] = counts.get(shape, 0) + 1


def work_counts() -> dict[str, dict[tuple, int]]:
    """{"gram": {(B, hw, c): calls}, "attention": {(B, H, Sq, Sk, D): calls}}
    since the last ``reset_launches``."""
    with _count_lock:
        return {layer: dict(counts) for layer, counts in _work.items()}
