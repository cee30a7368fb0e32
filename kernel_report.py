"""The row-gather, batched-GEMM, sign-gram, patch-evaluation and factored
sign-gram kernels' report on the GPU:
what the compiler says of each kernel instantiation (registers, spills,
shared memory), which global loads and stores and which tensor-core
instructions their SASS holds, and variants of each timed in turns on the
same inputs.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 kernel_report.py [--kernel NAME]... [--parent DIR]... [--select TEXT] [--no-variants]

A variant is the source with a few strings replaced (the replacements are
listed below, and a variant whose strings are missing fails), built into a
temporary directory and called through the same C entry point; all are
built at once.  ``--parent DIR`` (repeatable) adds the csrc of another
checkout (for example an unpacked parent commit) as one more variant of
each kernel, named after the directory; ``--select`` keeps the variants
whose name holds TEXT.  Each variant is timed with CUDA events over many
launches, in the order base, variants..., base, and held against
index_select (bit for bit), the float32 product or the plain sign (flips
only at near ties), except the variants marked timing only, which leave
out part of the work on purpose.  For sign-gram a parent tree's pair (its
own sign and apply kernels, int8 S) is timed beside this tree's pair (the
sign kernel, then bmm), at the main path's five bf16 shapes.  For
patch_eval the variants run at four shapes of the interval's pyramid
under phase 7's near-tie rule; this tree's and the parents' kernels run
at every shape of the interval's and the e2e run's pyramids.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import tempfile

import torch

import chip_smoke as cs
from fresco_torch import kernels

# name -> [(old, new)] replaced in the source
GATHER_VARIANTS = {
    "table loads not kept in L1 (L1::no_allocate)": [("ld.global.nc.", "ld.global.nc.L1::no_allocate.")],
    "default output stores (st.global)": [("{ __stcs(p, v); }", "{ *p = v; }")],
    "4 rows a warp": [("constexpr int kRows = 8;", "constexpr int kRows = 4;")],
    "16 rows a warp": [("constexpr int kRows = 8;", "constexpr int kRows = 16;")],
}
_BMM_TILE = "constexpr int BN = 128, STAGES = 6;"
_BMM_LOAD = "    if (pf < nk) load_tiles<VEC>(smem + (pf % STAGES) * STAGE_BYTES, p, A, X, m0, n0, pf * BK);\n"
_BMM_COMMIT = "    cp_async_commit();  // an empty group keeps the count in step\n"
_BMM_WGMMA = "      wgmma_ss<1>(acc, "
# the first build: both tiles in the no-swizzle core-matrix layout, chunk i
# of a tile at byte 16 i (8 consecutive threads fill one core matrix, so a
# warp reads 64 bytes of each of 8 rows)
_BMM_NO_SWIZZLE = [
    ("    const int r = i / NKC, kc = i % NKC;  // a row of the tile is one 128-byte swizzle row\n"
     "    const int gm = m0 + r, gk = k0 + kc * 8;\n"
     "    auto* dst = reinterpret_cast<__nv_bfloat16*>(slot + r * 128 + ((kc ^ (r & 7)) << 4));",
     "    const int r = (i / (8 * NKC)) * 8 + i % 8, kc = (i / 8) % NKC;\n"
     "    const int gm = m0 + r, gk = k0 + kc * 8;\n"
     "    auto* dst = reinterpret_cast<__nv_bfloat16*>(slot + i * 16);"),
    ("    const int k = i / NNC, nc = i % NNC;  // atom (k / 8, nc / 8): 8 rows of 64 columns\n"
     "    const int gk = k0 + k, gn = n0 + nc * 8;\n"
     "    auto* dst = reinterpret_cast<__nv_bfloat16*>(slot + A_BYTES + ((nc >> 3) * (BK / 8) + (k >> 3)) * 1024 +\n"
     "                                                 (k & 7) * 128 + (((nc & 7) ^ (k & 7)) << 4));",
     "    const int k = (i / (8 * NNC)) * 8 + i % 8, nc = (i / 8) % NNC;\n"
     "    const int gk = k0 + k, gn = n0 + nc * 8;\n"
     "    auto* dst = reinterpret_cast<__nv_bfloat16*>(slot + A_BYTES + i * 16);"),
    ("wgmma_ss<1>(acc, wgmma_desc_sw128(a_addr + ks * 32, 16, 1024),\n"
     "                  wgmma_desc_sw128(b_addr + ks * 2 * 1024, (BK / 8) * 1024, 1024), 1);",
     "wgmma_ss<1>(acc, fresco::wgmma_desc(a_addr + ks * 256, 128, NKC * 128),\n"
     "                  fresco::wgmma_desc(b_addr + ks * 2 * (NNC * 128), NNC * 128, 128), 1);"),
]
# the same layout with the swizzled kernel's thread order: a warp reads
# whole 128-byte lines, and 8 threads write one 16-byte slot of 8 core
# matrices (an 8-way bank conflict)
_BMM_NO_SWIZZLE_LINES = [
    (_BMM_NO_SWIZZLE[0][0], _BMM_NO_SWIZZLE[0][0].split("\n")[0] + "\n"
     "    const int gm = m0 + r, gk = k0 + kc * 8;\n"
     "    auto* dst = reinterpret_cast<__nv_bfloat16*>(slot + ((r / 8) * NKC + kc) * 128 + (r % 8) * 16);"),
    (_BMM_NO_SWIZZLE[1][0], _BMM_NO_SWIZZLE[1][0].split("\n")[0] + "\n"
     "    const int gk = k0 + k, gn = n0 + nc * 8;\n"
     "    auto* dst = reinterpret_cast<__nv_bfloat16*>(slot + A_BYTES + ((k / 8) * NNC + nc) * 128 + (k % 8) * 16);"),
    _BMM_NO_SWIZZLE[2],
]
# direct float2 stores from the accumulators, then return before the staged
# epilogue
_BMM_STAGED = "  // the warpgroup's 64 x BN tile into shared memory, in the accumulator layout\n"
_BMM_DIRECT = (
    "  for (int j = 0; j < BN / 8; ++j) {\n"
    "    const int gn = n0 + 8 * j + 2 * (lane & 3);\n"
    "    for (int h = 0; h < 2; ++h) {\n"
    "      const int gm = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;\n"
    "      if (gm >= p.M || gn >= p.N) continue;\n"
    "      float* dst = O + (long long)gm * p.N + gn;\n"
    "      if (p.vec_out && gn + 1 < p.N) {\n"
    "        *reinterpret_cast<float2*>(dst) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);\n"
    "      } else {\n"
    "        dst[0] = acc[4 * j + 2 * h];\n"
    "        if (gn + 1 < p.N) dst[1] = acc[4 * j + 2 * h + 1];\n"
    "      }\n"
    "    }\n"
    "  }\n"
    "  return;\n")
_BMM_FIRST = _BMM_NO_SWIZZLE + [(_BMM_TILE, "constexpr int BN = 256, STAGES = 4;")]
_SIGN_TILE = "constexpr int BM = 128, BN = 256, BK = 64;"
_SIGN_RING = "constexpr int STAGES = 3, INFLIGHT = 0, BLOCKS_PER_SM = 1;"
_SIGN_C_LOADS = [("  if (steps > 0) load_c_of(blockIdx.x);", "  if (false) load_c_of(blockIdx.x);"),
                 ("    if (tile < tiles) load_c_of(tile);", "")]
_SIGN_STORE = "      if (gm >= p.hw || gn >= p.hw) continue;\n      __nv_bfloat16* dst"
_SIGN_REFILL = ("    if (q + AHEAD < steps) load_step((q + AHEAD) % STAGES);\n"
                "    cp_async_commit();  // an empty group keeps the count in step (the next C tile joins this group)\n")
_SIGN_WGMMA = "    const uint32_t a_addr = smem_addr + (q % STAGES) * STAGE_BYTES + wg * 64 * 128;\n"
_SIGN_GRID = "  const int grid = static_cast<int>(tiles < (long long)n_sm * BLOCKS_PER_SM ? tiles : (long long)n_sm * BLOCKS_PER_SM);"
_SIGN_NO_WGMMA = [("      wgmma_ss<0>(acc, ", "      if (false) wgmma_ss<0>(acc, ")]
_SIGN_128 = (_SIGN_TILE, "constexpr int BM = 128, BN = 128, BK = 64;")
_SIGN_TWO_BLOCKS = [_SIGN_128, (_SIGN_RING, "constexpr int STAGES = 2, INFLIGHT = 0, BLOCKS_PER_SM = 2;")]
_SIGN_REFILL_FIRST = [(_SIGN_REFILL, ""), (_SIGN_WGMMA, _SIGN_REFILL + _SIGN_WGMMA)]
# a variant whose name starts with TIMING_ONLY computes a wrong product on
# purpose (a part of the work left out) and is timed, not checked
TIMING_ONLY = "timing only: "
BMM_VARIANTS = {
    "no-swizzle layout, 128x256 (first build)": _BMM_FIRST,
    TIMING_ONLY + "first build, no refill in the loop": _BMM_FIRST + [(_BMM_LOAD, "")],
    TIMING_ONLY + "first build, no wgmma": _BMM_FIRST + [(_BMM_WGMMA, "if (false) " + _BMM_WGMMA)],
    "first build with whole-line reads": _BMM_NO_SWIZZLE_LINES + _BMM_FIRST[-1:],
    TIMING_ONLY + "no refill in the loop": [(_BMM_LOAD, "")],
    TIMING_ONLY + "no wgmma": [(_BMM_WGMMA, "if (false) " + _BMM_WGMMA)],
    "wgmma issued before the refill": [(_BMM_LOAD + _BMM_COMMIT, ""),
                                       ("    wgmma_commit();\n", "    wgmma_commit();\n" + _BMM_LOAD + _BMM_COMMIT)],
    "direct float2 stores, no staging": [(_BMM_STAGED, "#pragma unroll\n" + _BMM_DIRECT.replace(
        "    for (int h", "#pragma unroll\n    for (int h") + _BMM_STAGED)],
    "two wgmma groups in flight, 3 tiles ahead": [
        ("  for (int s = 0; s < STAGES - 2; ++s) {", "  for (int s = 0; s < STAGES - 3; ++s) {"),
        ("cp_async_wait<STAGES - 3>();", "cp_async_wait<STAGES - 4>();"),
        ("const int pf = kt + STAGES - 2;", "const int pf = kt + STAGES - 3;"),
        ("    wgmma_wait<1>();", "    wgmma_wait<2>();")],
    "128x256, 4 stages": [(_BMM_TILE, "constexpr int BN = 256, STAGES = 4;")],
    "128x128, 5 stages": [(_BMM_TILE, "constexpr int BN = 128, STAGES = 5;")],
    "128x128, 3 stages, 2 blocks a SM": [(_BMM_TILE, "constexpr int BN = 128, STAGES = 3;"),
                                         ("__launch_bounds__(NTHREADS, 1)", "__launch_bounds__(NTHREADS, 2)")],
    "192x256 (3 warpgroups), 4 stages": [("constexpr int BM = 128, BK = 64, NTHREADS = 256;",
                                          "constexpr int BM = 192, BK = 64, NTHREADS = 384;"),
                                         (_BMM_TILE, "constexpr int BN = 256, STAGES = 4;")],
}
SIGN_VARIANTS = {
    "128x128, 2 blocks a SM, 2 stages": _SIGN_TWO_BLOCKS,
    "128x128, 2 blocks a SM, 2 stages, refill before the wgmma": _SIGN_TWO_BLOCKS + _SIGN_REFILL_FIRST,
    "128x128, 1 block a SM, 5 stages, one wgmma group in flight": [
        _SIGN_128, (_SIGN_RING, "constexpr int STAGES = 5, INFLIGHT = 1, BLOCKS_PER_SM = 1;")],
    "256x128 (4 warpgroups)": [(_SIGN_TILE, "constexpr int BM = 256, BN = 128, BK = 64;")],
    "refill before the wgmma": _SIGN_REFILL_FIRST,
    "one wgmma group in flight (1 tile ahead)": [
        (_SIGN_RING, "constexpr int STAGES = 3, INFLIGHT = 1, BLOCKS_PER_SM = 1;")],
    "not persistent (one tile a block)": [(_SIGN_GRID, "  const int grid = static_cast<int>(tiles);")],
    TIMING_ONLY + "no C load": _SIGN_C_LOADS,
    TIMING_ONLY + "no C load, no S store": _SIGN_C_LOADS + [
        (_SIGN_STORE, _SIGN_STORE.replace("if (gm >= p.hw || gn >= p.hw)", "if (true)"))],
    TIMING_ONLY + "no wgmma": _SIGN_NO_WGMMA,
    TIMING_ONLY + "128x128, 2 blocks a SM, no wgmma": _SIGN_TWO_BLOCKS + _SIGN_NO_WGMMA,
}
# patch_eval: the variants of this tree's kernel
_PE_LANES = "constexpr int kLanes = 8;  // lanes evaluating one pixel's candidate"
_PE_MINB = "constexpr int kMinBlocks = 4;  // blocks a SM that __launch_bounds__ asks for"
_PE_BASE = "  const uint4* base = a.src + ((long long)(cy - L::R) * a.sw + (cx - L::R)) * L::V;\n"
_PE_MATH = ("      const float d0 = bf_lo(u) - bf_lo(word(tv, q)), d1 = bf_hi(u) - bf_hi(word(tv, q));\n"
            "      acc[2 * q] = fmaf(d0, d0, acc[2 * q]);\n"
            "      acc[2 * q + 1] = fmaf(d1, d1, acc[2 * q + 1]);\n")
_PE_BUTTERFLY = "  for (int m = 1; m < L::LANES; m <<= 1) e += __shfl_xor_sync(kFull, e, m);\n"
_PE_SHIFTS = "#pragma unroll 1\n    for (int k = 0; k < n_shift; ++k) {"
_PE_ONE_LANES = "constexpr int kLanesOne = 2;"
_PE_ONE_MINB = "constexpr int kMinBlocksOne = 8;"
PATCH_EVAL_VARIANTS = {
    "4 lanes a pixel": [(_PE_LANES, "constexpr int kLanes = 4;")],
    "3 blocks a SM asked for": [(_PE_MINB, "constexpr int kMinBlocks = 3;")],
    "5 blocks a SM asked for": [(_PE_MINB, "constexpr int kMinBlocks = 5;")],
    "shift loop unrolled by 2": [(_PE_SHIFTS, _PE_SHIFTS.replace("unroll 1", "unroll 2"))],
    "one-candidate kernel: 4 lanes a pixel": [(_PE_ONE_LANES, "constexpr int kLanesOne = 4;")],
    "one-candidate kernel: 8 lanes a pixel": [(_PE_ONE_LANES, "constexpr int kLanesOne = 8;")],
    "one-candidate kernel: 6 blocks a SM asked for": [(_PE_ONE_MINB, "constexpr int kMinBlocksOne = 6;")],
    "one-candidate kernel: 12 blocks a SM asked for": [(_PE_ONE_MINB, "constexpr int kMinBlocksOne = 12;")],
    TIMING_ONLY + "source patch fixed (top-left, no random addresses)": [
        (_PE_BASE, "  const uint4* base = a.src + (long long)((threadIdx.x / kLanes) % kTile) * L::V;\n")],
    TIMING_ONLY + "no arithmetic (xor of the loaded words)": [
        (_PE_MATH, "      acc[q] = __uint_as_float(__float_as_uint(acc[q]) ^ u ^ word(tv, q));\n")],
    TIMING_ONLY + "no target unpack": [(_PE_MATH, _PE_MATH.replace("bf_lo(word(tv, q))", "__uint_as_float(word(tv, q))")
                                       .replace("bf_hi(word(tv, q))", "__uint_as_float(word(tv, q))"))],
    TIMING_ONLY + "no source unpack": [(_PE_MATH, _PE_MATH.replace("bf_lo(u)", "__uint_as_float(u)")
                                       .replace("bf_hi(u)", "__uint_as_float(u)"))],
    TIMING_ONLY + "no butterfly": [(_PE_BUTTERFLY, "")],
}

# factored_gram: the ring's depth, and each of the two streams it overlaps alone
_FG_RING = "constexpr int STAGES = 4, AHEAD = STAGES - 1;"
_FG_IN = "    const bool in = row < n_rows && gk < ch;"
FACTORED_VARIANTS = {
    "3 stages": [(_FG_RING, "constexpr int STAGES = 3, AHEAD = STAGES - 1;")],
    TIMING_ONLY + "no loads (slots zero-filled)": [(_FG_IN, "    const bool in = false;")],
    TIMING_ONLY + "no wgmma": [("        wgmma_n64<1, 0>(acc, ", "        if (false) wgmma_n64<1, 0>(acc, "),
                               ("        wgmma_n64<-1, 0>(acc, ", "        if (false) wgmma_n64<-1, 0>(acc, "),
                               ("        wgmma_n64<1, 1>(out[a], ", "        if (false) wgmma_n64<1, 1>(out[a], ")],
}


def compile_cubin(src: str, tmp: str) -> tuple[str, str]:
    """(cubin path, ptxas's report) of one source."""
    cubin = os.path.join(tmp, os.path.basename(src) + ".cubin")
    proc = subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
                           "-cubin", "-o", cubin, src], capture_output=True, text=True)
    if proc.returncode != 0:
        cs.fail(f"nvcc -cubin {src} failed:\n{proc.stdout}\n{proc.stderr}")
    return cubin, proc.stderr


def short(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name."""
    base = re.search(r"([a-z][a-z_]*_kernel)", mangled)
    unit = re.search(r"_kernelI(5uint4|5uint2|j|t|h)", mangled)
    args = ([unit.group(1).lstrip("5")] if unit else []) + re.findall(r"L[ib](-?\d+)E", mangled)
    return f"{base.group(1) if base else mangled}<{', '.join(args)}>"


def ptxas_report(src: str, stderr: str) -> None:
    name, stack = None, ""
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, stack = short(m.group(1)), ""
        elif "bytes stack frame" in line:
            stack = line.strip()
        elif "Used" in line and name:
            print(f"ptxas {os.path.basename(src)} {name}: {line.split('Used', 1)[1].strip()}; {stack}")
            name = None
        elif "arning" in line or "erializ" in line:
            print(f"ptxas {os.path.basename(src)} {line.strip()[:300]}")


def sass_report(cubin: str) -> None:
    """Per kernel: counts of global loads / stores / async copies by width
    and of tensor-core instructions, and whether every global load of the
    table comes before the first global store."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    proc = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True)
    if proc.returncode != 0:
        cs.fail(f"cuobjdump -sass failed: {proc.stderr}")
    funcs: dict[str, list[str]] = {}
    n_instr: dict[str, int] = collections.Counter()
    cur = None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = short(m.group(1))
            funcs[cur] = []
        elif cur:
            n_instr[cur] += bool(re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line))
            op = re.search(r"\b(LDG|STG|LDGSTS|HGMMA|HMMA|LDSM|STS|LDS|WARPGROUP\.\w+|BAR\.\w+)[\w.]*", line)
            if op:
                funcs[cur].append(op.group(0))
    for name, ops in funcs.items():
        counts = collections.Counter(ops)
        loads = [i for i, o in enumerate(ops) if o.startswith("LDG")]
        stores = [i for i, o in enumerate(ops) if o.startswith("STG")]
        order = ""
        if loads and stores:
            order = f"; global loads before the first global store: {sum(i < stores[0] for i in loads)} of {len(loads)}"
        print(f"sass {name}: {n_instr[name]} instructions; " + ", ".join(f"{k} x{v}" for k, v in sorted(counts.items()))
              + order)


def variant_source(src: str, subs: list[tuple[str, str]], tmp: str, tag: str) -> str:
    """The source with `subs` applied, in a directory of its own beside
    copies of the headers; fails if a string to replace is missing."""
    text = open(src).read()
    for old, new in subs:
        if old not in text:
            cs.fail(f"variant {tag}: {old!r} is not in {src}")
        text = text.replace(old, new)
    vdir = os.path.join(tmp, tag)
    os.makedirs(vdir, exist_ok=True)
    vsrc = os.path.join(vdir, os.path.basename(src))
    with open(vsrc, "w") as f:
        f.write(text)
    for h in os.listdir(os.path.dirname(src)):  # the headers beside the source
        if h.endswith(".cuh"):
            with open(os.path.join(os.path.dirname(src), h)) as fh, open(os.path.join(vdir, h), "w") as fo:
                fo.write(fh.read())
    return vsrc


def build_all(srcs: dict[str, str], entry: str, libs_out: dict | None = None) -> dict:
    """{tag: bound C entry point}, one nvcc per source, all at once; the
    loaded libraries go into ``libs_out`` by tag, and each build's
    registers and spills are printed under its tag."""
    procs = {}
    for tag, vsrc in srcs.items():
        lib = os.path.join(os.path.dirname(vsrc), "lib.so")
        cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, vsrc]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"variant {tag} failed to build:\n{out}")
        print(f"variant {tag}:")
        ptxas_report(srcs[tag], out)
        cdll = ctypes.CDLL(lib)
        if libs_out is not None:
            libs_out[tag] = cdll
        libs[tag] = bind(cdll, entry)
    return libs


def bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    fn.argtypes = kernels._SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def timed_turns(fns: dict, iters: int) -> dict:
    """Mean ms of each callable, in the order given and then the first again."""
    names = list(fns)
    out = collections.defaultdict(list)
    for n in names + names[:1]:
        out[n].append(cs.cuda_ms(fns[n], iters=iters))
    return out


def gather_variants(libs: dict, dev, parents: dict) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    n = cs.PROP_HW[0] * cs.PROP_HW[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, dtype, w in (("vote f32 W=75", torch.float32, 75), ("probe bf16 W=384", torch.bfloat16, 384)):
        table = (torch.rand(n, w, generator=gen, device=dev) * 255).to(dtype)
        idx = torch.randint(0, n, (n,), generator=gen, device=dev, dtype=torch.int32)
        ref = torch.index_select(table, 0, idx)
        rb = w * table.element_size()
        fns = {}
        for tag, fn in libs.items():
            out = torch.empty_like(ref)

            def call(fn=fn, out=out):
                kernels.check(fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, n, rb, stream), "row_gather")

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                cs.fail(f"gather variant {tag} at {name}: not bit-equal to index_select")
            fns[tag] = call
        fns["index_select"] = lambda: torch.index_select(table, 0, idx)
        moved = cs.gather_sector_bytes(table, idx) + n * (rb + 4)
        for tag, ms in timed_turns(fns, 200).items():
            print(f"gather variant {name} {tag:44s}: " + " / ".join(f"{m:.4f}" for m in ms)
                  + f" ms ({moved / min(ms) / 1e6:.0f} GB/s of sectors moved)")


def bmm_variants(libs: dict, dev, parents: dict) -> None:
    from fresco_torch.ops import gemm
    from fresco_torch.scripts import bench_gemm as bg

    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = bg.rows(torch.Generator(device=dev).manual_seed(0), dev)
    for name, a, x in cases:
        ref = gemm.bmm_plain(a, x)
        b, m, k = a.shape
        n = x.shape[-1]
        nb = x.shape[:-2].numel()
        fns = {}
        for tag, fn in libs.items():
            out = torch.empty_like(ref)

            def call(fn=fn, out=out):
                kernels.check(fn(a.data_ptr(), x.data_ptr(), out.data_ptr(), nb, m, n, k, b, stream), "bmm")

            call()
            torch.cuda.synchronize()
            rel = ((out - ref).norm() / ref.norm()).item()
            if not (rel <= cs.GEMM_REL_FRO or tag.startswith(TIMING_ONLY)):
                cs.fail(f"bmm variant {tag} at {name}: rel fro {rel}")
            fns[tag] = call
        fns["torch.matmul bf16"] = lambda: torch.matmul(a, x)
        for tag, ms in timed_turns(fns, 20).items():
            print(f"bmm variant {name} {tag:30s}: " + " / ".join(f"{m_:.3f}" for m_ in ms)
                  + f" ms ({bg.flops(a, x) / min(ms) / 1e9:.1f} TFLOP/s)")
        del ref


def sign_variants(libs: dict, dev, parents: dict) -> None:
    """The sign kernel's variants in turns at the five bf16 shapes of phase
    3, each S held against the plain sign (a flip only where |G - C| is
    under GRAM_TIE); then this tree's pair (sign kernel + bmm) beside each
    parent's pair as its wrapper ran it (where the parent's library has
    fresco_sign_gram_apply: its sign and apply kernels, int8 S and a
    transposed copy of v)."""
    from fresco_torch.ops import gemm

    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    b = 16
    for hw, c in ((64, 1280), (256, 1280), (1024, 1280), (4096, 640), (1280, 640)):
        vr = torch.nn.functional.normalize(torch.randn(b, hw, c, generator=gen, device=dev), dim=-1)
        v = torch.nn.functional.normalize(vr + 0.3 * torch.randn(b, hw, c, generator=gen, device=dev), dim=-1)
        v = v.to(torch.bfloat16).contiguous()
        corr = torch.matmul(vr.to(torch.bfloat16), vr.to(torch.bfloat16).transpose(1, 2)).contiguous()
        d = torch.matmul(v.float(), v.float().transpose(1, 2)) - corr.float()
        fns, outs = {}, {}
        for tag, fn in libs.items():
            if tag in parents:
                continue
            s = torch.empty(b, hw, hw, dtype=torch.bfloat16, device=dev)

            def call(fn=fn, s=s):
                kernels.check(fn(v.data_ptr(), corr.data_ptr(), s.data_ptr(), b, hw, c, hw, 0, stream), "sign")

            call()
            torch.cuda.synchronize()
            far = ((s.float() != torch.sign(d)) & (d.abs() > cs.GRAM_TIE)).sum().item()
            if far and not tag.startswith(TIMING_ONLY):
                cs.fail(f"sign variant {tag} at hw={hw} c={c}: {far} signs flipped away from a tie")
            fns[tag], outs[tag] = call, s
        for tag, ms in timed_turns(fns, 20).items():
            print(f"sign variant hw={hw} c={c} {tag:50s}: " + " / ".join(f"{m_:.4f}" for m_ in ms) + " ms")
        s = outs["this tree"]
        pairs = {"this tree (sign kernel + bmm)": lambda: (fns["this tree"](), gemm.bmm(s, v))}
        for tag, lib in parents.items():
            apply = getattr(lib, "fresco_sign_gram_apply", None)
            if apply is None:  # a tree with this one's interface: its sign kernel, then bmm
                sp = torch.empty_like(s)
                pairs[f"{tag} (its pair)"] = lambda sign=libs[tag], sp=sp: (kernels.check(sign(
                    v.data_ptr(), corr.data_ptr(), sp.data_ptr(), b, hw, c, hw, 0, stream), "sign"), gemm.bmm(sp, v))
                continue
            # the int8 interface: S as int8, then its own apply kernel on a transposed copy of v
            lds = -(-hw // 16) * 16
            s8 = torch.empty(b, hw, lds, dtype=torch.int8, device=dev)
            out = torch.empty(b, hw, c, dtype=torch.float32, device=dev)
            apply.argtypes, apply.restype = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p], ctypes.c_int

            def parent_pair(sign=libs[tag], apply=apply, s8=s8, out=out, lds=lds):
                kernels.check(sign(v.data_ptr(), corr.data_ptr(), s8.data_ptr(), b, hw, c, lds, 0, stream), "sign")
                vt = torch.zeros(b, c, lds, dtype=v.dtype, device=dev)
                vt[:, :, :hw] = v.transpose(1, 2)
                kernels.check(apply(s8.data_ptr(), vt.data_ptr(), out.data_ptr(), b, hw, c, lds, 0, stream), "apply")

            pairs[f"{tag} (its pair)"] = parent_pair
        pairs["cuBLAS products, no sign"] = lambda: (torch.matmul(v, v.transpose(1, 2)), torch.matmul(s, v))
        for tag, ms in timed_turns(pairs, 10).items():
            print(f"sign pair hw={hw} c={c} {tag:40s}: " + " / ".join(f"{m_:.4f}" for m_ in ms) + " ms")
        del vr, v, corr, d, fns, outs, pairs


def factored_variants(libs: dict, dev, parents: dict) -> None:
    """The fused factored kernel's variants in turns at music's shapes
    (v̂ [16, 5120, 640] and [10, 5120, 640]) and at c = 1280, on unit rows
    (v̂ a perturbation of r): each variant that leaves the arithmetic as it
    is must give the base build's bits; beside them the plain chunked
    products (the path the kernel replaced) and the bound (4·B·hw²·c at
    the bf16 tensor peak: half of the symmetric D, then S·v̂; the kernel
    forms D whole, 6·B·hw²·c)."""
    from fresco_torch.ops import gram_kernel as gk

    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b, hw, c in ((16, 5120, 640), (10, 5120, 640), (2, 1000, 1280)):
        r = torch.nn.functional.normalize(torch.randn(b, hw, c, generator=gen, device=dev), dim=-1)
        v = torch.nn.functional.normalize(r + 0.3 * torch.randn(b, hw, c, generator=gen, device=dev), dim=-1)
        v, r = v.to(torch.bfloat16).contiguous(), r.to(torch.bfloat16).contiguous()
        fns, outs = {}, {}
        for tag, fn in libs.items():
            out = torch.empty(b, hw, c, dtype=torch.float32, device=dev)

            def call(fn=fn, out=out):
                kernels.check(fn(v.data_ptr(), r.data_ptr(), out.data_ptr(), b, hw, c, stream), "factored")

            call()
            torch.cuda.synchronize()
            if tag != "this tree" and not tag.startswith(TIMING_ONLY) and not torch.equal(out, outs["this tree"]):
                cs.fail(f"factored variant {tag} at [{b}, {hw}, {c}]: other bits than the base build")
            fns[tag], outs[tag] = call, out
        fns["plain (chunked float32 products)"] = lambda: gk.factored_sign_gram_plain(v, r)
        bnd = cs.bound(2 * v.numel() * 2 + b * hw * c * 4, 4 * b * hw * hw * c, cs.BF16_TENSOR_FLOPS)
        for tag, ms in timed_turns(fns, 10).items():
            print(f"factored [{b}, {hw}, {c}] {tag:40s}: " + " / ".join(f"{m_:.4f}" for m_ in ms)
                  + f" ms (bound {bnd[0]:.3f} ms, {bnd[1]})")
        del v, r, fns, outs


PATCH_EVAL_SHAPES = ((512, 640, 15), (128, 160, 15), (16, 20, 20), (512, 640, 1))  # where every variant runs


def patch_eval_shapes() -> list:
    """Every (height, width, candidates) the interval's 512x640 pyramid and
    the e2e run's 512x512 one launch: 20 candidates at the coarsest level,
    15 at the seeded ones, and the one-candidate set at each."""
    from fresco_torch.propagate import patchmatch as pm

    out = []
    for hw in (cs.PROP_HW, (512, 512)):
        for i, ((h, w), _) in enumerate(pm._pyramid_sizes(*hw, *hw, 5, -1)):
            out += [(h, w, 20 if i == 0 else 15), (h, w, 1)]
    return out


def patch_eval_variants(libs: dict, dev, parents: dict) -> None:
    """This tree's kernel beside each parent's at every shape of the two
    pyramids, and every variant at four of them (the finest level with 15
    candidates and with one, 128x160 and the coarsest), on phase 7's
    inputs: each held to the plain version
    under phase 7's near-tie rule (timing-only variants are not held), then
    timed in turns, queued behind a sleep (``chip_smoke.queued_ms``)."""
    from fresco_torch.propagate import patch_eval as pe

    for h, w, n in patch_eval_shapes():
        tags = list(libs) if (h, w, n) in PATCH_EVAL_SHAPES else ["this tree", *parents]
        args = cs._patch_eval_shape_args(0, dev, h, w, n)
        ref = pe.patch_eval_plain(*args)
        fns = {}
        for tag in tags:
            call = cs.patch_eval_launcher(args, 5, libs[tag])
            call()
            torch.cuda.synchronize()
            if not tag.startswith(TIMING_ONLY):
                cs._check_patch_eval(f"variant {tag} at {h}x{w} {n} cand", args, 5, call.outputs, ref)
            fns[tag] = call
        times = collections.defaultdict(list)
        for tag in tags + tags[:1]:
            times[tag].append(cs.queued_ms(fns[tag]))
        for tag, ms in times.items():
            print(f"patch_eval {h}x{w} {n} cand {tag:56s}: " + " / ".join(f"{m_:.4f}" for m_ in ms) + " ms")
        del args, ref, fns


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="another checkout whose csrc is timed beside this one (may be repeated)")
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--select", default="", help="only the variants whose name holds this string")
    ap.add_argument("--kernel", action="append", default=[],
                    choices=["row_gather", "bmm", "sign_gram", "patch_eval", "factored_gram"],
                    help="report only this kernel (may be repeated; default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this report needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        for kern, variants, entry, run in (("row_gather", GATHER_VARIANTS, "fresco_row_gather", gather_variants),
                                           ("bmm", BMM_VARIANTS, "fresco_bmm", bmm_variants),
                                           ("sign_gram", SIGN_VARIANTS, "fresco_sign_gram_sign", sign_variants),
                                           ("patch_eval", PATCH_EVAL_VARIANTS, "fresco_patch_eval",
                                            patch_eval_variants),
                                           ("factored_gram", FACTORED_VARIANTS, "fresco_factored_sign_gram",
                                            factored_variants)):
            if args.kernel and kern not in args.kernel:
                continue
            src = os.path.join(kernels.CSRC, f"{kern}.cu")
            cubin, err = compile_cubin(src, tmp)
            ptxas_report(src, err)
            sass_report(cubin)
            if args.no_variants:
                continue
            srcs = {"this tree": variant_source(src, [], tmp, f"{kern}_base")}
            parent_tags = []
            for i, tree in enumerate(args.parent):
                psrc = os.path.join(tree, "fresco_torch", "csrc", f"{kern}.cu")
                if not os.path.exists(psrc):
                    print(f"{kern}: {tree} has no {kern}.cu; skipped")
                    continue
                parent_tags.append(os.path.basename(os.path.normpath(tree)))
                srcs[parent_tags[-1]] = variant_source(psrc, [], tmp, f"{kern}_tree{i}")
            for i, (tag, subs) in enumerate(variants.items()):
                if args.select in tag:
                    srcs[tag] = variant_source(src, subs, tmp, f"{kern}_v{i}")
            cdlls: dict = {}
            libs = build_all(srcs, entry, cdlls)
            run(libs, dev, {t: cdlls[t] for t in parent_tags})


if __name__ == "__main__":
    main()
