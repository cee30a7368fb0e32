"""GPU smoke test of fresco_torch: kernels against their plain versions,
then one full-width keyframe batch and one full-width propagation interval
through the pipeline.

Run from the root of a checkout on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit:

    python3 chip_smoke.py [--seed N]

Phases (each prints its own lines; any failure exits non-zero):
  1. build   : nvcc-compile fresco_torch/csrc into a shared library;
  2. flash   : the flash-attention kernel against plain float32 attention
               on the same bf16 inputs, at the shapes of the main path
               (UNet/ControlNet self-attention d = 40/80/160, cross-frame
               attention over compacted ragged keys, VAE mid-block d = 512),
               each timed beside SDPA (and, at d = 40 and 512, beside each
               SDPA backend forced in turn); then the cases a tiled,
               pipelined kernel can get wrong (lengths no tile divides, the
               first / last / two adjacent key tiles masked, fewer keys than
               a tile or than the ring is deep, d = 8..256, more key tiles
               than the kernel lists at a time) and the empty batch row;
  3. gram    : the sign-gram pair (bf16: the wgmma sign kernel, then bmm
               as the apply) against the chunked plain version at the four
               decoder-stage shapes and hw = 1280 in bf16 (the main path's
               gram dtype), and at two of them in float32; the sign kernel,
               the apply and the pair timed, beside the two cuBLAS
               products alone;
  4. small   : a small-width 64 px batch (FRESCO attention on, feature
               optimization off) on the card (kernels, bf16) and on the CPU
               (plain versions, float32) with the same weights and noise,
               compared;
  5. slice   : one batch of 8 keyframes at 512x512 through
               FrescoPipeline._translate_batch and decode, at full SD1.5
               width (UNet, ControlNet, VAE, CLIP-L text) with random
               weights from a seeded torch.Generator, config_music's
               settings.  The flash, sign-gram and bmm launch counters
               must move; the sign-gram launches are printed by shape
               beside phase 3's time at each;
  6. gather  : the row-gather kernel against index_select, bit for bit:
               a table base 4 but not 16 bytes aligned, k = 1 and one more
               than a warp's rows, widths 1, 3, 27, 75, 76 (float32), 384
               (bf16) and 5 (uint8), out-of-range indices (zero rows); then
               timed at the vote's finest table (327,680 rows of 75
               float32) and the TPU probe's (bf16, 384 wide), beside the
               sector bound;
  7. patch_eval: the candidate-evaluation kernel against its plain version
               at 512x640, C = 15: 15 and 20 candidates, a ragged active
               set, patch 3; then at each coarser level of the interval's
               pyramid (256x320 down to 16x20) with its candidates, and the
               one-candidate set; the NNF may differ only at near ties;
               every case timed;
  8. propagate: a 64x80 synthesize and 11-frame interval on the card and on
               the CPU with the same draws, compared; then one interval of
               11 frames at 512x640 through blend_video_frames (default
               PatchMatchConfig, histogram blend, Poisson fusion): PSNR
               against the known truth above its floor, and both new
               kernels' launch counters must move; patch_eval's launches
               are printed by (height, width, candidates) beside phase 7's
               time at each, and their sum;
  9. gemm    : the batched-GEMM microbench (fresco_torch.scripts.bench_gemm,
               its four rows beside torch's bf16 product), then the kernel
               against its float32 plain version at those rows and at the
               edges a tiled wgmma ring can get wrong (M = 200, N = 700,
               K = 40 and 264, a_period 3 with a 4-D x, two ragged shapes,
               one with K and N not multiples of 8);
 10. aux     : GMFlow, HED and EGNet at full width, 64 px, on the card and on
               the CPU with the same float32 weights, compared; then 8
               frames at 512x512 on the card in the pipeline's dtypes
               (GMFlow float32 on bf16-rounded weights, EGNet bf16, HED
               float32), timed;
 11. e2e     : the whole keyframe stage and propagation of a 41-frame
               512x512 clip (make_inputs) at full width with config_music's
               settings: keyframe selection (intervals cut to 3..5, so 11
               keyframes in 2 batches), GMFlow flows, HED control, EGNet
               background smoothing at steps 16 and 17, the latent record
               carried, then blend_video_frames on the clip's known flows
               (GMFlow's, from random weights, are noise).  All five
               main-path kernels' launch counters must move (bmm as the
               sign-gram pair's apply); sign-gram and patch_eval launches
               are printed by shape beside their times (patch_eval's
               512x512 pyramid timed there); the keyframes
               must pass through propagation unchanged.  Phases are
               synchronized, so the breakdown is device time.
Every kernel line gives its time, its plain version's, its bound (the
larger of bytes over 3.35 TB/s and operations over the data-sheet peak;
for flash also one exp2 per logit over the special-function units' rate)
and the library call's time where one computes the same function
(patch_eval's also ``kernel_ms``, its kernel alone queued behind a
sleep, beside ``ms``, the wrapper call).  The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# flash, bf16 kernel vs float32 math on the same bf16 inputs: the kernel
# rounds P to bf16 and writes bf16.  Measured max |d| 5.2e-4 to 2.2e-3 over
# the shapes below (H100 80GB HBM3, 700 W); dropping one 64-key tile at
# S = 4096 moves the output by ~1.8e-2 at its maximum.
FLASH_ATOL = 5e-3
# and the relative Frobenius error, ||d|| / ||ref||, which a wrong tile or
# a lost row moves by far more than rounding does
FLASH_REL_FRO = 1e-2
GRAM_REL_FRO = 5e-2     # sign-gram vs plain, relative Frobenius (near-tie sign flips)
# |G - C| at any flipped sign: G is accumulated in float32 in both, so a
# flip may only come from summation order (measured <= 1.2e-6 on an H100
# 80GB HBM3 at 700 W); rounding G to bf16 before the subtraction would flip
# signs up to |G - C| ~ 4e-3.
GRAM_TIE = 1e-4
GRAM_APPLY_REL = 1e-5   # apply kernel vs S_kernel·v in float32
# small batch without the feature optimization, bf16 kernels on the card vs
# f32 plain on the CPU (bf16 rounding through 6 random-weight denoise steps
# measures 2.3e-2 between the CPU's own bf16 and f32 runs; with the feature
# optimization sign() amplifies it to ~1e-1, so that path is held by the
# gram phase and the slice's launch counters instead)
SMALL_REL_FRO = 6e-2

# H100 SXM data-sheet peaks at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> tuple[float, str]:
    """(least milliseconds for the work, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds per call, CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn) -> float:
    """cuda_ms, over 200 calls where 10 read under half a millisecond (such
    calls read up to 2x apart over 10 launches)."""
    ms = cuda_ms(fn)
    return cuda_ms(fn, iters=200) if ms < 0.5 else ms


SLEEP_CYCLES = 50_000_000  # ~25 ms of an SM's clock: longer than the host takes to queue a timed run


def queued_ms(launch, iters: int = 50) -> float:
    """Mean device milliseconds per call of ``launch`` (which must only
    enqueue work), after one warm-up call, over ``iters`` calls queued
    behind a sleeping kernel: the host has queued them all before the
    first runs, so the time is the calls' own back to back on the device
    (launch gaps included) and none of the host's.  Fails if the host
    took longer to queue them than the sleep lasted."""
    launch()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    ev[1].record()
    for _ in range(iters):
        launch()
    ev[2].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        fail(f"queued_ms: queueing took {host_ms:.2f} ms, longer than the sleep ({ev[0].elapsed_time(ev[1]):.2f})")
    return ev[1].elapsed_time(ev[2]) / iters


def plain_attention_chunked(q, k, v, mask, q_chunk: int):
    """naive_attention over batch rows and query chunks (bounded memory)."""
    from fresco_torch.attention.flash import naive_attention

    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for b in range(q.shape[0]):
        m = None if mask is None else mask[b : b + 1]
        for s in range(0, q.shape[2], q_chunk):
            out[b : b + 1, :, s : s + q_chunk] = naive_attention(
                q[b : b + 1, :, s : s + q_chunk].float(), k[b : b + 1].float(), v[b : b + 1].float(), m)
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi gives it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi --query-gpu=clocks.max.sm failed (rc {smi.returncode})")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def flash_bound(b, h, sq, n_valid, d, n_io_elems, clock_hz):
    """(least ms, "bytes" | "operations", detail) for one attention call:
    the largest of the bytes over the memory rate, the two products over
    the bf16 tensor peak, and one exp2 per logit over the special-function
    units' rate (132 SMs x 16 a clock x the maximum SM clock)."""
    logits = b * h * sq * n_valid
    t = {"bytes": 2 * n_io_elems / HBM_BYTES_PER_S * 1e3,
         "products": 4 * logits * d / BF16_TENSOR_FLOPS * 1e3,
         "exp2": logits / (132 * 16 * clock_hz) * 1e3}
    detail = max(t, key=t.get)
    return t[detail], ("bytes" if detail == "bytes" else "operations"), detail, t


def sdpa_backends(q, k, v):
    """Milliseconds of scaled_dot_product_attention with each backend forced
    in turn (None where it refuses these inputs), and of the default choice."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"default": cuda_ms(lambda: sdpa(q, k, v))}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel(backend):
                out[name] = cuda_ms(lambda: sdpa(q, k, v), iters=3 if name == "MATH" else 10)
        except RuntimeError:
            out[name] = None
    return out


def flash_edge_cases(dev):
    """(name, (B, H, Sq, Sk, d), mask or None): what a tiled, pipelined
    kernel can get wrong.  Key tiles are 64 keys (32 at d = 512)."""
    def mask(b, sk, *holes, keep_to=None):
        m = torch.ones(b, sk, dtype=torch.bool, device=dev)
        for lo, hi in holes:
            m[:, lo:hi] = False
        if keep_to is not None:
            m[:, keep_to:] = False
        return m

    cases = []
    for d in (40, 512):
        bh = (2, 8) if d == 40 else (1, 2)
        cases += [
            (f"ragged d={d}", (*bh, 4000, 4030, d) if d == 40 else (1, 1, 4000, 4030, d), None),
            (f"first tile masked d={d}", (*bh, 1000, 1000, d), mask(bh[0], 1000, (0, 64), (100, 117))),
            (f"last tiles masked d={d}", (*bh, 1000, 1000, d), mask(bh[0], 1000, keep_to=600)),
            (f"two masked tiles in a row d={d}", (*bh, 1000, 1000, d), mask(bh[0], 1000, (256, 384), (700, 701))),
            (f"Sk under one tile d={d}", (*bh, 300, 24, d), None),
            (f"Sk under the ring's depth d={d}", (*bh, 300, 100, d), mask(bh[0], 100, (3, 9))),
        ]
    m2 = mask(2, 777, (64, 192))
    m2[1] = mask(1, 777, (0, 64), keep_to=500)[0]   # a different mask per batch row
    cases += [("d=256 masked", (2, 2, 500, 777, 256), m2),
              ("d=256 ragged", (1, 2, 1100, 1030, 256), None),
              ("d=8", (2, 4, 500, 333, 8), mask(2, 333, (0, 130))),
              ("d=128", (1, 4, 700, 900, 128), mask(1, 900, (64, 128))),
              ("d=64", (1, 4, 700, 900, 64), None),
              ("d=32 long keys", (1, 1, 200, 70000, 32), mask(1, 70000, (1000, 40000)))]
    return cases


def phase_flash(gen, dev):
    from fresco_torch.attention.flash import flash_attention

    def heads(b, s, h, d):  # [B,S,H,D] memory, [B,H,S,D] view (as the model's head split)
        return torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)

    def check(name, q, k, v, mask, qc):
        out = flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = plain_attention_chunked(q, k, v, mask, qc)
        diff = out.float() - ref
        err, rel = diff.abs().max().item(), (diff.norm() / ref.norm()).item()
        if not (err <= FLASH_ATOL and rel <= FLASH_REL_FRO):
            fail(f"flash {name}: max|d| {err}, rel fro {rel}")
        return err, rel, ref.abs().max().item()

    sdpa = torch.nn.functional.scaled_dot_product_attention
    clock_hz = sm_clock_hz()
    print(f"flash bounds: exp2 rate 132 SMs x 16 a clock x {clock_hz / 1e6:.0f} MHz (nvidia-smi clocks.max.sm)")
    # cross-frame mask: compacted keys valid-first (1.5 hw of 6144 valid),
    # one fully masked 64-key tile inside the valid run, ragged tail
    sk = 6144
    cf_mask = torch.zeros(2, sk, dtype=torch.bool, device=dev)
    cf_mask[:, :5000] = True
    cf_mask[:, 1024:1088] = False
    cases = [
        ("self d=40", (16, 8, 4096, 4096, 40), None, 4096),
        ("self d=80", (16, 8, 1024, 1024, 80), None, 1024),
        ("self d=160", (16, 8, 256, 256, 160), None, 256),
        ("cross-frame d=40", (2, 8, 8 * 4096, sk, 40), cf_mask, 4096),
        ("vae d=512", (8, 1, 4096, 4096, 512), None, 4096),
    ]
    rows, max_err = {}, 0.0
    for name, (b, h, sq, skk, d), mask, qc in cases:
        q, k, v = heads(b, sq, h, d), heads(b, skk, h, d), heads(b, skk, h, d)
        err, rel, ref_max = check(name, q, k, v, mask, qc)
        ms = timed(lambda: flash_attention(q, k, v, mask))
        plain_ms = cuda_ms(lambda: plain_attention_chunked(q, k, v, mask, qc), iters=2)
        # the library call computing the same function (the masked case has
        # no empty row, so SDPA gives no NaN); timed here, never called by
        # the port
        attn_mask = None if mask is None else mask[:, None, None, :]
        lib_ms = timed(lambda: sdpa(q, k, v, attn_mask=attn_mask))
        n_valid = skk if mask is None else int(mask.sum(1).max())
        bnd_ms, bnd_by, bnd_detail, parts = flash_bound(
            b, h, sq, n_valid, d, q.numel() + k.numel() + v.numel() + q.numel(), clock_hz)
        print(f"flash {name:18s} B={b} H={h} Sq={sq} Sk={skk}: max|d|={err:.3e} (tol {FLASH_ATOL}), "
              f"max|ref|={ref_max:.3e}, rel fro {rel:.3e} (tol {FLASH_REL_FRO}), "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd_ms:.3f} ms ({bnd_detail}; "
              + ", ".join(f"{k_} {v_:.3f}" for k_, v_ in parts.items()) + f"), library (SDPA) {lib_ms:.3f} ms")
        if ms < bnd_ms:
            fail(f"flash {name}: kernel time {ms} ms reads under its bound {bnd_ms} ms")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd_ms, bound_by=bnd_by, library_ms=lib_ms,
                          bound_detail=bnd_detail)
        max_err = max(max_err, err)
        if name in ("self d=40", "vae d=512"):
            print(f"flash SDPA backends at {name} (ms; None = refused): "
                  + ", ".join(f"{k_} {'None' if v_ is None else f'{v_:.3f}'}" for k_, v_ in sdpa_backends(q, k, v).items()))
        del q, k, v
    for name, (b, h, sq, skk, d), mask in flash_edge_cases(dev):
        q, k, v = heads(b, sq, h, d), heads(b, skk, h, d), heads(b, skk, h, d)
        if skk < 128:
            # a mean of few unit-variance values is large: at |out| > 2 half a
            # bf16 step of the output alone is 3.9e-3, so keep |out| under 1
            v = v * 0.25
        err, rel, _ = check(name, q, k, v, mask, 1024)
        print(f"flash case {name:34s} B={b} H={h} Sq={sq} Sk={skk}: max|d|={err:.3e} (tol {FLASH_ATOL}), "
              f"rel fro {rel:.3e} (tol {FLASH_REL_FRO})")
        max_err = max(max_err, err)
    # a batch row with no valid key must give exact zeros
    for d in (40, 512):
        q, k, v = heads(2, 300, 8, d), heads(2, 200, 8, d), heads(2, 200, 8, d)
        m = torch.ones(2, 200, dtype=torch.bool, device=dev)
        m[1] = False
        out = flash_attention(q, k, v, m)
        torch.cuda.synchronize()
        if not bool((out[1] == 0).all()):
            fail(f"flash d={d}: a row with no valid key is not exact zeros")
        err = (out[0].float() - plain_attention_chunked(q[:1], k[:1], v[:1], m[:1], 300)[0]).abs().max().item()
        print(f"flash empty row d={d}: exact zeros, valid row max|d|={err:.3e} (tol {FLASH_ATOL})")
        if not err <= FLASH_ATOL:
            fail(f"flash empty-row case d={d}: valid row max|d| {err}")
        max_err = max(max_err, err)
    return rows, max_err


def phase_gram(gen, dev):
    """Two checks per shape: every sign the kernel's S differs from the
    plain sign on must be a near tie (|G - C| below GRAM_TIE: bf16 C
    rounding, other summation order); and the apply product must equal
    S_kernel·v in float32 (GRAM_APPLY_REL).  The relative Frobenius error
    against the plain version is bounded by GRAM_REL_FRO (a few flips move
    it ~1e-2 at hw = 64, where a row has only 64 terms).  Times: the sign
    kernel, the apply (bf16: bmm) and the pair; beside them the two cuBLAS
    products alone (v·vᵀ, then S·v, in the gram dtype, no sign), a
    yardstick and not a library call for the function."""
    from fresco_torch.ops import gram_kernel as gk

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(bf16, hw, c) for hw, c in ((64, 1280), (256, 1280), (1024, 1280), (4096, 640), (1280, 640))]
    cases += [(f32, 4096, 640), (f32, 1280, 640)]
    rows, max_err = {}, 0.0
    for dtype, hw, c in cases:
        b = 16
        vr = torch.nn.functional.normalize(torch.randn(b, hw, c, generator=gen, device=dev), dim=-1)
        v = torch.nn.functional.normalize(vr + 0.3 * torch.randn(b, hw, c, generator=gen, device=dev), dim=-1)
        v = v.to(dtype).contiguous()
        corr = torch.matmul(vr.to(dtype), vr.to(dtype).transpose(1, 2)).contiguous()
        out = gk.sign_gram_apply(v, corr)
        torch.cuda.synchronize()
        ref = gk.sign_gram_plain(v, corr)
        rel = ((out - ref).norm() / ref.norm()).item()
        err = (out - ref).abs().max().item()
        s_raw = gk.sign_matrix(v, corr)
        s_kernel = s_raw[:, :, :hw].float()
        if dtype == bf16 and not (s_raw.dtype == bf16 and s_raw.shape == (b, hw, hw)):
            fail(f"gram hw={hw} c={c}: sign_matrix gave {s_raw.dtype} {tuple(s_raw.shape)}")
        vf = v.float()
        flips, tie_max = 0, 0.0
        ref_ks = torch.empty_like(out)
        for r0 in range(0, hw, 1024):
            d = torch.matmul(vf[:, r0 : r0 + 1024], vf.transpose(1, 2)) - corr[:, r0 : r0 + 1024].float()
            flip = torch.sign(d) != s_kernel[:, r0 : r0 + 1024]
            flips += int(flip.sum())
            if flip.any():
                tie_max = max(tie_max, d[flip].abs().max().item())
            ref_ks[:, r0 : r0 + 1024] = torch.matmul(s_kernel[:, r0 : r0 + 1024], vf)
        apply_rel = ((out - ref_ks).norm() / ref_ks.norm()).item()
        sign_ms = timed(lambda: gk.sign_matrix(v, corr))
        apply_ms = timed(lambda: gk.apply_sign(s_raw, v))
        ms = timed(lambda: gk.sign_gram_apply(v, corr))
        plain_ms = cuda_ms(lambda: gk.sign_gram_plain(v, corr), iters=3)
        s_lib = s_kernel.to(dtype)
        cublas_ms = timed(lambda: (torch.matmul(v, v.transpose(1, 2)), torch.matmul(s_lib, v)))
        # two products of 2·B·hw²·c; v and C read, the f32 output written
        bnd = bound(v.numel() * v.element_size() + corr.numel() * corr.element_size() + out.numel() * 4,
                    4 * b * hw * hw * c, BF16_TENSOR_FLOPS if dtype == bf16 else F32_CUDA_CORE_FLOPS)
        print(f"gram {str(dtype)[6:]} hw={hw} c={c} B={b}: rel fro {rel:.3e} (tol {GRAM_REL_FRO}), max|d|={err:.3e}, "
              f"flipped signs {flips}/{b * hw * hw} (largest |G-C| at a flip {tie_max:.2e}, tol {GRAM_TIE}), "
              f"apply vs S_kernel.v rel {apply_rel:.2e} (tol {GRAM_APPLY_REL}), "
              f"kernel pair {ms:.3f} ms (sign {sign_ms:.3f} + apply {apply_ms:.3f}), plain {plain_ms:.3f} ms, "
              f"bound {bnd[0]:.3f} ms ({bnd[1]}), cuBLAS products, no sign {cublas_ms:.3f} ms, library none")
        if not (rel <= GRAM_REL_FRO and tie_max <= GRAM_TIE and apply_rel <= GRAM_APPLY_REL):
            fail(f"gram {dtype} hw={hw} c={c}: rel {rel}, tie {tie_max}, apply {apply_rel}")
        rows[(dtype, hw, c)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                                    sign_ms=sign_ms, apply_ms=apply_ms, cublas_products_ms=cublas_ms)
        max_err = max(max_err, err)
        del v, vf, vr, corr, out, ref, s_raw, s_kernel, s_lib, ref_ks
    return rows, max_err


def make_inputs(seed: int, n: int, res):
    """Seeded frames: smoothed-noise texture under a sub-pixel global
    translation per frame plus a moving disc; their analytic
    bidirectional flows; a Sobel edge detector.  ``res``: the frame edge,
    or (height, width)."""
    from scipy import ndimage

    h, w = (res, res) if isinstance(res, int) else res
    rng = np.random.default_rng(seed)
    pad = 48
    tex = ndimage.gaussian_filter(rng.standard_normal((h + 2 * pad, w + 2 * pad, 3)), (3, 3, 0))
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255.0
    shifts = np.cumsum(rng.uniform(-2.5, 2.5, (n, 2)), axis=0)  # (dx, dy) per frame
    shifts -= shifts[0]
    centers = np.array([w * 0.3, h * 0.5]) + np.arange(n)[:, None] * np.array([w * 0.04, h * 0.01])
    radius = min(h, w) * 0.12
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    frames, discs = [], []
    for i in range(n):
        coords = [yy + pad - shifts[i, 1], xx + pad - shifts[i, 0]]
        img = np.stack([ndimage.map_coordinates(tex[..., ch], coords, order=1) for ch in range(3)], -1)
        disc = (xx - centers[i, 0]) ** 2 + (yy - centers[i, 1]) ** 2 < radius ** 2
        img[disc] = [235.0, 60.0, 40.0] + 15.0 * np.sin(xx[disc, None] / 6.0)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        discs.append(disc)
    fwd = np.zeros((n, h, w, 2), np.float32)
    bwd = np.zeros((n, h, w, 2), np.float32)
    for i in range(n):
        j = (i + 1) % n
        fwd[i] = shifts[j] - shifts[i]
        fwd[i][discs[i]] = centers[j] - centers[i]
        bwd[i] = shifts[i] - shifts[j]
        bwd[i][discs[j]] = centers[i] - centers[j]
    flows = np.concatenate([fwd, bwd])

    def detector(img: np.ndarray) -> np.ndarray:
        g = img.astype(np.float32).mean(-1)
        mag = np.hypot(ndimage.sobel(g, 0), ndimage.sobel(g, 1))
        return np.clip(mag / (mag.max() + 1e-6) * 255.0 * 2.0, 0, 255).astype(np.uint8)

    return frames, flows, detector


def music_config(**kw):
    """config/config_music.yaml's values, in code (no yaml here)."""
    from fresco_torch.core.config import FrescoConfig

    base = dict(
        file_path="./data/music.mp4", save_path="./output/music/", mininterv=10, maxinterv=30, seed=0,
        prompt="A beautiful woman with headphones listening to music in CG cyberpunk style, "
               "neon, closed eyes, colorful",
        sd_path="stablediffusionapi/rev-animated", use_controlnet=True, controlnet_type="hed",
        cond_scale=1.0, use_freeu=False, batch_size=8, num_inference_steps=20, num_warmup_steps=3,
        end_opt_step=15, run_ebsynth=False, max_process=4,
        gmflow_path="./model/gmflow_sintel-0c07dcb3.pth", sod_path="./model/epoch_resnet.pth",
        use_saliency=True, dtype="bfloat16", gram_dtype="bfloat16", cf_key_cap="auto")
    base.update(kw)
    return FrescoConfig(**base)


def prompts_for(cfg, n):
    from fresco_torch.core.config import default_prompts

    a_prompt, n_prompt = default_prompts(cfg.sd_path)
    return [cfg.prompt + a_prompt] * n, [n_prompt] * n


def phase_small(seed: int, dev):
    """Small widths at 64 px: the card's bf16 kernel path against the CPU's
    float32 plain path with the same (bf16-representable) weights and noise."""
    from fresco_torch.diffusion.scheduler import DDPMScheduler
    from fresco_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from fresco_torch.models.controlnet import ControlNet
    from fresco_torch.models.layers import cast_model, init_flax_default_
    from fresco_torch.models.unet import UNet2DCondition, UNetConfig
    from fresco_torch.models.vae import AutoencoderKL, VAEConfig
    from fresco_torch.pipeline.runner import FrescoPipeline, ModelBundle
    from fresco_torch.pipeline.text import HashTokenizer

    n, res = 4, 64
    cfg = music_config(resolution=res, batch_size=n, num_inference_steps=8, num_warmup_steps=2,
                       use_fresco_opt=False, use_saliency=False)
    ccfg = CLIPTextConfig.tiny()
    ucfg = UNetConfig(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=ccfg.hidden_size,
                      attention_heads=4, norm_groups=8, fresco_up_blocks=(1,))
    gen = torch.Generator().manual_seed(seed)
    mods = [UNet2DCondition(ucfg), AutoencoderKL(VAEConfig(block_out_channels=(32, 32, 64, 64), layers_per_block=1, norm_groups=8)),
            ControlNet(ucfg, (16, 16, 32, 32)), CLIPTextEncoder(ccfg)]
    for m in mods:
        init_flax_default_(m, gen)
        cast_model(m, torch.bfloat16)  # round once, so both sides hold the same values
        cast_model(m, torch.float32)
    frames, flows, detector = make_inputs(seed, n, res)
    prompts, negs = prompts_for(cfg, n)
    lshape = (n, res // 8, res // 8, 4)
    noise = dict(intra_noise=torch.randn(lshape, generator=gen), intra_enc_noise=torch.randn(lshape, generator=gen),
                 init_noise=torch.randn(lshape, generator=gen), enc_noise=torch.randn(lshape, generator=gen),
                 step_noise=torch.randn((6, *lshape), generator=gen))
    out = []
    for device, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        ms = [cast_model(copy.deepcopy(m).to(device), dtype if i < 3 else torch.float32).eval()
              for i, m in enumerate(mods)]
        bundle = ModelBundle(ms[0], ms[1], ms[2], ms[3], DDPMScheduler(num_inference_steps=8),
                             HashTokenizer(ccfg.vocab_size), detector, device,
                             flow_fn=lambda a, b, d=device: torch.from_numpy(flows).to(d))
        pipe = FrescoPipeline(cfg.replace(dtype="bfloat16" if dtype == torch.bfloat16 else "float32",
                                          gram_dtype="bfloat16" if dtype == torch.bfloat16 else "float32"),
                              bundle)
        lat, _ = pipe._translate_batch(frames, prompts, negs, None, False,
                                       {k: v.to(device) for k, v in noise.items()})
        out.append(pipe.sampler.decode(lat).float().cpu())
    rel = ((out[0] - out[1]).norm() / out[1].norm()).item()
    print(f"small batch (64 px, 4 frames, widths 32/64): card bf16 kernels vs CPU f32 plain: "
          f"decoded rel fro {rel:.3e} (tol {SMALL_REL_FRO})")
    if not (math.isfinite(rel) and rel <= SMALL_REL_FRO):
        fail(f"small batch: relative error {rel} > {SMALL_REL_FRO}")


def sign_gram_by_shape(label: str, gram_rows) -> None:
    """The sign-gram launches of the last run by (hw, c), each beside the
    pair's phase-3 time at that shape (B = 16) and their product."""
    from fresco_torch.ops.gram_kernel import sign_gram_apply

    parts, total = [], 0.0
    for (hw, c), n in sorted(sign_gram_apply.launches_by_shape.items()):
        r = (gram_rows or {}).get((torch.bfloat16, hw, c))
        if r is None:
            parts.append(f"hw={hw} c={c}: {n} launches (no phase-3 time at this shape)")
            continue
        total += n * r["ms"]
        parts.append(f"hw={hw} c={c}: {n} launches x {r['ms']:.3f} ms (sign {r['sign_ms']:.3f} + apply "
                     f"{r['apply_ms']:.3f}) = {n * r['ms'] / 1e3:.3f} s")
    print(f"{label} sign-gram by shape: " + "; ".join(parts) + f"; total {total / 1e3:.3f} s of phase-3 kernel time")


def phase_slice(seed: int, dev, gram_rows=None):
    from fresco_torch.attention.flash import flash_attention
    from fresco_torch.ops.gemm import bmm
    from fresco_torch.ops.gram_kernel import sign_gram_apply
    from fresco_torch.pipeline.runner import FrescoPipeline, build_models
    from fresco_torch.utils.guards import check_finite

    n, res = 8, 512
    cfg = music_config()
    t0 = time.perf_counter()
    bundle = build_models(cfg, seed=seed, device=dev)
    frames, flows, detector = make_inputs(seed, n, res)
    flows_t = torch.from_numpy(flows).to(dev)
    bundle.flow_fn = lambda a, b: flows_t
    bundle.detector = detector
    pipe = FrescoPipeline(cfg, bundle)
    pipe.sync_phases = True
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (bundle.unet, bundle.controlnet, bundle.vae, bundle.text_encoder)
                   for p in m.parameters())
    print(f"slice: built models ({n_params / 1e6:.1f} M params) in {time.perf_counter() - t0:.1f} s")
    prompts, negs = prompts_for(cfg, n)

    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention.launches = 0
    sign_gram_apply.launches = 0
    sign_gram_apply.launches_by_shape.clear()
    bmm.launches = 0
    t0 = time.perf_counter()
    latents, record = pipe._translate_batch(frames, prompts, negs, None, False)
    images = pipe.decode(latents)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attn_fwd": flash_attention.launches, "sign_gram": sign_gram_apply.launches,
                "bmm": bmm.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30

    ph = pipe.phases.times
    names = [("prompts", "encode_prompts"), ("interframe prep", "interframe_prep"),
             ("intraframe prep", "intraframe_prep"), ("attention params", "attn_params"),
             ("denoise loop", "denoise_loop"), ("decode", "vae_decode"),
             ("upload", "upload_frames"), ("control detector", "control_detector")]
    print("slice phases (s, synchronized): " + ", ".join(f"{a} {ph.get(b, 0.0):.3f}" for a, b in names))
    print(f"slice: {n} keyframes {res}x{res}, {cfg.num_inference_steps} steps, wall {wall:.2f} s, "
          f"peak device memory {peak_gb:.2f} GiB, launches {launches}")
    sign_gram_by_shape("slice", gram_rows)
    check_finite("slice_latents", latents)
    print(f"slice: latents finite, shape {tuple(latents.shape)}, |max| {latents.abs().max().item():.3f}; "
          f"record {tuple(record.shape)}; output {images.shape} {images.dtype}")
    if images.shape != (n, res, res, 3) or images.dtype != np.uint8:
        fail(f"slice output {images.shape} {images.dtype}")
    if min(launches.values()) <= 0:
        fail(f"slice did not launch every kernel: {launches}")
    return launches


# ---------------------------------------------------------------- propagation
PROP_HW = (512, 640)     # the propagation slice's full width: a 512x640 video
PE_REL = 1e-5            # patch evaluation: |de| / e where the argmin agrees; a near tie
PE_MIN_AGREE = 0.999     # NNF entries on which kernel and plain keep the same match


def style_of(frames: np.ndarray) -> np.ndarray:
    """The 'stylization' of the propagation phases: a fixed per-pixel colour
    transform (inverted, channels reversed), so the truth of every frame is
    known."""
    return np.ascontiguousarray(255 - frames[..., ::-1])


def pair_flow_fn(frames, flows, dev):
    """flow_fn over the frames of ``make_inputs``: each frame is told apart
    by its pixel sum, and the pair's forward/backward flows are looked up
    (consecutive frames, either direction)."""
    n = len(frames)
    index = {int(f.astype(np.int64).sum()): i for i, f in enumerate(frames)}
    if len(index) != n:
        fail("propagate: frames are not told apart by their sums")
    flows_d = torch.from_numpy(flows).to(dev)

    def flow_fn(a, b):
        ids = [[index[int(round(x))] for x in t.reshape(t.shape[0], -1).double().sum(1).tolist()] for t in (a, b)]
        fwd, bwd = [], []
        for i, k in zip(*ids):
            if k == i + 1:
                fwd.append(flows_d[i])
                bwd.append(flows_d[n + i])
            elif k == i - 1:
                fwd.append(flows_d[n + k])
                bwd.append(flows_d[k])
            else:
                fail(f"propagate: flow of a non-adjacent pair ({i}, {k})")
        return torch.stack(fwd + bwd)

    return flow_fn


GATHER_ROWS_A_WARP = 8  # csrc/row_gather.cu kRows


def gather_sector_bytes(table: torch.Tensor, idx: torch.Tensor) -> int:
    """Bytes of the 32-byte sectors that the rows table[idx] touch, from
    this run's table address and indices."""
    rb = table.shape[1] * table.element_size()
    start = table.data_ptr() + idx.long() * rb
    return int(((start + rb - 1) // 32 - start // 32 + 1).sum()) * 32


def gather_cases(gen, dev):
    """(name, table, idx): what a kernel that deals several rows to a warp
    and picks its unit from the alignment can get wrong."""
    f32, bf16 = torch.float32, torch.bfloat16
    n, k = 1000, 777

    def tab(w, dtype):
        return (torch.rand(n, w, generator=gen, device=dev) * 200).to(dtype)

    def ix(kk):
        return torch.randint(0, n, (kk,), generator=gen, device=dev, dtype=torch.int32)

    flat = torch.rand(n * 75 + 4, generator=gen, device=dev)
    oob = ix(k)
    oob[::5], oob[1::7], oob[-1] = -1, n, -(2**31)
    return [("f32 W=75 table base 4 mod 16", flat[1 : 1 + n * 75].view(n, 75), ix(k)),
            ("f32 W=75 k=1", tab(75, f32), ix(1)),
            (f"f32 W=75 k={GATHER_ROWS_A_WARP + 1}", tab(75, f32), ix(GATHER_ROWS_A_WARP + 1)),
            (f"bf16 W=384 k={GATHER_ROWS_A_WARP + 1}", tab(384, bf16), ix(GATHER_ROWS_A_WARP + 1)),
            ("f32 W=27", tab(27, f32), ix(k)),
            ("f32 W=1", tab(1, f32), ix(k)),
            ("f32 W=3", tab(3, f32), ix(k)),
            ("f32 W=76", tab(76, f32), ix(k)),
            ("uint8 W=5", tab(5, torch.uint8), ix(k)),
            ("f32 W=75 out-of-range indices", tab(75, f32), oob),
            ("bf16 W=384 out-of-range indices", tab(384, bf16), oob.clone())]


def gather_reference(table, idx):
    """index_select on the indices inside [0, N); zero rows elsewhere."""
    ok = (idx >= 0) & (idx < table.shape[0])
    ref = torch.zeros((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    ref[ok] = torch.index_select(table, 0, idx[ok])
    return ref


def phase_gather(gen, dev):
    """The row-gather kernel against index_select (its plain version and the
    library call), bit for bit: the edge cases of ``gather_cases``, then the
    vote's finest-level table and the TPU probe's, timed."""
    from fresco_torch.propagate.gather import gather_rows, gather_rows_plain

    for name, table, idx in gather_cases(gen, dev):
        out = gather_rows(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(out, gather_reference(table, idx)):
            fail(f"gather case {name}: not bit-equal to index_select")
        print(f"gather case {name:34s} N={table.shape[0]} K={idx.shape[0]} base mod 16 = "
              f"{table.data_ptr() % 16}: bit-equal")
    rows = {}
    n = PROP_HW[0] * PROP_HW[1]
    for name, dtype, w in (("vote f32 W=75", torch.float32, 75), ("probe bf16 W=384", torch.bfloat16, 384)):
        table = (torch.rand(n, w, generator=gen, device=dev) * 255).to(dtype)
        idx = torch.randint(0, n, (n,), generator=gen, device=dev, dtype=torch.int32)
        out = gather_rows(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(out, gather_rows_plain(table, idx)):
            fail(f"gather {name}: not bit-equal to index_select")
        ms = cuda_ms(lambda: gather_rows(table, idx), iters=100)
        plain_ms = cuda_ms(lambda: gather_rows_plain(table, idx), iters=100)
        rb = w * table.element_size()
        # the bound: the sectors the random rows touch, each row written, each
        # index read; beside it the rows' bytes alone (2·row + 4 a row)
        moved = gather_sector_bytes(table, idx) + n * (rb + 4)
        bnd = bound(moved, 0, 1.0)
        flat_bnd = bound(n * (2 * rb + 4), 0, 1.0)
        print(f"gather {name}: {n} rows of {rb} B, random rows, bit-equal; kernel {ms:.4f} ms "
              f"({moved / ms / 1e6:.0f} GB/s of sectors moved), plain = library (index_select) {plain_ms:.4f} ms; "
              f"bound {bnd[0]:.4f} ms (bytes: {moved / n:.1f} B a row, the sectors the rows touch + row + index; "
              f"the bound), rows' bytes alone {flat_bnd[0]:.4f} ms")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=plain_ms)
        del table, idx, out
    return rows


def _patch_inputs(seed: int, dev, hw, seeded: bool):
    """One PatchMatch iteration's inputs at a level of ``hw``: the source
    [key style | frame | edge | key | positional] of frame 0 and the target
    stack of frame 1 (the propagation stage's 15 channels), an NNF (the
    identity plus small offsets at a seeded level, uniform at an unseeded
    one) and its omega term."""
    from fresco_torch.propagate import patchmatch as pm
    from fresco_torch.propagate.guides import edge_guide, positional_first
    from fresco_torch.propagate.video_blend import _guide_weights

    h, w = hw
    frames, _, _ = make_inputs(seed, 2, hw)
    f = [torch.from_numpy(x).to(dev) for x in frames]
    st = [torch.from_numpy(style_of(x)).to(dev) for x in frames]
    pos = positional_first(h, w, dev)
    src = torch.cat([st[0], f[0], edge_guide(f[0]), st[0], pos], -1).to(torch.bfloat16).contiguous()
    tgt = torch.cat([st[1], f[1], edge_guide(f[1]), st[1], pos], -1).to(torch.bfloat16).contiguous()
    weights = torch.cat([torch.full((3,), 1 / 3, device=dev), _guide_weights(dev)])
    g = torch.Generator(device=dev).manual_seed(seed)
    if seeded:
        yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
        jit = torch.randint(-2, 3, (2, h, w), generator=g, device=dev)
        nnf = torch.stack([(yy + jit[0]).clamp(0, h - 1), (xx + jit[1]).clamp(0, w - 1)], -1)
    else:
        nnf = torch.stack([torch.randint(2, h - 2, (h, w), generator=g, device=dev),
                           torch.randint(2, w - 2, (h, w), generator=g, device=dev)], -1)
    nnf = nnf.to(torch.int32).contiguous()
    omega = ((3500.0 / 25.0) * pm._omega(nnf[..., 0], nnf[..., 1], h, w, 5)).to(torch.bfloat16)
    return src, tgt, weights, omega, nnf, g


def _check_patch_eval(name, args, patch, out, ref):
    """Near-tie rule: the NNF agrees on PE_MIN_AGREE of the pixels, the
    errors agree to PE_REL where it does, and every other pixel's match is
    one the plain arithmetic reaches when near-tie comparisons go either
    way (``near_tie_matches``).  Returns the largest |de| seen."""
    from fresco_torch.propagate.patch_eval import near_tie_matches, patch_eval_plain

    src, tgt, weights, omega = args[:4]
    (kn, ke), (pn, pe) = out, ref
    same = (kn == pn).all(-1)
    agree = same.float().mean().item()
    if agree < PE_MIN_AGREE:
        fail(f"patch_eval {name}: NNF agreement {agree} < {PE_MIN_AGREE}")
    fin = same & torch.isfinite(pe)
    rel_same = ((ke - pe).abs() / pe.abs().clamp_min(1e-30))[fin].max().item() if bool(fin.any()) else 0.0
    max_err = (ke - pe).abs()[fin].max().item() if bool(fin.any()) else 0.0
    tie_abs, unexplained = 0.0, []
    if not bool(same.all()):
        _, e_k = patch_eval_plain(src, tgt, weights, omega, kn, None, patch=patch)
        tie_abs = (e_k - pe).abs()[~same].max().item()
        for y, x in torch.nonzero(~same).tolist():
            reach = near_tie_matches(*args[:8], y, x, patch=patch, rel=PE_REL)
            if tuple(kn[y, x].tolist()) not in reach:
                unexplained.append((y, x))
    print(f"patch_eval {name}: NNF agreement {agree:.6f} (min {PE_MIN_AGREE}), max rel |de| where the argmin "
          f"agrees {rel_same:.2e} (tol {PE_REL}); {int((~same).sum())} disagreements, largest |de| at one "
          f"{tie_abs:.3e}, {len(unexplained)} not reached through a near tie (tol {PE_REL})")
    if not (rel_same <= PE_REL and not unexplained):
        fail(f"patch_eval {name}: rel {rel_same}, unexplained disagreements {unexplained[:5]}")
    return max_err


def _patch_eval_case(seed: int, dev, hw, seeded: bool, shifts, radii, patch: int = 5, compact: bool = False):
    """One case's inputs: ``_patch_inputs`` plus the random deltas of
    ``radii`` and, with ``compact``, a ragged active set; returns (src, tgt,
    weights, omega, nnf, deltas, act, mask, n_pix)."""
    from fresco_torch.propagate.patch_eval import active_set

    h, w = hw
    src, tgt, weights, omega, nnf, g = _patch_inputs(seed, dev, hw, seeded)
    if patch == 3:
        omega = None
    deltas = None
    if radii:
        deltas = torch.stack([torch.randint(-r, r + 1, (h, w, 2), generator=g, device=dev, dtype=torch.int32)
                              for r in radii])
    act, mask, n_pix = None, None, h * w
    if compact:
        blobs = torch.rand(h // 16, w // 16, generator=g, device=dev) > 0.9
        blobs[0, 1] = True
        mask = torch.nn.functional.interpolate(blobs[None, None].float(), size=(h, w))[0, 0] > 0
        mask &= torch.rand(h, w, generator=g, device=dev) > 0.3
        act, n_pix = active_set(mask), int(mask.sum())
    return src, tgt, weights, omega, nnf, deltas, act, mask, n_pix


def _patch_eval_shape_args(seed: int, dev, h: int, w: int, n_cand: int):
    """The arguments of a main-path call at (h, w, n_cand) (the one-candidate
    set, 15 or 20 candidates) on a full grid, the NNF and errors of 15 or
    20 candidates being the one-candidate call's, as in phase 7; None for
    another count."""
    from fresco_torch.propagate.patch_eval import patch_eval
    from fresco_torch.propagate.patchmatch import level_candidates

    if n_cand not in (1, 15, 20):
        return None
    seeded = n_cand != 20
    shifts, radii = level_candidates(h, w, seeded) if n_cand > 1 else ((), [])
    src, tgt, weights, omega, nnf, deltas, *_ = _patch_eval_case(seed, dev, (h, w), seeded, shifts, radii)
    if n_cand == 1:
        return (src, tgt, weights, omega, nnf, None, (), None, None)
    nnf0, e0 = patch_eval(src, tgt, weights, omega, nnf)
    return (src, tgt, weights, omega, nnf0, e0, shifts, deltas, None)


def patch_eval_launcher(args, patch: int = 5, fn=None):
    """A call that launches the patch_eval kernel alone (``fn``, default
    this tree's C entry point) on ``patch_eval``'s arguments ``args``, laid
    out once; its outputs are ``.outputs``."""
    from fresco_torch import kernels
    from fresco_torch.propagate.patch_eval import _kernel_args

    c_args, nnf_out, e_out, _, keep = _kernel_args(*args, patch=patch)
    fn = fn or kernels.load().fresco_patch_eval

    def launch():
        kernels.check(fn(*c_args), "patch_eval")

    launch.outputs, launch.keep = (nnf_out, e_out), keep
    return launch


def patch_eval_by_shape(label: str, counts: dict, shape_ms: dict, seed: int, dev) -> None:
    """Print the patch_eval launches of a run by (th, tw, candidates), each
    beside the wrapper call's and the kernel's time at that shape (phase
    7's, else timed here on a full-grid call of that shape), the products
    and their sums.  A compacted launch runs only its listed tiles, so a
    sum is the run's time with every launch over its whole grid
    (profile_propagate.py measures the interval's own)."""
    from fresco_torch.propagate.patch_eval import patch_eval

    parts, total_call, total_kernel = [], 0.0, 0.0
    for (h, w, n), k in sorted(counts.items()):
        where = "phase 7"
        if (h, w, n) not in shape_ms:
            args = _patch_eval_shape_args(seed, dev, h, w, n)
            if args is None:
                parts.append(f"{h}x{w} {n} cand: {k} launches (no time at this shape)")
                continue
            shape_ms[(h, w, n)] = (timed(lambda: patch_eval(*args)), queued_ms(patch_eval_launcher(args)))
            where = "timed here"
        call_ms, kernel_ms = shape_ms[(h, w, n)]
        total_call += k * call_ms
        total_kernel += k * kernel_ms
        parts.append(f"{h}x{w} {n} cand: {k} x {call_ms:.4f} ms a call / {kernel_ms:.4f} ms the kernel ({where})"
                     f" = {k * call_ms:.1f} / {k * kernel_ms:.1f} ms")
    print(f"{label} patch_eval by shape: " + "; ".join(parts)
          + f"; total {total_call:.1f} ms of wrapper calls, {total_kernel:.1f} ms of kernel time "
          f"({sum(counts.values())} launches, each at its full-grid time)")


def phase_patch_eval(seed: int, dev):
    """The candidate-evaluation kernel against its plain version at the
    finest level (512x640, C = 15): 15 candidates at a seeded level (shifts
    1,2,4 and 3 random), 20 at an unseeded one (shifts 1,2,4,8 and 4
    random); a ragged active set (compaction); patch 3 without omega; then
    each coarser level of the interval's pyramid with the candidates
    ``_synthesize_level`` runs there, and the one-candidate set (the current
    match's error) at 512x640.  Each case's ``ms`` is the wrapper call
    (``timed``, as every kernel's row), ``kernel_ms`` the kernel alone
    queued behind a sleep (``queued_ms``: none of the wrapper's layout work
    and none of the host's time).  Returns the kernel table rows by name,
    the largest |de| and (wrapper ms, kernel ms) by (h, w, candidates)."""
    from fresco_torch.propagate import patchmatch as pm
    from fresco_torch.propagate.patch_eval import patch_eval, patch_eval_plain

    rows, shape_ms, max_err = {}, {}, 0.0
    cases = [("seeded 15 cand", PROP_HW, True, (1, 2, 4), [160, 80, 40], 5, False),
             ("unseeded 20 cand", PROP_HW, False, (1, 2, 4, 8), [320, 160, 80, 40], 5, False),
             ("compact ragged 15 cand", PROP_HW, True, (1, 2, 4), [160, 80, 40], 5, True),
             ("patch 3 15 cand", PROP_HW, True, (1, 2, 4), [160, 80, 40], 3, False)]
    levels = [t for t, _ in pm._pyramid_sizes(*PROP_HW, *PROP_HW, 5, -1)]  # coarse -> fine
    for i, (h, w) in enumerate(levels[:-1][::-1]):
        seeded = i < len(levels) - 2
        shifts, radii = pm.level_candidates(h, w, seeded)
        cases.append((f"level {h}x{w} {4 * len(shifts) + len(radii)} cand", (h, w), seeded, shifts, radii, 5, False))
    cases.append(("one candidate", PROP_HW, True, (), [], 5, False))
    for name, (h, w), seeded, shifts, radii, patch, compact in cases:
        src, tgt, weights, omega, nnf, deltas, act, mask, n_pix = _patch_eval_case(
            seed, dev, (h, w), seeded, shifts, radii, patch, compact)
        # the one-candidate set first: the current match's error (be0)
        be0_args = (src, tgt, weights, omega, nnf, None, (), None, act)
        out0 = patch_eval(*be0_args, patch=patch)
        torch.cuda.synchronize()
        max_err = max(max_err, _check_patch_eval(name + " (be0)", be0_args, patch, out0,
                                                 patch_eval_plain(*be0_args, patch=patch)))
        args = be0_args
        if shifts:
            args = (src, tgt, weights, omega, out0[0], out0[1], shifts, deltas, act)
            out = patch_eval(*args, patch=patch)
            torch.cuda.synchronize()
            ref = patch_eval_plain(*args, patch=patch)
            max_err = max(max_err, _check_patch_eval(name, args, patch, out, ref))
            if compact and not (torch.equal(out[0][~mask], out0[0][~mask])
                                and torch.equal(out[1][~mask], out0[1][~mask])):
                fail("patch_eval compact: a frozen pixel changed")
        n_cand = max(4 * len(shifts) + len(radii), 1)
        ms = timed(lambda: patch_eval(*args, patch=patch))
        call_queued_ms = queued_ms(lambda: patch_eval(*args, patch=patch), iters=20)
        kernel_ms = queued_ms(patch_eval_launcher(args, patch))
        plain_ms = cuda_ms(lambda: patch_eval_plain(*args, patch=patch), iters=2)
        c = src.shape[-1]
        n_bytes = (src.numel() + tgt.numel()) * 2 + (0 if omega is None else omega.numel() * 2) \
            + h * w * (8 + (4 if shifts else 0)) + (0 if deltas is None else deltas.numel() * 4) + n_pix * (8 + 4)
        bnd = bound(n_bytes, n_pix * n_cand * patch * patch * c * 4, F32_CUDA_CORE_FLOPS)
        ns_k, ns_p = ms * 1e6 / (n_pix * n_cand), plain_ms * 1e6 / (n_pix * n_cand)
        print(f"patch_eval {name}: {h}x{w}, {n_pix} pixels x {n_cand} candidates, kernel {ms:.4f} ms a wrapper "
              f"call ({ns_k:.4f} ns per candidate; its device work queued {call_queued_ms:.4f} ms, the kernel "
              f"alone queued {kernel_ms:.4f} ms), plain {plain_ms:.3f} ms ({ns_p:.3f} ns), bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), library none")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                          kernel_ms=kernel_ms)
        if patch == 5 and not compact:
            shape_ms.setdefault((h, w, n_cand), (ms, kernel_ms))
    return rows, max_err, shape_ms


def _psnr(out: dict, truth: list, idx) -> float:
    mse = np.mean([np.mean((out[i].astype(np.float64) - truth[i]) ** 2) for i in idx])
    return float(10 * np.log10(255.0 ** 2 / mse))


# first reading 37.273 dB (H100 80GB HBM3, 700 W; the run is deterministic:
# seeded draws, integer omega counts); a lost candidate set or a broken blend
# costs several dB
PROP_PSNR_FLOOR = 36.0


def phase_propagate(seed: int, dev, pe_shape_ms: dict):
    """One interval of 11 frames (keys 0 and 10) at 512x640 through the
    port's in-memory blend_video_frames, default PatchMatchConfig,
    histogram blend and Poisson fusion; patch_eval's launches by shape
    beside phase 7's times."""
    from fresco_torch.propagate.gather import gather_rows
    from fresco_torch.propagate.patch_eval import patch_eval
    from fresco_torch.propagate.video_blend import blend_video_frames

    n = 11
    frames, flows, _ = make_inputs(seed, n, PROP_HW)
    truth = [style_of(f) for f in frames]
    flow_fn = pair_flow_fn(frames, flows, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gather_rows.launches = 0
    patch_eval.launches = 0
    patch_eval.launches_by_shape.clear()
    tm: dict = {}
    t0 = time.perf_counter()
    out = blend_video_frames(dict(enumerate(frames)), {0: truth[0], n - 1: truth[n - 1]}, [0, n - 1],
                             flow_fn=flow_fn, device=dev, timers_out=tm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"row_gather": gather_rows.launches, "patch_eval": patch_eval.launches}
    pe_counts = dict(patch_eval.launches_by_shape)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    psnr = _psnr(out, truth, range(1, n - 1))
    print("propagate phases (s, host wall, overlapping): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(tm.items(), key=lambda kv: -kv[1])))
    print(f"propagate: {n} frames {PROP_HW[0]}x{PROP_HW[1]}, 1 interval, wall {wall:.2f} s, peak device memory "
          f"{peak_gb:.2f} GiB, launches {launches}, PSNR vs truth {psnr:.3f} dB (floor {PROP_PSNR_FLOOR})")
    patch_eval_by_shape("propagate", pe_counts, pe_shape_ms, seed, dev)
    if sorted(out) != list(range(n)) or any(out[i].shape != (*PROP_HW, 3) or out[i].dtype != np.uint8 for i in out):
        fail("propagate: wrong frames out")
    if not (np.array_equal(out[0], truth[0]) and np.array_equal(out[n - 1], truth[n - 1])):
        fail("propagate: a keyframe did not pass through unchanged")
    if not psnr >= PROP_PSNR_FLOOR:
        fail(f"propagate: PSNR {psnr} below {PROP_PSNR_FLOOR}")
    if min(launches.values()) <= 0:
        fail(f"propagate did not launch every kernel: {launches}")
    return launches


# 64x80, card vs CPU with the same draws: first reading (H100 80GB HBM3,
# 700 W) NNF agreement 1.0 and mean |d| 0.0152 levels; a near tie decided
# the other way changes the
# random-search path after it, and its chain from there on
SMALL_PROP_AGREE = 0.99     # NNF agreement, one synthesize
SMALL_PROP_MEAN_ABS = 0.5   # mean |d| of the blended interval, uint8 levels


def phase_small_propagate(seed: int, dev):
    """64x80: one synthesize and one 11-frame interval on the card (kernels)
    and on the CPU (plain versions) with the same draws (made on the CPU)."""
    from fresco_torch.propagate.patchmatch import PatchMatchConfig, TorchDraws, synthesize
    from fresco_torch.propagate.video_blend import blend_video_frames

    hw, n = (64, 80), 11
    src, tgt, weights, _, _, _ = _patch_inputs(seed, dev, hw, True)
    nnfs = []
    for d in (dev, torch.device("cpu")):
        s, t = src.to(d).float(), tgt.to(d).float()
        _, _, nnf = synthesize(s[..., :3], s[..., 3:], t[..., 3:], weights[3:].to(d), PatchMatchConfig(),
                               draws=TorchDraws(seed, d, "cpu"))
        nnfs.append(nnf.cpu())
    agree = (nnfs[0] == nnfs[1]).all(-1).float().mean().item()
    frames, flows, _ = make_inputs(seed, n, hw)
    truth = [style_of(f) for f in frames]
    outs = [blend_video_frames(dict(enumerate(frames)), {0: truth[0], n - 1: truth[n - 1]}, [0, n - 1],
                               flow_fn=pair_flow_fn(frames, flows, d), device=d, draw_device="cpu")
            for d in (dev, torch.device("cpu"))]
    mad = float(np.mean([np.abs(outs[0][i].astype(np.float64) - outs[1][i]).mean() for i in range(1, n - 1)]))
    print(f"small propagation (64x80): synthesize NNF agreement card vs CPU {agree:.5f} (min {SMALL_PROP_AGREE}); "
          f"interval of {n} frames mean |d| {mad:.4f} levels (max {SMALL_PROP_MEAN_ABS}); PSNR vs truth card "
          f"{_psnr(outs[0], truth, range(1, n - 1)):.3f} dB, CPU {_psnr(outs[1], truth, range(1, n - 1)):.3f} dB")
    if not (agree >= SMALL_PROP_AGREE and mad <= SMALL_PROP_MEAN_ABS):
        fail(f"small propagation: agreement {agree}, mean |d| {mad}")


# ---------------------------------------------------------------- gemm, aux, e2e
# bmm vs float32 plain: sums of exact bf16 products in two orders (first
# reading 4.5e-6 at K = 4096; H100 80GB HBM3, 700 W)
GEMM_REL_FRO = 1e-5
# full-width aux models, card vs CPU, float32 weights on both (TF32 off): the
# flows may differ where the global softmax is near a tie between matches.
# First reading (H100 80GB HBM3, 700 W): flows mean |d| 2.1e-4 px, max
# 2.2e-3 px, on flows up to 60 px; HED 2.3e-6; EGNet mask 6.5e-6
AUX_FLOW_MEAN = 0.01     # px, mean |d| of the flows
AUX_FLOW_FAR = 0.01      # share of flow vectors more than 0.1 px apart
AUX_EDGE_ATOL = 1e-4     # HED edge map in [0, 1]
AUX_MASK_ATOL = 1e-3     # EGNet background mask in [0, 1]


def phase_gemm(gen, dev):
    """The microbench entry point, counted; then every row (and two ragged
    shapes) against the float32 plain version."""
    from fresco_torch.ops import gemm
    from fresco_torch.scripts import bench_gemm as bg

    gemm.bmm.launches = 0
    results = bg.run(iters=10, seed=0)
    launches = gemm.bmm.launches
    timed = {(r["row"], r["route"]): r for r in results}
    for r in results:
        print(f"gemm bench {r['row']:44s} {r['route']:18s}: {r['ms']:8.3f} ms {r['tflops']:7.1f} TFLOP/s")
    cases = bg.rows(torch.Generator(device=dev).manual_seed(0), dev)
    def bf(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    # M not a multiple of 64, N of no tile, K under one k-tile, K a multiple
    # of 8 but not of 64, and a_period > 1 with a 4-D x
    cases.append(("M=200 N=700 K=40 [2,200,40]x[2,40,700]", bf(2, 200, 40), bf(2, 40, 700)))
    cases.append(("K=264 [2,256,264]x[2,264,512]", bf(2, 256, 264), bf(2, 264, 512)))
    cases.append(("a_period 3 [3,200,264]x[2,3,264,136]", bf(3, 200, 264), bf(2, 3, 264, 136)))
    cases.append(("ragged [3,1000,1000]x[3,1000,700]",
                  torch.randn(3, 1000, 1000, generator=gen, device=dev).to(torch.bfloat16),
                  torch.randn(3, 1000, 700, generator=gen, device=dev).to(torch.bfloat16)))
    cases.append(("ragged K%8 [2,77,133]x[2,133,45]",
                  torch.randn(2, 77, 133, generator=gen, device=dev).to(torch.bfloat16),
                  torch.randn(2, 133, 45, generator=gen, device=dev).to(torch.bfloat16)))
    rows, max_err = {}, 0.0
    for name, a, x in cases:
        ref = gemm.bmm_plain(a, x)
        out = gemm.bmm(a, x)
        torch.cuda.synchronize()
        rel = ((out - ref).norm() / ref.norm()).item()
        err = (out - ref).abs().max().item()
        max_err = max(max_err, err)
        print(f"gemm {name:44s}: rel fro {rel:.2e} (tol {GEMM_REL_FRO}), max|d| {err:.2e}")
        if not rel <= GEMM_REL_FRO:
            fail(f"gemm {name}: rel fro {rel}")
        if (name, "bmm") in timed:
            ms = timed[(name, "bmm")]["ms"]
            lib_ms = timed[(name, "torch.matmul bf16")]["ms"]
            plain_ms = cuda_ms(lambda: gemm.bmm_plain(a, x), iters=2)
            bnd = bound(2 * (a.numel() + x.numel()) + 4 * ref.numel(), bg.flops(a, x), BF16_TENSOR_FLOPS)
            print(f"gemm {name}: kernel {ms:.3f} ms ({bg.flops(a, x) / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
                  f"bound {bnd[0]:.3f} ms ({bnd[1]}), library (torch bf16 product) {lib_ms:.3f} ms")
            rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms)
        del ref, out
    print(f"gemm: microbench launches {launches}")
    if launches <= 0:
        fail("gemm: the microbench did not launch the kernel")
    return rows, max_err


def _full_width_aux(seed: int):
    """Full-width GMFlow, HED and EGNet on the CPU, float32, seeded."""
    from fresco_torch.models.egnet import EGNet
    from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
    from fresco_torch.models.hed import HED
    from fresco_torch.models.layers import init_flax_default_

    gen = torch.Generator().manual_seed(seed)
    return [init_flax_default_(m, gen).eval().requires_grad_(False) for m in (GMFlow(GMFlowConfig()), HED(), EGNet())]


def phase_aux(seed: int, dev, big: bool = True):
    from fresco_torch.models.egnet import make_saliency_fn
    from fresco_torch.models.hed import hed_detector

    cpu = torch.device("cpu")
    mods = _full_width_aux(seed)
    frames, _, _ = make_inputs(seed, 3, 64)
    x = torch.from_numpy(np.stack(frames)).float()
    outs = []
    for d in (dev, cpu):
        gm, hed, eg = (copy.deepcopy(m).to(d) for m in mods)
        flow = gm(x.to(d), torch.roll(x, -1, 0).to(d)).cpu()
        edge = hed(x.to(d)).cpu()
        mask = make_saliency_fn(eg)(np.stack(frames)).cpu()
        outs.append((flow, edge, mask))
    (f0, e0, m0), (f1, e1, m1) = outs
    fd = (f0 - f1).norm(dim=-1)
    flow_mean, flow_far = fd.mean().item(), (fd > 0.1).float().mean().item()
    edge_err, mask_err = (e0 - e1).abs().max().item(), (m0 - m1).abs().max().item()
    print(f"aux 64 px, full width, float32 card vs CPU: GMFlow |flow| max {f1.norm(dim=-1).max().item():.2f} px, "
          f"mean |d| {flow_mean:.2e} px (tol {AUX_FLOW_MEAN}), share > 0.1 px {flow_far:.4f} (tol {AUX_FLOW_FAR}), "
          f"max |d| {fd.max().item():.3e}; HED max |d| {edge_err:.2e} (tol {AUX_EDGE_ATOL}); EGNet mask max |d| "
          f"{mask_err:.2e} (tol {AUX_MASK_ATOL}), background share {(m1 > 0.5).float().mean().item():.3f}")
    if not (flow_mean <= AUX_FLOW_MEAN and flow_far <= AUX_FLOW_FAR and edge_err <= AUX_EDGE_ATOL
            and mask_err <= AUX_MASK_ATOL):
        fail("aux: card and CPU disagree")
    if not big:
        return
    # the pipeline's dtypes: GMFlow float32 on bf16-rounded weights, EGNet bf16
    gm, hed, eg = (copy.deepcopy(m).to(dev) for m in mods)
    gm, eg = gm.to(torch.bfloat16).float(), eg.to(torch.bfloat16)
    frames, _, _ = make_inputs(seed, 8, 512)
    x = torch.from_numpy(np.stack(frames)).to(dev).float()
    sal_fn = make_saliency_fn(eg)
    runs = {"GMFlow 8 pairs bidirectional (float32, bf16-rounded weights)":
                lambda: gm(x, torch.roll(x, -1, 0)),
            "HED 8 frames (float32, one call per frame)": lambda: [hed_detector(hed, f) for f in frames],
            "EGNet background mask 8 frames (bf16)": lambda: sal_fn(np.stack(frames))}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if isinstance(out, torch.Tensor) and not bool(torch.isfinite(out).all()):
            fail(f"aux {name}: non-finite output")
        print(f"aux 512x512 {name}: {ms:.1f} ms, peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")


E2E_FRAMES, E2E_MININTERV, E2E_MAXINTERV = 41, 3, 5


def phase_e2e(seed: int, dev, tiny: bool = False, res: int = 512, gram_rows=None, pe_shape_ms=None):
    """Keyframes (selection, 2 batches with the record carried, GMFlow, HED,
    EGNet background smoothing) then propagation of the whole clip."""
    from fresco_torch.attention.flash import flash_attention
    from fresco_torch.ops.gemm import bmm
    from fresco_torch.ops.gram_kernel import sign_gram_apply
    from fresco_torch.pipeline.runner import FrescoPipeline, build_models
    from fresco_torch.propagate.gather import gather_rows
    from fresco_torch.propagate.patch_eval import patch_eval
    from fresco_torch.propagate.video_blend import blend_video_frames

    n = E2E_FRAMES
    cfg = music_config(resolution=res, mininterv=E2E_MININTERV, maxinterv=E2E_MAXINTERV,
                       **(dict(dtype="float32", gram_dtype="float32", num_inference_steps=6, num_warmup_steps=1,
                               end_opt_step=4, opt_iters=1, bg_smoothing_steps=(3, 4)) if tiny else {}))
    t0 = time.perf_counter()
    bundle = build_models(cfg, tiny=tiny, seed=seed, device=dev, random_aux_weights=True)
    pipe = FrescoPipeline(cfg, bundle)
    pipe.sync_phases = True
    frames, flows, _ = make_inputs(seed, n, res)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    print(f"e2e: built models (GMFlow, HED, EGNet included) in {time.perf_counter() - t0:.1f} s; "
          f"detector {getattr(bundle.detector, 'func', bundle.detector).__name__}, saliency "
          f"{'on' if bundle.saliency_fn else 'off'}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for k in (flash_attention, sign_gram_apply, gather_rows, patch_eval, bmm):
        k.launches = 0
    sign_gram_apply.launches_by_shape.clear()
    patch_eval.launches_by_shape.clear()
    t0 = time.perf_counter()
    keys = pipe.translate_keyframes(frames, verbose=True)
    sync()
    t_keys = time.perf_counter() - t0
    key_ind = sorted(keys)
    bgr = lambda img: np.ascontiguousarray(img[..., ::-1])  # noqa: E731
    tm: dict = {}
    t1 = time.perf_counter()
    # propagation on the clip's known flows, as phase 8: random GMFlow weights
    # give meaningless flows (GMFlow still runs, and its flows are consumed,
    # in the keyframe stage's inter-frame prep)
    out = blend_video_frames({i: bgr(f) for i, f in enumerate(frames)}, {k: bgr(keys[k]) for k in key_ind}, key_ind,
                             flow_fn=pair_flow_fn(frames, flows, dev), device=dev, timers_out=tm)
    sync()
    t_prop = time.perf_counter() - t1
    launches = {"flash_attn_fwd": flash_attention.launches, "sign_gram": sign_gram_apply.launches,
                "row_gather": gather_rows.launches, "patch_eval": patch_eval.launches}
    if cfg.gram_dtype == "bfloat16":  # the bf16 pair's apply is bmm
        launches["bmm"] = bmm.launches
    pe_counts = dict(patch_eval.launches_by_shape)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")
    ph = pipe.phases.times
    print(f"e2e: {n} frames {res}x{res}, {len(key_ind)} keyframes {key_ind}, keyframe stage {t_keys:.2f} s, "
          f"propagation {t_prop:.2f} s, wall {t_keys + t_prop:.2f} s, peak device memory "
          f"{peak_gb:.2f} GiB, launches {launches}")
    sign_gram_by_shape("e2e", gram_rows)
    if dev.type == "cuda":
        patch_eval_by_shape("e2e", pe_counts, {} if pe_shape_ms is None else pe_shape_ms, seed, dev)
    names = [("gmflow/interframe_prep", "interframe_prep"), ("saliency", "saliency"),
             ("control_detector", "control_detector"), ("intraframe_prep", "intraframe_prep"),
             ("attn_params", "attn_params"), ("encode_prompts", "encode_prompts"), ("denoise_loop", "denoise_loop"),
             ("vae_decode", "vae_decode"), ("upload_frames", "upload_frames")]
    print("e2e keyframe phases (s, synchronized): " + ", ".join(f"{a} {ph.get(b, 0.0):.3f}" for a, b in names))
    print("e2e propagation phases (s, host wall, overlapping): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(tm.items(), key=lambda kv: -kv[1])))
    if not 9 <= len(key_ind) <= 12:
        fail(f"e2e: {len(key_ind)} keyframes, expected 9-12")
    if any(keys[k].shape != (res, res, 3) or keys[k].dtype != np.uint8 for k in key_ind):
        fail("e2e: keyframes of the wrong shape")
    if sorted(out) != list(range(n)) or any(out[i].shape != (res, res, 3) or out[i].dtype != np.uint8 for i in out):
        fail("e2e: wrong frames out of propagation")
    if not all(np.array_equal(out[k], bgr(keys[k])) for k in key_ind):
        fail("e2e: a keyframe did not pass through propagation unchanged")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        fail(f"e2e did not launch every main-path kernel: {launches}")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    from fresco_torch import kernels  # fails outside a checkout

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else f"nvidia-smi unavailable (rc {smi.returncode})")

    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {len(kernels.build_info.paths)} libraries, one nvcc per source in parallel, "
          f"{time.perf_counter() - t0:.2f} s (nvcc wall {kernels.build_info.seconds:.2f} s)")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flash_rows, flash_err = phase_flash(gen, dev)
    gram_rows, gram_err = phase_gram(gen, dev)
    phase_small(args.seed, dev)
    launches = phase_slice(args.seed, dev, gram_rows)
    gather_rows_ = phase_gather(gen, dev)
    pe_rows, pe_err, pe_shape_ms = phase_patch_eval(args.seed, dev)
    phase_small_propagate(args.seed, dev)
    launches.update(phase_propagate(args.seed, dev, pe_shape_ms))
    gemm_rows, gemm_err = phase_gemm(gen, dev)
    phase_aux(args.seed, dev)
    phase_e2e(args.seed, dev, gram_rows=gram_rows, pe_shape_ms=pe_shape_ms)

    def row(name, source, replaces, err, r):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": err, **r}

    table = {"kernels": [
        row("flash_attn_fwd", "fresco_torch/csrc/flash_attn.cu", "fresco_tpu/attention/flash.py:31", flash_err,
            flash_rows["self d=40"]),
        row("sign_gram", "fresco_torch/csrc/sign_gram.cu", "fresco_tpu/ops/gram_kernel.py:30", gram_err,
            gram_rows[(torch.bfloat16, 4096, 640)]),
        row("row_gather", "fresco_torch/csrc/row_gather.cu", "scripts/bench_pallas_gather.py:31", 0.0,
            gather_rows_["vote f32 W=75"]),
        row("patch_eval", "fresco_torch/csrc/patch_eval.cu", "scripts/bench_fused_eval.py:94", pe_err,
            pe_rows["seeded 15 cand"]),
        row("bmm", "fresco_torch/csrc/bmm.cu", "scripts/bench_gemm.py:60", gemm_err,
            gemm_rows["flat fij,fjd [8,4096,4096]x[8,4096,1280]"]),
    ]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
