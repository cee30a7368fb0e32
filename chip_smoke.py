"""GPU smoke test of fresco_torch: kernels against their plain versions,
then one full-width keyframe batch and one full-width propagation interval
through the pipeline, the loaded-weights batch, the propagation entry
points, the control detectors with config_boxer's depth-controlled
batch, the training path (the UNet step and GMFlow's), the WebUI's
handlers on config_music, and the device mesh.

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
               products alone; then the fused factored kernel (C = r·rᵀ
               left factored) at music's finest-stage shapes, [16, 5120,
               640] and [10, 5120, 640]: bit-equal to the plain chunked
               products on values where every float32 sum is exact, near
               them on unit rows, timed beside them and its bound, and one
               optimize_feature at [16, 64, 80, 640] launching it once an
               iteration;
  4. small   : a small-width 64 px batch (FRESCO attention on, feature
               optimization off) on the card (kernels, bf16) and on the CPU
               (plain versions, float32) with the same weights and noise,
               compared;
  5. slice   : one batch of 8 keyframes at config_music's 512x640
               through FrescoPipeline._translate_batch and decode, at full
               SD1.5 width (UNet, ControlNet, VAE, CLIP-L text) with random
               weights from a seeded torch.Generator, config_music's
               settings.  The flash, sign-gram, bmm and factored-gram
               launch counters (from 0 at the slice's start) must move:
               the finest stage's gram (16 images with CFG, hw 5120) stays
               factored; the sign-gram launches are printed by shape
               (the dense stages' hw 80, 320, 1280 at c = 1280, which
               phase 3 does not time);
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
               one-candidate set at every level; the NNF may differ only at
               near ties; every case timed beside its bound and plain time;
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
               synchronized, so the breakdown is device time;
 12. weights : full SD1.5-width checkpoints written from seeded modules
               into a temporary directory in scripts/fetch_weights.py's
               layout (the UNet as float16 .safetensors, the VAE as .bin,
               CLIP text with its position_ids, sd-controlnet-hed, GMFlow,
               ControlNetHED.pth, epoch_resnet.pth, a kohya LoRA over UNet
               attention and text-encoder layers), loaded by build_models:
               every module bit-equal to its source in the pipeline's
               dtypes, the LoRA's weights to source + a delta computed here;
               load seconds per model; then one keyframe batch (8 x 512 px,
               config_music) on the loaded bundle with FreeU on and the
               sparse warp mode (flash, sign-gram and bmm must launch);
               then the sparse warp against the dense one at the four
               decoder-stage shapes (gradients, determinism, one
               optimize_feature call in each mode, timed);
 13. entry points: a 17-frame 512x640 clip (keys 0, 6, 16) through
               blend_video_frames(n_devices=1), then its two intervals'
               chains serially (_synthesize_chain_pair) and as one wave over
               [cuda:0] * 4 (_synthesize_chain_wave): bit-equal, both walls,
               the row_gather and patch_eval counters must move;
               ebsynth_cli.run at 512x640 (style + two guides) equal to
               synthesize with TorchDraws(0), the error .bin read back, and
               ebsynth_cli.main on PNG files where Pillow imports; the native
               C++ backend at 128x160 (identity reconstruction, and against
               jump-flood on the card), with os.cpu_count(); default_flow_fn
               from a full-width GMFlow checkpoint equal to its module and to
               consistency_flow_fn's loaded GMFlow (F13); CLIP ViT-L/14 with
               its projection written as a CLIPModel .safetensors, loaded
               bit-equal by make_clip_image_encoder, its embeddings of two
               frames within 1e-4 of the same module in float64 on the host,
               and evaluate_translation on 32 frames at 512 px with
               frame_similarity_is_clip true.
               Every line carries the card's name and power limit.
 14. detectors: full-width MiDaS DPT-hybrid (timm layout), M-LSD (unfolded
               Conv + BatchNorm) and OpenPose body (the released flat keys)
               checkpoints written from seeded modules beside phase 12's
               files and an sd-controlnet-depth link; config/config_boxer.yaml
               loaded with its paths pointed there and build_models run:
               each detector bit-equal to its source (M-LSD to a float64
               fold computed here), 64 px card vs CPU, 8 frames at 512x512
               timed, the outputs card vs CPU (the MiDaS depth image, the
               M-LSD line map, body_decode on the body maps, and
               openpose_detector's drawing where cv2 imports); then one
               8-keyframe 512x512 batch with config_boxer's settings (depth
               control, cond_scale 0.7, 20 steps, warmup 5, EGNet saliency,
               GMFlow) on the loaded weights: flash and the sign-gram pair
               must launch, the latents be finite, and the ControlNet's
               condition equal the detector's depth maps.
 15. train   : flash's gradient (F18): at the UNet's self-attention shapes
               (S 4096 / 1024 / 256, d 40 / 80 / 160, batch 2 x 8 heads)
               and one masked case with an empty row, the kernel's output
               has a grad_fn and dq / dk / dv equal autograd through
               naive_attention; forward + backward timed beside naive's and
               SDPA's.  Then the UNet fine-tuning step at full SD1.5 width
               (float32 parameters, bf16 compute, batch 2 at 512 px, 77x768
               context, AdamW 1e-5), 3 steps: finite losses, moving
               parameters, 16 flash launches a step (the counter zeroed
               before); one step against the same step with naive_attention
               forced.  GMFlow at full width, batch 2 at 384x512: two
               supervised steps on SyntheticIndex pairs, two unsupervised on
               make_inputs frames written as PNGs and read by
               index_frame_dir and FlowLoader; one 64x64 step on the card
               against the CPU.  The GMFlow training driver: 4 steps with
               checkpoints, then --resume, bit-equal.
 16. webui   : the WebUI's handlers on config/config_music.yaml read through
               example_inputs, on data/music.mp4 decoded by this machine's
               cv2 (a failed decode fails the phase) and cut with frame_count
               to 48 frames at 512x640, config_music's steps, intervals cut
               to 4 / 8 (10 keyframes, two batches), HED and EGNet with
               seeded random weights: process1; a second get_pipeline with
               12 steps, strength 0.75 and the spatial- and temporal-guided
               attentions off, which must return the same pipeline without a
               second build_models, and process1 again; process2 into
               blend.mp4 (48 frames read back); a controlnet_type change to
               depth, which must rebuild.  Each action's wall, peak memory and
               launches; all five kernels must launch over the phase.
 17. mesh    : the machine's torch.distributed (backends, NCCL's version,
               whether gloo gathers, reduces and broadcasts CUDA tensors
               itself, a K-sized gather as handed and as staged by hand); a
               process group of one over NCCL, bit-equal to no group; then
               config_music's 8-keyframe 512x512 batch at 4 steps, feature
               optimization off and on, its flows from the bundle's
               full-width GMFlow, in worlds of ranks spawned on this card
               over gloo at meshes (2, 1), (1, 2), (2, 2) (over model the
               UNet, ControlNet, VAE, text encoder and GMFlow split), each
               rank against the single process and against the witness (one
               process doing a rank's arithmetic, no collective); flash,
               sign-gram and bmm must launch in every rank; the (2, 1)
               UNet training step against the single step;
               dryrun_multichip(4) on the card.  Walls, peak memory,
               launches and each model's parameter bytes per rank (whole
               and split), reported and not judged.
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


def phase_factored_gram(gen, dev):
    """The fused factored kernel (reference gram C = r·rᵀ left factored) at
    music's finest-stage shapes: on values k/16, where every sum is exact
    in float32, bit-equal to the plain chunked products; on unit rows (v̂ a
    perturbation of r) within GRAM_REL_FRO of them (near-tie flips).  Times
    the kernel, the plain version (the path it replaced) and the bound:
    4·B·hw²·c at the bf16 tensor peak, the least work (half of the
    symmetric D = v̂v̂ᵀ − rrᵀ, then S·v̂), as ``gram_roofline`` counts the
    dense case; the kernel forms D whole, 6·B·hw²·c, which is printed
    beside it.  Then one ``optimize_feature`` at music's finest stage
    ([16, 64, 80, 640], C factored since its dense gram is 800 MiB) must
    launch it once an iteration.  Returns (rows by (B, hw, c), largest |d|
    on unit rows).  The kernel table's launches come from phase 5."""
    from fresco_torch.diffusion.guidance import GuidanceConfig, optimize_feature
    from fresco_torch.ops import gram_kernel as gk

    rows, max_err = {}, 0.0
    for b, hw, c in ((16, 5120, 640), (10, 5120, 640)):
        grid = lambda: (torch.randn(b, hw, c, generator=gen, device=dev) * 4).round().clamp(-16, 16) / 16  # noqa: E731
        vq, rq = grid().to(torch.bfloat16), grid().to(torch.bfloat16)
        exact = torch.equal(gk.factored_sign_gram_apply(vq, rq), gk.factored_sign_gram_plain(vq, rq))
        del vq, rq
        r = torch.nn.functional.normalize(torch.randn(b, hw, c, generator=gen, device=dev), dim=-1)
        v = torch.nn.functional.normalize(r + 0.3 * torch.randn(b, hw, c, generator=gen, device=dev), dim=-1)
        v, r = v.to(torch.bfloat16).contiguous(), r.to(torch.bfloat16).contiguous()
        out = gk.factored_sign_gram_apply(v, r)
        ref = gk.factored_sign_gram_plain(v, r)
        torch.cuda.synchronize()
        rel = ((out - ref).norm() / ref.norm()).item()
        err = (out - ref).abs().max().item()
        ms = timed(lambda: gk.factored_sign_gram_apply(v, r))
        plain_ms = cuda_ms(lambda: gk.factored_sign_gram_plain(v, r), iters=3)
        # v and r read, the f32 output written; half of the symmetric D (B·hw²·c
        # for each of G and C), then S·v (2·B·hw²·c)
        bnd = bound(2 * v.numel() * 2 + out.numel() * 4, 4 * b * hw * hw * c, BF16_TENSOR_FLOPS)
        whole_d_ms = 6 * b * hw * hw * c / BF16_TENSOR_FLOPS * 1e3
        print(f"factored gram bf16 B={b} hw={hw} c={c}: grid values bit-equal to plain {exact}; unit rows rel fro "
              f"{rel:.3e} (tol {GRAM_REL_FRO}), max|d|={err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bnd[0]:.3f} ms ({bnd[1]}, 4·B·hw²·c; D formed whole, 6·B·hw²·c, {whole_d_ms:.3f} ms), "
              f"library none")
        if not (exact and rel <= GRAM_REL_FRO):
            fail(f"factored gram B={b} hw={hw} c={c}: grid exact {exact}, rel {rel}")
        rows[(b, hw, c)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        max_err = max(max_err, err)
        del v, r, out, ref
    cfg = GuidanceConfig()
    sample = torch.randn(16, 64, 80, 640, generator=gen, device=dev)
    corr = torch.nn.functional.normalize(torch.randn(16, 64 * 80, 640, generator=gen, device=dev), dim=-1)
    before = gk.factored_sign_gram_apply.launches
    t0 = time.perf_counter()
    opt = optimize_feature(sample, None, None, None, None, corr, cfg, corr_is_dense=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = gk.factored_sign_gram_apply.launches - before
    print(f"factored gram: optimize_feature at [16, 64, 80, 640] (C factored, {cfg.iters} iterations) "
          f"{wall:.3f} s, {n} launches, output finite {bool(torch.isfinite(opt).all())}")
    if n != cfg.iters or not bool(torch.isfinite(opt).all()):
        fail(f"factored gram: {n} launches in optimize_feature, expected {cfg.iters}")
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
        bundle = ModelBundle(ms[0], ms[1], ms[2], ms[3], HashTokenizer(ccfg.vocab_size), detector, device,
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
    from fresco_torch import kernels
    from fresco_torch.ops.gram_kernel import sign_gram_apply
    from fresco_torch.pipeline.runner import FrescoPipeline, build_models
    from fresco_torch.utils.guards import check_finite

    n, h, w = 8, 512, 640  # config_music's frames
    cfg = music_config()
    t0 = time.perf_counter()
    bundle = build_models(cfg, seed=seed, device=dev)
    frames, flows, detector = make_inputs(seed, n, (h, w))
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
    kernels.reset_launches()
    sign_gram_apply.launches_by_shape.clear()
    t0 = time.perf_counter()
    latents, record = pipe._translate_batch(frames, prompts, negs, None, False)
    images = pipe.decode(latents)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.launches().items()
                if k in ("flash_attn_fwd", "sign_gram", "bmm", "sign_gram_factored")}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30

    ph = pipe.phases.times
    names = [("prompts", "encode_prompts"), ("interframe prep", "interframe_prep"),
             ("intraframe prep", "intraframe_prep"), ("attention params", "attn_params"),
             ("denoise loop", "denoise_loop"), ("decode", "vae_decode"),
             ("upload", "upload_frames"), ("control detector", "control_detector")]
    print("slice phases (s, synchronized): " + ", ".join(f"{a} {ph.get(b, 0.0):.3f}" for a, b in names))
    print(f"slice: {n} keyframes {h}x{w}, {cfg.num_inference_steps} steps, wall {wall:.2f} s, "
          f"peak device memory {peak_gb:.2f} GiB, launches {launches}")
    sign_gram_by_shape("slice", gram_rows)
    check_finite("slice_latents", latents)
    print(f"slice: latents finite, shape {tuple(latents.shape)}, |max| {latents.abs().max().item():.3f}; "
          f"record {tuple(record.shape)}; output {images.shape} {images.dtype}")
    if images.shape != (n, h, w, 3) or images.dtype != np.uint8:
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

    card, c_args, nnf_out, e_out, _, keep = _kernel_args(*args, patch=patch)
    c_args = (*c_args, torch.cuda.current_stream(card).cuda_stream)
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
    match's error) at 512x640 and at each coarser level.  Each case's ``ms`` is the wrapper call
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
    cases += [(f"one candidate {h}x{w}", (h, w), True, (), [], 5, False) for h, w in levels[:-1][::-1]]
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


# ---------------------------------------------------------------- weights
LORA_RANK, LORA_SCALE = 8, 0.8
# sparse vs dense warp, float32.  The warp's VJP is linear: the two sum the
# same four taps per pixel in other orders.  The temporal loss's gradient
# has |.| kinks: a residual within float32 rounding of 0 takes the other
# sign in the other form and moves that element by ~2/N, so elements may
# differ on a tiny share of pixels, and the Frobenius norm is held loosely.
SPARSE_VJP_REL = 1e-5
SPARSE_GRAD_FAR_SHARE = 1e-4   # share of elements differing by > 1e-3 of the largest
SPARSE_GRAD_REL = 1e-2
SPARSE_SHAPES = ((64, 1280), (256, 1280), (1024, 1280), (4096, 640))  # optimize_feature's (hw, c)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # also starts CUDA where no phase before has
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")


def _seeded_(m: torch.nn.Module, gen) -> torch.nn.Module:
    """Flax's init plus N(0, 0.02) on every tensor (no zero-initialized
    ControlNet convolution or bias left to compare trivially)."""
    from fresco_torch.models.layers import init_flax_default_

    init_flax_default_(m, gen)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device=p.device) * 0.02)
    return m.eval().requires_grad_(False)


def _kohya_lora(unet_sd: dict, text_sd: dict, gen) -> dict:
    """A kohya LoRA over the attention projections of up_blocks.3 and the
    mid block, the mid block's feed-forward and the text encoder's q / v
    projections; alpha on every other module."""
    from fresco_torch.models.lora import _flax_path_for
    from fresco_torch.models.convert import torch_key

    mods = [f"lora_unet_up_blocks_3_attentions_{a}_transformer_blocks_0_{att}_{p}"
            for a in range(3) for att in ("attn1", "attn2") for p in ("to_q", "to_k", "to_v", "to_out_0")]
    mods += [f"lora_unet_mid_block_attentions_0_transformer_blocks_0_{s}"
             for s in ("attn1_to_q", "attn2_to_v", "ff_net_0_proj", "ff_net_2")]
    mods += [f"lora_te_text_model_encoder_layers_{i}_self_attn_{p}" for i in range(12) for p in ("q_proj", "v_proj")]
    out = {}
    for i, mod in enumerate(mods):
        w = (unet_sd if mod.startswith("lora_unet_") else text_sd)[torch_key((*_flax_path_for(mod), "kernel"))]
        o, n = w.shape
        out[f"{mod}.lora_down.weight"] = (torch.randn(LORA_RANK, n, generator=gen) * 0.1).half()
        out[f"{mod}.lora_up.weight"] = (torch.randn(o, LORA_RANK, generator=gen) * 0.1).half()
        if i % 2 == 0:
            out[f"{mod}.alpha"] = torch.tensor(LORA_RANK / 2.0)
    return out


def write_checkpoints(root: str, seed: int, dev):
    """Seeded full-width modules on ``dev`` and their checkpoints under
    ``root`` in the fetch_weights layout.  Returns (sources {model: state
    dict on dev}, checkpoint dtypes, the LoRA dict, file sizes in bytes)."""
    import os

    from fresco_torch.models import convert as C
    from fresco_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from fresco_torch.models.controlnet import ControlNet
    from fresco_torch.models.egnet import EGNet, egnet_map
    from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
    from fresco_torch.models.gmflow.convert import gmflow_map
    from fresco_torch.models.hed import HED, hed_map
    from fresco_torch.models.unet import UNet2DCondition, UNetConfig
    from fresco_torch.models.vae import AutoencoderKL, VAEConfig

    ccfg = CLIPTextConfig()
    ucfg = UNetConfig(cross_attention_dim=ccfg.hidden_size)  # as build_models sets it
    with torch.device("meta"):
        mods = {"unet": UNet2DCondition(ucfg), "vae": AutoencoderKL(VAEConfig()),
                "controlnet": ControlNet(ucfg, (16, 32, 96, 256)), "text": CLIPTextEncoder(ccfg),
                "gmflow": GMFlow(GMFlowConfig()), "hed": HED(), "egnet": EGNet()}
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    src = {n: dict(_seeded_(m.to_empty(device=dev), gen).state_dict()) for n, m in mods.items()}
    maps = {"unet": C.sd_key_map("unet", ucfg), "vae": C.sd_key_map("vae", VAEConfig()),
            "controlnet": C.sd_key_map("controlnet", ucfg), "text": C.sd_key_map("text", ccfg),
            "gmflow": gmflow_map, "hed": hed_map, "egnet": egnet_map}
    dtypes = dict.fromkeys(mods, torch.float32)
    dtypes.update(unet=torch.float16, controlnet=torch.float16)
    sd15 = os.path.join(root, "stable-diffusion-v1-5")
    paths = {"unet": f"{sd15}/unet/diffusion_pytorch_model.safetensors",
             "vae": f"{sd15}/vae/diffusion_pytorch_model.bin",
             "text": f"{sd15}/text_encoder/model.safetensors",
             "controlnet": f"{root}/sd-controlnet-hed/diffusion_pytorch_model.safetensors",
             "gmflow": f"{root}/gmflow_sintel-0c07dcb3.pth", "hed": f"{root}/ControlNetHED.pth",
             "egnet": f"{root}/epoch_resnet.pth"}
    for name, path in paths.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        ck = {k: v.to(dtypes[name]).cpu() for k, v in C.to_checkpoint(src[name], maps[name]).items()}
        if name == "text":
            ck["text_model.embeddings.position_ids"] = torch.arange(77)[None]
        if name == "egnet":  # in the reference's file, unused by the forward
            ck["merge1.trans.0.0.weight"] = torch.zeros(128, 64, 1, 1)
            ck["base.bn1.num_batches_tracked"] = torch.tensor(0)
        if path.endswith(".safetensors"):
            C.write_safetensors(path, ck)
        else:
            torch.save({"model": ck} if name == "gmflow" else ck, path)
    lgen = torch.Generator().manual_seed(seed + 13)
    lora = _kohya_lora(src["unet"], src["text"], lgen)
    paths["lora"] = f"{root}/lora.safetensors"
    C.write_safetensors(paths["lora"], lora)
    return src, dtypes, lora, {n: os.path.getsize(p) for n, p in paths.items()}


def _expected_lora(src_sd: dict, ckpt_dtype, lora: dict, target: str) -> dict:
    """{state-dict key: checkpoint weight + delta}, computed here: the
    delta in float32 on the host, the sum rounded to the checkpoint dtype."""
    from fresco_torch.models.convert import torch_key
    from fresco_torch.models.lora import _flax_path_for

    out = {}
    for k in lora:
        if not (k.startswith(target) and k.endswith(".lora_down.weight")):
            continue
        mod = k[: -len(".lora_down.weight")]
        down, up = lora[k].float(), lora[f"{mod}.lora_up.weight"].float()
        alpha = float(lora[f"{mod}.alpha"]) if f"{mod}.alpha" in lora else float(LORA_RANK)
        key = torch_key((*_flax_path_for(mod), "kernel"))
        w = src_sd[key].to(ckpt_dtype).cpu()
        out[key] = (w.float() + (up @ down) * (alpha / LORA_RANK) * LORA_SCALE).to(ckpt_dtype)
    return out


def _norm_keys(m: torch.nn.Module) -> set:
    from fresco_torch.models.layers import NORMS

    return {f"{n}.{p}" if n else p for n, mod in m.named_modules() if isinstance(mod, NORMS)
            for p, _ in mod.named_parameters(recurse=False)}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.contiguous().view(view),
                                                                      b.contiguous().view(view))


def check_loaded(bundle, src: dict, dtypes: dict, lora: dict) -> None:
    """Each loaded module against its source, bit for bit, in the
    pipeline's dtypes: UNet / ControlNet / VAE in bf16 with float32 norms,
    the text encoder, HED float32, GMFlow float32 on bf16-rounded weights,
    EGNet bf16; the LoRA-touched weights against ``_expected_lora``."""
    bf16, f32 = torch.bfloat16, torch.float32
    mods = {"unet": bundle.unet, "vae": bundle.vae, "controlnet": bundle.controlnet, "text": bundle.text_encoder,
            "gmflow": bundle.gmflow, "hed": bundle.detector.args[0], "egnet": bundle.saliency_fn.args[0]}
    lora_exp = {"unet": _expected_lora(src["unet"], dtypes["unet"], lora, "lora_unet_"),
                "text": _expected_lora(src["text"], dtypes["text"], lora, "lora_te_")}
    parts = []
    for name, m in mods.items():
        got = m.state_dict()
        norms = _norm_keys(m)
        bad, n_lora = [], 0
        if sorted(got) != sorted(src[name]):
            fail(f"weights {name}: the loaded module's keys differ from the source's")
        for k, v in got.items():
            want_dtype = {"unet": bf16, "vae": bf16, "controlnet": bf16, "egnet": bf16}.get(name, f32)
            if want_dtype == bf16 and k in norms:
                want_dtype = f32
            w = src[name][k].to(dtypes[name])
            if k in lora_exp.get(name, {}):
                w, n_lora = lora_exp[name][k].to(v.device), n_lora + 1
            w = w.to(bf16).float() if name == "gmflow" else w.to(want_dtype)
            if v.dtype != want_dtype or not _bits_equal(v, w):
                bad.append(k)
        if bad:
            fail(f"weights {name}: {len(bad)} of {len(got)} tensors differ from the source, e.g. {bad[:4]}")
        parts.append(f"{name} {len(got)} tensors" + (f" ({n_lora} with the LoRA delta)" if n_lora else ""))
    if len(lora_exp["unet"]) + len(lora_exp["text"]) != sum(1 for k in lora if k.endswith(".lora_down.weight")):
        fail("weights: a LoRA module maps to no weight")
    print("weights: loaded modules bit-equal to their sources in the pipeline's dtypes: " + "; ".join(parts))


def sparse_vs_dense(seed: int, dev, shapes=SPARSE_SHAPES, res: int = 512) -> None:
    """At the four decoder-stage shapes of optimize_feature (2F = 16, flows
    of a 512x512 clip): the sparse warp's VJP and the temporal loss's
    gradient against the dense form's in float32, the sparse backward
    twice (bit-identical), and one optimize_feature call in each mode
    (config_music's guidance: 20 iterations, bf16 grams), timed."""
    import dataclasses

    from fresco_torch.diffusion.guidance import (GuidanceConfig, apply_sparse_warp, make_sparse_warp,
                                                 optimize_feature, temporal_loss, warp_matrix)
    from fresco_torch.ops.blend import prepare_flow_for_scale
    from fresco_torch.ops.warp import forward_backward_consistency

    f, chunk = 8, 2
    _, flows, _ = make_inputs(seed, f, res)
    g = torch.Generator(device=dev).manual_seed(seed + 14)
    fwd, bwd = torch.from_numpy(flows[:f]).to(dev), torch.from_numpy(flows[f:]).to(dev)
    occ = forward_backward_consistency(fwd, bwd)  # the clip's occlusions, as the inter-frame prep finds them
    gcfg = GuidanceConfig()
    for hw, c in shapes:
        side = int(round(math.sqrt(hw)))
        x = torch.randn(chunk * f, side, side, c, generator=g, device=dev)
        fs, fo = prepare_flow_for_scale(fwd, occ[0], (side, side), dilate_full_res=False)
        bs, bo = prepare_flow_for_scale(bwd, occ[1], (side, side), dilate_full_res=False)
        sw = (make_sparse_warp(fs), make_sparse_warp(bs))
        dw = (warp_matrix(fs, torch.float32), warp_matrix(bs, torch.float32))
        ct = torch.randn(f, hw, chunk * c, generator=g, device=dev)
        xv = x.reshape(chunk, f, hw, c).permute(1, 2, 0, 3).reshape(f, hw, chunk * c)
        grads = []
        for _ in range(2):
            xr = xv.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(apply_sparse_warp(xr, sw[0]), xr, ct)[0])
        vjp_ref = torch.matmul(dw[0].transpose(1, 2), ct)
        vjp_rel = ((grads[0] - vjp_ref).norm() / vjp_ref.norm()).item()
        same_vjp = _bits_equal(grads[0], grads[1])
        lg = []
        for warps, runs in ((dw, 1), (sw, 2)):
            for _ in range(runs):
                xr = x.clone().requires_grad_(True)
                lg.append(torch.autograd.grad(temporal_loss(xr, warps[0], warps[1], fo, bo, chunk), xr)[0])
        dense_g, sparse_g, sparse_g2 = lg
        if not float(dense_g.norm()) > 0:
            fail(f"sparse vs dense hw={hw} c={c}: the temporal loss has no gradient (every pixel occluded?)")
        d = (sparse_g - dense_g).abs()
        rel = ((sparse_g - dense_g).norm() / dense_g.norm()).item()
        far = (d > 1e-3 * dense_g.abs().max()).float().mean().item()
        same_loss = _bits_equal(sparse_g, sparse_g2)
        del grads, vjp_ref, lg, dense_g, sparse_g, sparse_g2, d, dw, sw
        corr = torch.nn.functional.normalize(torch.randn(chunk * f, hw, c, generator=g, device=dev), dim=-1)
        ms, peak = {}, {}
        for mode in ("dense", "sparse", "sparse", "dense"):
            cfg = dataclasses.replace(gcfg, warp_mode=mode)
            _sync(dev)
            _reset_peak(dev)
            t0 = time.perf_counter()
            out = optimize_feature(x.to(torch.bfloat16), fwd, bwd, occ[0], occ[1],
                                   corr.to(torch.bfloat16), cfg, corr_is_dense=False)
            _sync(dev)
            ms.setdefault(mode, []).append((time.perf_counter() - t0) * 1e3)
            peak[mode] = _peak_gib(dev)
            if not bool(torch.isfinite(out).all()):
                fail(f"sparse vs dense hw={hw} c={c}: {mode} optimize_feature output not finite")
        print(f"sparse vs dense hw={hw} c={c} (2F = 16, occluded share fwd {float(fo.mean()):.3f} bwd "
              f"{float(bo.mean()):.3f}): warp VJP rel fro {vjp_rel:.2e} (tol {SPARSE_VJP_REL}); "
              f"temporal-loss gradient rel fro {rel:.2e} (tol {SPARSE_GRAD_REL}), share of elements off by "
              f"> 1e-3 of the largest {far:.2e} (tol {SPARSE_GRAD_FAR_SHARE}); sparse backward twice bit-identical: "
              f"VJP {same_vjp}, loss gradient {same_loss}; optimize_feature (20 iterations, bf16 grams) dense "
              f"{ms['dense'][0]:.1f} / {ms['dense'][1]:.1f} ms, peak {peak['dense']:.2f} GiB; sparse "
              f"{ms['sparse'][0]:.1f} / {ms['sparse'][1]:.1f} ms, peak {peak['sparse']:.2f} GiB (dense, sparse, "
              f"sparse, dense in turn)")
        if not (vjp_rel <= SPARSE_VJP_REL and rel <= SPARSE_GRAD_REL and far <= SPARSE_GRAD_FAR_SHARE):
            fail(f"sparse vs dense hw={hw} c={c}: disagree")
        if not (same_vjp and same_loss):
            fail(f"sparse vs dense hw={hw} c={c}: the sparse backward is not deterministic")


def phase_weights(seed: int, dev, gram_rows=None, res: int = 512, sparse_shapes=SPARSE_SHAPES):
    """Checkpoints written, loaded through build_models, checked; one
    keyframe batch on the loaded bundle (FreeU, LoRA, sparse warp); sparse
    against dense."""
    import dataclasses
    import tempfile

    from fresco_torch.attention.flash import flash_attention
    from fresco_torch.ops.gemm import bmm
    from fresco_torch.ops.gram_kernel import sign_gram_apply
    from fresco_torch.pipeline.runner import FrescoPipeline, build_models
    from fresco_torch.utils.guards import check_finite

    n = 8
    with tempfile.TemporaryDirectory(prefix="fresco_weights_") as root:
        t0 = time.perf_counter()
        src, dtypes, lora, sizes = write_checkpoints(root, seed, dev)
        _sync(dev)
        print(f"weights: wrote full-width checkpoints in {time.perf_counter() - t0:.1f} s: "
              + ", ".join(f"{k} {v / 2**20:.0f} MiB" for k, v in sizes.items()))
        cfg = music_config(resolution=res, sd_path="runwayml/stable-diffusion-v1-5", use_freeu=True,
                           gmflow_path=f"{root}/gmflow_sintel-0c07dcb3.pth", sod_path=f"{root}/epoch_resnet.pth",
                           lora_path=f"{root}/lora.safetensors", lora_scale=LORA_SCALE)
        t0 = time.perf_counter()
        bundle = build_models(cfg, seed=seed, device=dev)
        _sync(dev)
        t_build = time.perf_counter() - t0
    ls = bundle.load_seconds
    print(f"weights: build_models from checkpoints {t_build:.2f} s (random init and LoRA merge included); "
          "load seconds (read, convert, to the card): "
          + "; ".join(f"{k} {v['read']:.3f} + {v['convert']:.3f} + {v['to_device']:.3f} = "
                      f"{v['read'] + v['convert'] + v['to_device']:.3f}" for k, v in ls.items()))
    if sorted(ls) != sorted(src):
        fail(f"weights: loaded {sorted(ls)}, wrote {sorted(src)}")
    if not bundle.unet.cfg.use_freeu:
        fail("weights: the UNet was built without FreeU")
    check_loaded(bundle, src, dtypes, lora)
    del src

    frames, flows, _ = make_inputs(seed, n, res)
    flows_t = torch.from_numpy(flows).to(dev)
    bundle.flow_fn = lambda a, b: flows_t
    pipe = FrescoPipeline(cfg, bundle)
    pipe.sync_phases = True
    base = pipe._base_sampler_cfg
    pipe._base_sampler_cfg = dataclasses.replace(base, guidance=dataclasses.replace(base.guidance, warp_mode="sparse"))
    prompts, negs = prompts_for(cfg, n)
    _sync(dev)
    _reset_peak(dev)
    flash_attention.launches = 0
    sign_gram_apply.launches = 0
    sign_gram_apply.launches_by_shape.clear()
    bmm.launches = 0
    t0 = time.perf_counter()
    latents, _ = pipe._translate_batch(frames, prompts, negs, None, False)
    images = pipe.decode(latents)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {"flash_attn_fwd": flash_attention.launches, "sign_gram": sign_gram_apply.launches,
                "bmm": bmm.launches}
    ph = pipe.phases.times
    print(f"weights batch: {n} keyframes {res}x{res} on the loaded bundle (LoRA, FreeU, sparse warp, HED, "
          f"EGNet), wall {wall:.2f} s, peak device memory {_peak_gib(dev):.2f} GiB, "
          f"launches {launches}; phases (s, synchronized): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])))
    sign_gram_by_shape("weights batch", gram_rows)
    check_finite("weights_latents", latents)
    if images.shape != (n, res, res, 3) or images.dtype != np.uint8:
        fail(f"weights batch output {images.shape} {images.dtype}")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        fail(f"weights batch did not launch every kernel: {launches}")
    del bundle, pipe, latents
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sparse_vs_dense(seed, dev, sparse_shapes, res)


# ---------------------------------------------------------------- entry points (phase 13)
WAVE_KEYS = (0, 6, 16)      # a 17-frame clip, unequal intervals: the chains end at different steps
WAVE_DEVICES = 4            # [cuda:0] * 4: every chain of the wave on the one card
NATIVE_HW = (128, 160)      # the host backend's two easy cases
# the native backend on easy cases (tests/test_native_patchmatch.py's): mean
# |out - style| inside a 6-px margin; checker guides reconstruct the style,
# random guides make the identity match unambiguous for both backends.  Sound
# runs read 0.000-0.072 and 0.000-0.542 (seeds 0-2, 128x160); an NNF off by
# one pixel reads about 85 (printed), and each limit allows about 1-2 % of
# the pixels mapped wrong
NATIVE_RECON_MAX = 1.0
NATIVE_VS_JUMPFLOOD_MAX = 2.0
CLIP_FRAMES, CLIP_RES = 32, 512
CLIP_CHECK_FRAMES = 2       # encoded on the card and again in float64 on the host
CLIP_MAX_ABS = 1e-4         # on the unit-norm embeddings, float32 (no TF32) against float64
CARD = "card not read"      # nvidia-smi's name and power limit, set in main


def wave_inputs(seed: int, dev, hw=PROP_HW):
    """Phase 13's clip on ``dev``: WAVE_KEYS[-1] + 1 seeded frames at
    ``hw``, their styled truth, the function of their known flows, and the
    wave of its intervals as ``_synthesize_chain_wave`` takes it."""
    from fresco_torch.propagate.video_blend import _FlowCache

    keys = list(WAVE_KEYS)
    frames, flows, _ = make_inputs(seed, keys[-1] + 1, hw)
    truth = [style_of(f) for f in frames]
    flow_fn = pair_flow_fn(frames, flows, dev)
    fc = _FlowCache(flow_fn, dev)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    wave = []
    for seq_i, (beg, end) in enumerate(zip(keys[:-1], keys[1:])):
        seq = [t(frames[i]) for i in range(beg, end + 1)]
        js = list(range(end - beg - 1))
        flows_pair = (fc.get_batch(seq, js, [f"f{beg}_{j}" for j in js]),
                      fc.get_batch(seq[::-1], js, [f"b{end}_{j}" for j in js]))
        wave.append((seq_i, (t(truth[beg]), t(truth[end])), (seq, seq[::-1]), flows_pair))
    return frames, truth, flow_fn, wave


def phase_waves(seed: int, dev, hw=PROP_HW, devices=None):
    """Interval waves: ``_synthesize_chain_wave`` over ``devices`` (default
    [dev] * WAVE_DEVICES, one card; a list of distinct cards runs a chain on
    each, on a thread of its own) against ``_synthesize_chain_pair`` per
    interval on ``dev``, bit for bit; ``blend_video_frames(n_devices=1)`` on
    the same clip as the serial stage.  Returns the walls, the wave's
    row_gather and patch_eval launches and peak memory on each card, and
    the serial chains' outputs (``"serial"``) and blended frames
    (``"blend"``), which a caller may hold other runs to."""
    from fresco_torch import kernels
    from fresco_torch.propagate.gather import gather_rows
    from fresco_torch.propagate.patch_eval import patch_eval
    from fresco_torch.propagate.patchmatch import PatchMatchConfig
    from fresco_torch.propagate.video_blend import (
        _stream_seed, _synthesize_chain_pair, _synthesize_chain_wave, blend_video_frames)

    keys = list(WAVE_KEYS)
    n = keys[-1] + 1
    frames, truth, flow_fn, wave = wave_inputs(seed, dev, hw)
    _sync(dev)
    t0 = time.perf_counter()
    out = blend_video_frames(dict(enumerate(frames)), {k: truth[k] for k in keys}, keys, flow_fn=flow_fn,
                             n_devices=1, device=dev)
    _sync(dev)
    wall_blend = time.perf_counter() - t0
    psnr = _psnr(out, truth, [i for i in range(n) if i not in keys])
    cfg = PatchMatchConfig()
    _sync(dev)
    t0 = time.perf_counter()
    serial = {w[0]: _synthesize_chain_pair(*w[1:], cfg, _stream_seed(seed, w[0])) for w in wave}
    _sync(dev)
    wall_serial = time.perf_counter() - t0
    devices = [torch.device(d) for d in devices] if devices is not None else [dev] * WAVE_DEVICES
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    kernels.reset_launches()
    t0 = time.perf_counter()
    waved = _synthesize_chain_wave(wave, cfg, seed, devices)
    for c in cards:
        torch.cuda.synchronize(c)
    wall_wave = time.perf_counter() - t0
    launches = {"row_gather": gather_rows.launches, "patch_eval": patch_eval.launches}
    by_card = {c: {n: w.launches_by_card.get(c, 0)
                   for n, w in (("row_gather", gather_rows), ("patch_eval", patch_eval))} for c in cards}
    peaks = {c: torch.cuda.max_memory_allocated(c) / 2**30 for c in cards}
    same = all(torch.equal(a, b.to(a.device)) for s in serial for d in range(2) for part in range(2)
               for a, b in zip(serial[s][d][part], waved[s][d][part]))
    same = same and all(len(serial[s][d][p]) == len(waved[s][d][p]) for s in serial for d in range(2) for p in range(2))
    print(f"waves: {n} frames {hw[0]}x{hw[1]}, keys {keys}; blend_video_frames(n_devices=1) wall {wall_blend:.2f} s, "
          f"PSNR vs truth {psnr:.3f} dB; chains: serial (_synthesize_chain_pair per interval) {wall_serial:.2f} s, "
          f"wave over [{', '.join(map(str, devices))}] {wall_wave:.2f} s, "
          f"bit-equal {same}, wave launches {launches}, by card {by_card}, peak GiB by card "
          + ", ".join(f"{c} {p:.2f}" for c, p in peaks.items()) + f" ({CARD})")
    if not same:
        fail("waves: the wave's chains differ from the serial chain pairs")
    if not psnr >= PROP_PSNR_FLOOR:
        fail(f"waves: blend_video_frames PSNR {psnr} below {PROP_PSNR_FLOOR}")
    if dev.type == "cuda" and min(n for c in by_card.values() for n in c.values()) <= 0:
        fail(f"waves did not launch every propagation kernel on every card: {by_card}")
    return {"blend_serial_s": wall_blend, "chains_serial_s": wall_serial, "chains_wave_s": wall_wave,
            "bit_equal": same, "psnr_db": psnr, "devices": [str(d) for d in devices], "launches": launches,
            "launches_by_card": by_card, "peak_gib_by_card": peaks, "serial": serial, "blend": out}


def phase_ebsynth(seed: int, dev, hw=PROP_HW):
    """``ebsynth_cli.run`` (style plus two guides) against ``synthesize``
    called directly with ``TorchDraws(0)``; ``write_error_bin`` read back;
    ``main`` on PNG files where Pillow imports."""
    import os
    import tempfile

    from fresco_torch.propagate import ebsynth_cli
    from fresco_torch.propagate.patchmatch import TorchDraws, synthesize
    from fresco_torch.propagate.video_blend import _codec, read_bgr, write_bgr

    frames, _, detector = make_inputs(seed + 1, 2, hw)
    style = style_of(frames[0])
    edges = [np.repeat(detector(f)[..., None], 3, -1) for f in frames]
    opts = ebsynth_cli.parse_args("-style s -guide a b -weight 6 -guide c d -weight 0.5 -backend cuda".split())
    _sync(dev)
    t0 = time.perf_counter()
    out, err = ebsynth_cli.run(style, [frames[0], edges[0]], [frames[1], edges[1]], [6.0, 0.5], opts, dev)
    wall = time.perf_counter() - t0
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)  # noqa: E731
    wpc = torch.tensor([2.0] * 3 + [0.5 / 3] * 3, device=dev)
    ref, ref_err, _ = synthesize(f(style), f(np.concatenate([frames[0], edges[0]], -1)),
                                 f(np.concatenate([frames[1], edges[1]], -1)), wpc, ebsynth_cli.patch_config(opts),
                                 draws=TorchDraws(0, dev))
    same = (np.array_equal(out, ref.clamp(0, 255).to(torch.uint8).cpu().numpy())
            and np.array_equal(err, ref_err.cpu().numpy()))
    with tempfile.TemporaryDirectory(prefix="fresco_ebsynth_") as root:
        ebsynth_cli.write_error_bin(f"{root}/e.bin", err)
        raw = open(f"{root}/e.bin", "rb").read()
        count = int(np.frombuffer(raw[:8], np.int64)[0])
        bin_ok = count == hw[0] * hw[1] and np.array_equal(np.frombuffer(raw[8:], np.float32), err.ravel())
        try:
            _codec()
        except ImportError as e:
            png, png_ok = f"main on PNG files not run ({e})", True
        else:
            for name, img in (("s", style), ("a", frames[0]), ("b", frames[1]), ("c", edges[0]), ("d", edges[1])):
                write_bgr(f"{root}/{name}.png", img)
            ebsynth_cli.main(f"-style {root}/s.png -guide {root}/a.png {root}/b.png -weight 6 -guide {root}/c.png "
                             f"{root}/d.png -weight 0.5 -backend cuda -output {root}/o.png -device {dev}".split())
            png_ok = np.array_equal(read_bgr(f"{root}/o.png"), out) and os.path.exists(f"{root}/o.bin")
            png = f"main on PNG files (Pillow) equal to run: {png_ok}"
    print(f"ebsynth_cli: run at {hw[0]}x{hw[1]} (style + 2 guides, -backend cuda) {wall * 1e3:.1f} ms, equal to "
          f"synthesize with TorchDraws(0): {same}; error .bin count {count} round-trips: {bin_ok}; {png} ({CARD})")
    if not (same and bin_ok and png_ok):
        fail("ebsynth_cli: run, the error map or main disagrees")


def phase_native(seed: int, dev, hw=NATIVE_HW):
    """The C++ serpentine backend through ``synthesize(backend="native")``:
    identity reconstruction, and the easy case against jump-flood on the
    card (tests/test_native_patchmatch.py's checks)."""
    import os

    from fresco_torch.propagate.native import build_library
    from fresco_torch.propagate.patchmatch import PatchMatchConfig, TorchDraws, synthesize

    t0 = time.perf_counter()
    build_library()
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    h, w = hw
    m = 6
    t = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
    checker = ((np.add.outer(np.arange(h) // 8, np.arange(w) // 8) % 2) * 200 + 30)[:, :, None]
    guides = 0.8 * np.tile(checker, (1, 1, 3)) + 0.2 * rng.uniform(0, 255, (h, w, 3))
    style = rng.uniform(0, 255, (h, w, 3))
    cfg = PatchMatchConfig(patch_size=5, pm_iters=3, sv_iters=3, uniformity=0.0, num_pyramid_levels=2)
    t0 = time.perf_counter()
    out, err, _ = synthesize(t(style), t(guides), t(guides), torch.full((3,), 2.0, device=dev), cfg, backend="native")
    t_recon = time.perf_counter() - t0
    recon = float((out.cpu().numpy()[m:-m, m:-m] - style[m:-m, m:-m]).__abs__().mean())
    on_dev = out.device == dev and err.device == dev
    guides = rng.uniform(0, 255, (h, w, 3))
    style = rng.uniform(0, 255, (h, w, 3))
    cfg = PatchMatchConfig(patch_size=5, pm_iters=4, sv_iters=3, uniformity=0.0, num_pyramid_levels=1)
    args = (t(style), t(guides), t(guides), torch.full((3,), 2.0, device=dev), cfg)
    t0 = time.perf_counter()
    out_n, _, _ = synthesize(*args, backend="native")
    t_easy = time.perf_counter() - t0
    out_j, _, _ = synthesize(*args, draws=TorchDraws(seed, dev))
    d = float((out_n - out_j)[m:-m, m:-m].abs().mean())
    # a broken run for scale: the style through an NNF off by one pixel
    off_by_one = float(np.abs(np.roll(style, 1, axis=1) - style)[m:-m, m:-m].mean())
    print(f"native: {h}x{w}, g++ build {t_build:.2f} s; reconstruction (2 levels) {t_recon:.2f} s, mean |d| {recon:.3f} "
          f"(max {NATIVE_RECON_MAX}); easy case (1 level) {t_easy:.2f} s, native vs jumpflood on the card mean |d| "
          f"{d:.3f} (max {NATIVE_VS_JUMPFLOOD_MAX}); an NNF off by one pixel reads {off_by_one:.3f}; "
          f"os.cpu_count() {os.cpu_count()}; outputs on {out.device} ({CARD})")
    if not (recon < NATIVE_RECON_MAX and d < NATIVE_VS_JUMPFLOOD_MAX and on_dev and (err >= 0).all()):
        fail(f"native: reconstruction {recon}, against jumpflood {d}, on the device {on_dev}")
    if not max(NATIVE_RECON_MAX, NATIVE_VS_JUMPFLOOD_MAX) < off_by_one:
        fail(f"native: an NNF off by one pixel reads {off_by_one}, inside the limits")


def phase_flow_source(seed: int, dev, hw=PROP_HW):
    """``default_flow_fn`` from a full-width GMFlow checkpoint written from a
    seeded module: its flows equal the module's and the pipeline's loaded
    GMFlow's on one pair; ``consistency_flow_fn`` picks GMFlow (F13)."""
    import tempfile

    from fresco_torch.models import convert as C
    from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
    from fresco_torch.models.gmflow.convert import convert_gmflow, gmflow_map
    from fresco_torch.pipeline.runner import FrescoPipeline, _loaded_module, aux_dtype
    from fresco_torch.propagate.video_blend import default_flow_fn

    frames, _, _ = make_inputs(seed, 2, hw)
    a, b = (torch.from_numpy(f).to(dev).float()[None] for f in frames)
    with tempfile.TemporaryDirectory(prefix="fresco_gmflow_") as root:
        path = f"{root}/gmflow_sintel-0c07dcb3.pth"
        with torch.device("meta"):
            src = GMFlow(GMFlowConfig())
        src = _seeded_(src.to_empty(device=dev), torch.Generator(device=dev).manual_seed(seed + 15))
        torch.save({"model": {k: v.cpu() for k, v in C.to_checkpoint(src.state_dict(), gmflow_map).items()}}, path)
        t0 = time.perf_counter()
        fn = default_flow_fn(path, dev)
        _sync(dev)
        t_load = time.perf_counter() - t0
        cfg = music_config(gmflow_path=path, aux_dtype="float32")
        pipe = FrescoPipeline.__new__(FrescoPipeline)
        pipe.config, pipe.device = cfg, dev
        gm = _loaded_module(GMFlow, path, convert_gmflow, dev, aux_dtype(cfg), {}, "gmflow")
        pipe.bundle = type("Bundle", (), {"gmflow": gm, "flow_fn": None})()
        picked = pipe.consistency_flow_fn()
        with torch.no_grad():
            ref = src(a, b)
            got = fn(a, b)
            via_pipe = picked(a, b)
        ms = cuda_ms(lambda: fn(a, b), iters=5) if dev.type == "cuda" else float("nan")
    same = torch.equal(got, ref) and torch.equal(via_pipe, ref)
    print(f"flow source: default_flow_fn from a full-width GMFlow checkpoint, loaded in {t_load:.2f} s, one "
          f"{hw[0]}x{hw[1]} pair {ms:.2f} ms; flows equal to the seeded module's and to consistency_flow_fn's "
          f"(the loaded GMFlow, F13): {same} ({CARD})")
    if not same:
        fail("flow source: default_flow_fn or consistency_flow_fn differs from the checkpoint's GMFlow")


def phase_clip(seed: int, dev, cfg=None, n: int = CLIP_FRAMES, res: int = CLIP_RES):
    """CLIP vision at full width (ViT-L/14 with its projection): a seeded
    module written as a CLIPModel .safetensors, loaded bit-equal through
    ``make_clip_image_encoder``; its embeddings of a few frames against
    the same module in float64 on the host; ``evaluate_translation`` on
    ``n`` frames."""
    import copy
    import tempfile

    from fresco_torch import metrics
    from fresco_torch.models import convert as C
    from fresco_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder, image_embeddings

    cfg = cfg or CLIPVisionConfig()
    with torch.device("meta"):
        src = CLIPVisionEncoder(cfg, projection=True)
    src = _seeded_(src.to_empty(device=dev), torch.Generator(device=dev).manual_seed(seed + 16))
    with tempfile.TemporaryDirectory(prefix="fresco_clip_") as root:
        path = f"{root}/clip_model.safetensors"
        C.write_safetensors(path, C.to_checkpoint(src.state_dict(), lambda b: C.clip_vision_map(b, cfg)))
        t0 = time.perf_counter()
        enc = metrics.make_clip_image_encoder(path, dev)
        _sync(dev)
        t_load = time.perf_counter() - t0
    loaded = enc.model.state_dict()
    bits = sorted(loaded) == sorted(src.state_dict()) and all(
        _bits_equal(loaded[k], v) for k, v in src.state_dict().items())
    del src
    frames, flows, _ = make_inputs(seed, n, res)
    frames = np.stack(frames)
    flows_d = torch.from_numpy(flows).to(dev)  # make_inputs' pairs (i, i+1 mod n), as warp_error takes them
    x = torch.from_numpy(frames).to(dev)
    ms = cuda_ms(lambda: enc(x), iters=5) if dev.type == "cuda" else float("nan")
    k = CLIP_CHECK_FRAMES
    ref = copy.deepcopy(enc.model).to("cpu", torch.float64)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = image_embeddings(ref, x[:k].cpu().double() / 127.5 - 1.0, project=True)
    t_ref = time.perf_counter() - t0
    clip_err = float((enc(x[:k]).cpu().double() - want).abs().max())
    del ref
    report = metrics.evaluate_translation(frames, lambda p, q: flows_d, dev, clip_encoder=enc)
    print(f"clip vision: width {cfg.hidden_size}, {cfg.num_layers} layers, {cfg.image_size} px, patch "
          f"{cfg.patch_size}, projection {cfg.projection_dim}; loaded in {t_load:.2f} s, bit-equal {bits}; encode "
          f"{n} frames at {res} px {ms:.2f} ms; {k} frames against float64 on the host ({t_ref:.2f} s): max |d| "
          f"{clip_err:.3e} (max {CLIP_MAX_ABS}); report {report} ({CARD})")
    if not (bits and clip_err <= CLIP_MAX_ABS and report["frame_similarity_is_clip"] is True
            and np.isfinite(report["frame_similarity"]) and np.isfinite(report["warp_error"])):
        fail(f"clip vision: bit-equal {bits}, against float64 {clip_err}, report {report}")


def phase_entry_points(seed: int, dev) -> dict:
    """Phase 13: the propagation entry points and the CLI's metric."""
    walls = phase_waves(seed, dev)
    phase_ebsynth(seed, dev)
    phase_native(seed, dev)
    phase_flow_source(seed, dev)
    phase_clip(seed, dev)
    return walls


# ---------------------------------------------------------------- control detectors (phase 14)
# full-width detectors at 64 px, float32 (no TF32), card against CPU: the
# largest |d| over the largest |output|.  Read 2.35e-5, 6.9e-7 and 8.5e-6
# (H100 80GB HBM3, 700 W); each limit about 4x its reading
DET_REL = {"midas": 1e-4, "mlsd": 3e-6, "openpose": 3e-5}
# at 512x512, card against CPU: depth-image pixels 1 level apart (read
# 7.4e-4; never more than 1 level), line-map and pose-drawing pixels apart
# (read 0 of 262,144)
DEPTH_SHARE = 3e-3
MLSD_PIXEL_SHARE = 1e-3
POSE_PIXEL_SHARE = 1e-3
DET_FRAMES = 8


def _fold64(sd: dict, conv: str, bn: str):
    """Conv ``conv`` with BatchNorm ``bn`` folded in, in float64 on the host:
    w * g / sqrt(var + 1e-5), (b - mean) * g / sqrt(var + 1e-5) + beta."""
    g, beta, mu, var = (sd[f"{bn}.{n}"].double().cpu() for n in ("weight", "bias", "running_mean", "running_var"))
    scale = g / torch.sqrt(var + 1e-5)
    b = sd[f"{conv}.bias"].double().cpu() if f"{conv}.bias" in sd else torch.zeros_like(mu)
    return ((sd[f"{conv}.weight"].double().cpu() * scale[:, None, None, None]).float(),
            ((b - mu) * scale + beta).float())


def write_detector_checkpoints(root: str, seed: int, dev) -> dict:
    """Seeded full-width detector checkpoints under ``root`` in the
    reference layouts: MiDaS (timm keys, refinenet4's unused
    ``resConfUnit1`` included), M-LSD (unfolded Conv + BatchNorm), the
    OpenPose body model (the released flat keys).  Returns {detector: the
    state dict each loaded module must hold}: MiDaS and OpenPose their
    sources, M-LSD the float64 fold of its file computed here."""
    from fresco_torch.models import convert as C
    from fresco_torch.models import midas, mlsd, openpose

    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    with torch.device("meta"):
        mods = {"midas": midas.DPTHybridDepth(), "openpose": openpose.BodyPose(), "mlsd": mlsd.MLSDLarge()}
    src = {n: dict(_seeded_(m.to_empty(device=dev), gen).state_dict()) for n, m in mods.items()}
    ck = {k: v.cpu() for k, v in C.to_checkpoint(src["midas"], midas.midas_map).items()}
    for c in ("conv1", "conv2"):
        ck[f"scratch.refinenet4.resConfUnit1.{c}.weight"] = torch.zeros(256, 256, 3, 3)
        ck[f"scratch.refinenet4.resConfUnit1.{c}.bias"] = torch.zeros(256)
    torch.save(ck, f"{root}/{midas.CHECKPOINT}")
    torch.save({k.split(".", 1)[1]: v.cpu() for k, v in src["openpose"].items()}, f"{root}/{openpose.CHECKPOINT}")
    # M-LSD: each folded conv of the port becomes a conv and a BatchNorm
    mlsd_sd = {}
    folded = src.pop("mlsd")
    for dst, conv, bn in mlsd._conv_bn_pairs():
        w = folded[f"{dst}.weight"]
        mlsd_sd[f"{conv}.weight"] = w.cpu()
        if dst.startswith("block"):  # the FPN blocks' convolutions have a bias, the backbone's do not
            mlsd_sd[f"{conv}.bias"] = (torch.randn(w.shape[0], generator=gen, device=dev) * 0.05).cpu()
        o = w.shape[0]
        mlsd_sd[f"{bn}.weight"] = (0.5 + 0.5 * torch.rand(o, generator=gen, device=dev)).cpu()
        mlsd_sd[f"{bn}.bias"] = (torch.randn(o, generator=gen, device=dev) * 0.1).cpu()
        mlsd_sd[f"{bn}.running_mean"] = (torch.randn(o, generator=gen, device=dev) * 0.1).cpu()
        mlsd_sd[f"{bn}.running_var"] = (0.5 + torch.rand(o, generator=gen, device=dev)).cpu()
        mlsd_sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    for leaf in ("weight", "bias"):
        mlsd_sd[f"block23.conv3.{leaf}"] = folded[f"block23.conv3.{leaf}"].cpu()
    torch.save(mlsd_sd, f"{root}/{mlsd.CHECKPOINT}")
    src["mlsd"] = {}
    for dst, conv, bn in mlsd._conv_bn_pairs():
        src["mlsd"][f"{dst}.weight"], src["mlsd"][f"{dst}.bias"] = _fold64(mlsd_sd, conv, bn)
    src["mlsd"].update({f"block23.conv3.{leaf}": mlsd_sd[f"block23.conv3.{leaf}"] for leaf in ("weight", "bias")})
    return src


def _max_rel(a, b) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max() / b.float().abs().max())


def _timed_frames(dev, fn, frames) -> tuple[float, float]:
    """(ms for ``fn`` over every frame after a warm-up frame, peak GiB)."""
    fn(frames[0])
    _sync(dev)
    _reset_peak(dev)
    t0 = time.perf_counter()
    for f in frames:
        fn(f)
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3, _peak_gib(dev)


def check_detectors(mods: dict, src: dict, seed: int, dev, res: int = 512) -> None:
    """Loaded bit-equal to their sources; 64 px card against CPU; 8 frames
    at ``res`` timed; the detectors' outputs card against CPU."""
    import importlib.util

    from fresco_torch.models import midas, mlsd, openpose
    from fresco_torch.ops.image import _resize_area

    for name, m in mods.items():
        got = m.state_dict()
        bad = [k for k in src[name] if not _bits_equal(got[k], src[name][k].to(got[k].device))]
        if sorted(got) != sorted(src[name]) or bad:
            fail(f"detectors: {name} loaded weights differ from the source: {bad[:4]}")
    print("detectors: loaded bit-equal to their sources (float32): "
          + "; ".join(f"{n} {len(src[n])} tensors, {sum(v.numel() for v in src[n].values()) / 1e6:.1f} M params"
                      + (" (against a float64 fold of the file)" if n == "mlsd" else "") for n in mods))
    cpu = {n: copy.deepcopy(m).cpu() for n, m in mods.items()}
    g = torch.Generator().manual_seed(seed + 16)
    x3 = torch.rand(1, 64, 64, 3, generator=g) * 2 - 1
    x4 = torch.cat([x3, torch.ones(1, 64, 64, 1)], -1)
    rel = {"midas": _max_rel(mods["midas"](x3.to(dev)), cpu["midas"](x3)),
           "mlsd": _max_rel(mods["mlsd"](x4.to(dev)), cpu["mlsd"](x4)),
           "openpose": max(_max_rel(a, b) for a, b in zip(mods["openpose"](x3.to(dev) / 2), cpu["openpose"](x3 / 2)))}
    print("detectors 64 px, full width, float32 card vs CPU, max |d| / max |out|: "
          + ", ".join(f"{n} {v:.2e} (limit {DET_REL[n]})" for n, v in rel.items()) + f" ({CARD})")
    if any(rel[n] > DET_REL[n] for n in rel):
        fail("detectors: card and CPU disagree at 64 px")

    frames, _, _ = make_inputs(seed, DET_FRAMES, res)
    # the body network's input at the 368 box's scale (0.5 * 368 / height): a
    # square frame becomes 184x184 (resized here with INTER_AREA: the
    # detector's INTER_CUBIC is OpenCV's)
    side = 184
    box = lambda f: torch.as_tensor(  # noqa: E731
        _resize_area(f, side, side)[None, :, :, ::-1].copy(), device=dev).float() / 256.0 - 0.5
    have_cv2 = importlib.util.find_spec("cv2") is not None
    runs = {"MiDaS depth_detector": lambda f: midas.depth_detector(mods["midas"], f),
            "M-LSD mlsd_detector": lambda f: mlsd.mlsd_detector(mods["mlsd"], f),
            f"OpenPose BodyPose at the 368 box ({side}x{side})": lambda f: mods["openpose"](box(f))}
    if have_cv2:
        runs["OpenPose openpose_detector (with OpenCV's resizes and drawing)"] = \
            lambda f: openpose.openpose_detector(mods["openpose"], f)
    for name, fn in runs.items():
        ms, peak = _timed_frames(dev, fn, frames)
        print(f"detectors {res}x{res} {name}: {DET_FRAMES} frames {ms:.1f} ms ({ms / DET_FRAMES:.2f} ms a frame), "
              f"peak device memory {peak:.2f} GiB ({CARD})")

    f = frames[0]
    dd, dc = midas.depth_detector(mods["midas"], f), midas.depth_detector(cpu["midas"], f)
    diff = np.abs(dd.astype(int) - dc)
    # the detector's thresholds (MLSDdetector: score 0.1, distance 0.1)
    la, lc = (mlsd.pred_lines(f, m, (512, 512), 0.1, 0.1) for m in (mods["mlsd"], cpu["mlsd"]))
    md, mc = mlsd.mlsd_detector(mods["mlsd"], f), mlsd.mlsd_detector(cpu["mlsd"], f)
    maps = [tuple(t[0].float().cpu().numpy() for t in m(box(f).to(next(m.parameters()).device)))
            for m in (mods["openpose"], cpu["openpose"])]
    # decoded at the maps' own resolution (23x23 at 512 px): the peaks' places and the people
    pose = [openpose.body_decode(heat, paf, heat.shape[0]) for paf, heat in maps]
    same_peaks = np.array_equal(pose[0][0][:, [0, 1, 3]], pose[1][0][:, [0, 1, 3]])
    same_people = np.array_equal(pose[0][1][:, :18], pose[1][1][:, :18])
    print(f"detectors {res}x{res} card vs CPU: MiDaS depth image max |d| {diff.max()} level(s), share of pixels apart "
          f"{(diff > 0).mean():.2e} (limit 1 level, {DEPTH_SHARE}), depth range {dd.min()}-{dd.max()}; M-LSD "
          f"{len(la)} / {len(lc)} lines, line maps differ in {int((md != mc).sum())} of {md.size} pixels "
          f"(limit share {MLSD_PIXEL_SHARE}), {int((md > 0).sum())} line pixels; OpenPose maps max |d| / max "
          f"{max(np.abs(a - b).max() / np.abs(b).max() for a, b in zip(*maps)):.2e}, body_decode on the card's "
          f"maps: {len(pose[0][0])} peaks, {len(pose[0][1])} people (CPU's maps: {len(pose[1][0])}, "
          f"{len(pose[1][1])}), peak places equal {same_peaks}, people's parts equal {same_people} ({CARD})")
    if diff.max() > 1 or (diff > 0).mean() > DEPTH_SHARE or (md != mc).mean() > MLSD_PIXEL_SHARE:
        fail(f"detectors: card and CPU outputs disagree at {res}x{res}")
    if not (same_peaks and same_people):
        fail("detectors: body_decode finds other peaks or people in the card's maps than in the CPU's")
    if not have_cv2:
        print("detectors: OpenPose's drawing (openpose_detector, OpenCV's INTER_CUBIC and polygons) skipped: no cv2 on "
              "this machine; tests/test_torch_openpose.py holds it bit for bit against the JAX package on the CPU")
        return
    od, oc = openpose.openpose_detector(mods["openpose"], f), openpose.openpose_detector(cpu["openpose"], f)
    apart = float(np.any(od != oc, axis=-1).mean())
    print(f"detectors {res}x{res}: openpose_detector card vs CPU: share of pixels apart {apart:.2e} (limit "
          f"{POSE_PIXEL_SHARE}), {int(np.any(od > 0, axis=-1).sum())} pixels drawn ({CARD})")
    if apart > POSE_PIXEL_SHARE:
        fail("detectors: openpose_detector's drawings differ between the card and the CPU")


def phase_detectors(seed: int, dev, gram_rows=None, res: int = 512):
    """Phase 14: the three control detectors from full-width checkpoints,
    then config_boxer's depth-controlled keyframe batch from loaded weights."""
    import os
    import tempfile

    from fresco_torch.attention.flash import flash_attention
    from fresco_torch.core.config import load_config
    from fresco_torch.models import midas, mlsd, openpose
    from fresco_torch.ops.gemm import bmm
    from fresco_torch.ops.gram_kernel import sign_gram_apply
    from fresco_torch.pipeline import runner
    from fresco_torch.utils.guards import check_finite

    n = 8
    with tempfile.TemporaryDirectory(prefix="fresco_boxer_") as root:
        t0 = time.perf_counter()
        write_checkpoints(root, seed, dev)  # phase 12's files: SD1.5, GMFlow, HED, EGNet
        os.symlink(f"{root}/sd-controlnet-hed", f"{root}/sd-controlnet-depth")  # the same architecture
        det_src = write_detector_checkpoints(root, seed, dev)
        _sync(dev)
        print(f"detectors: wrote checkpoints in {time.perf_counter() - t0:.1f} s: "
              + ", ".join(f"{f} {os.path.getsize(f'{root}/{f}') / 2**20:.0f} MiB"
                          for f in (midas.CHECKPOINT, mlsd.CHECKPOINT, openpose.CHECKPOINT)))
        cfg = load_config("config/config_boxer.yaml")
        cfg = cfg.replace(sd_path=f"{root}/stable-diffusion-v1-5", gmflow_path=f"{root}/gmflow_sintel-0c07dcb3.pth",
                          sod_path=f"{root}/epoch_resnet.pth")
        if (cfg.controlnet_type, cfg.cond_scale, cfg.num_inference_steps, cfg.num_warmup_steps, cfg.end_opt_step,
                cfg.use_freeu, cfg.use_saliency, cfg.batch_size) != ("depth", 0.7, 20, 5, 15, False, True, 8):
            fail(f"boxer: config/config_boxer.yaml's settings changed: {cfg}")
        t0 = time.perf_counter()
        bundle = runner.build_models(cfg, seed=seed, device=dev)
        _sync(dev)
        t_build = time.perf_counter() - t0
        times = {}
        mods = {"midas": bundle.detector.args[0],
                "mlsd": runner._build_detector(cfg.replace(controlnet_type="mlsd"), False, dev, None, False,
                                               times).args[0]}
        pose_cfg = cfg.replace(controlnet_type="openpose")
        if runner._have_cv2():
            mods["openpose"] = runner._build_detector(pose_cfg, False, dev, None, False, times).args[0]
        else:  # the detector needs OpenCV: load its network as _build_detector would
            try:
                runner._build_detector(pose_cfg, False, dev, None, False)
                fail("detectors: _build_detector built OpenPose without cv2")
            except ImportError as e:
                print(f"detectors: _build_detector('openpose') raises without OpenCV, as it should: {e}")
            mods["openpose"] = runner._loaded_module(openpose.BodyPose, f"{root}/{openpose.CHECKPOINT}",
                                                     openpose.convert_openpose, dev, torch.float32, times,
                                                     "openpose")
    ls = {**bundle.load_seconds, **times}
    print(f"boxer: build_models from checkpoints {t_build:.2f} s; detector {bundle.detector.func.__name__}; load "
          "seconds (read, convert, to the card): "
          + "; ".join(f"{k} {v['read'] + v['convert'] + v['to_device']:.3f}" for k, v in ls.items()))
    if bundle.detector.func is not midas.depth_detector or "midas" not in ls or bundle.saliency_fn is None:
        fail("boxer: build_models did not load the MiDaS detector and EGNet")
    check_detectors(mods, det_src, seed, dev, res)
    del det_src, mods

    frames, _, _ = make_inputs(seed, n, res)
    pipe = runner.FrescoPipeline(cfg, bundle)
    pipe.sync_phases = True
    prompts, negs = prompts_for(cfg, n)
    seen = []
    hook = bundle.controlnet.controlnet_cond_embedding.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].detach().clone()))
    _sync(dev)
    _reset_peak(dev)
    flash_attention.launches = 0
    sign_gram_apply.launches = 0
    sign_gram_apply.launches_by_shape.clear()
    bmm.launches = 0
    t0 = time.perf_counter()
    latents, _ = pipe._translate_batch(frames, prompts, negs, None, False)
    images = pipe.decode(latents)
    _sync(dev)
    wall = time.perf_counter() - t0
    hook.remove()
    launches = {"flash_attn_fwd": flash_attention.launches, "sign_gram": sign_gram_apply.launches,
                "bmm": bmm.launches}
    ph = pipe.phases.times
    print(f"boxer batch: {n} keyframes {res}x{res}, config_boxer (depth, cond_scale {cfg.cond_scale}, "
          f"{cfg.num_inference_steps} steps, warmup {cfg.num_warmup_steps}, end_opt_step {cfg.end_opt_step}, no FreeU, "
          f"EGNet saliency, GMFlow flows) on loaded weights: wall {wall:.2f} s, control_detector "
          f"{ph.get('control_detector', 0.0):.3f} s, denoise loop {ph.get('denoise_loop', 0.0):.3f} s, peak device "
          f"memory {_peak_gib(dev):.2f} GiB, launches {launches}; phases (s, synchronized): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])) + f" ({CARD})")
    sign_gram_by_shape("boxer batch", gram_rows)
    check_finite("boxer_latents", latents)
    if images.shape != (n, res, res, 3) or images.dtype != np.uint8:
        fail(f"boxer batch output {images.shape} {images.dtype}")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        fail(f"boxer batch did not launch every kernel: {launches}")
    # watch-point 8: the ControlNet embedded the detector's depth maps
    depth = np.stack([midas.depth_detector(bundle.detector.args[0], f) for f in frames])
    want = (torch.as_tensor(depth, device=dev)[..., None].float() / 255.0).expand(n, res, res, 3)
    want = torch.cat([want] * 2).to(bundle.controlnet.dtype)
    if len(seen) != 1 or seen[0].shape != want.shape or not torch.equal(seen[0], want):
        fail(f"boxer: the ControlNet's condition is not the detector's depth maps ({len(seen)} embeddings)")
    print(f"boxer: the ControlNet embedded the detector's depth maps, equal to a second detector run "
          f"({n} frames, std of the maps {float(depth.std()):.1f} levels, frames apart "
          f"{int(np.any(depth != depth[:1], axis=(1, 2)).sum())} of {n - 1})")
    del bundle, pipe, latents
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- training
TRAIN_ATTN = ((4096, 40), (1024, 80), (256, 160))  # the UNet's self-attention (S, d) at 512 px, batch 2 x 8 heads
# flash's gradient on the card against autograd through naive_attention on the
# same bf16 inputs, max |d| / max |grad|: the backward IS that VJP, recomputed
# from the saved inputs.  Read 0 at every shape (H100 80GB HBM3, 700 W); the
# limit allows a reduction in another order (bf16's step is 3.9e-3), where a
# lost scale or mask moves the gradients by O(1)
FLASH_GRAD_REL = 1e-3
TRAIN_STEPS = 3
TRAIN_FLASH_PER_STEP = 16  # self-attentions in one SD1.5 UNet forward (6 down, 1 mid, 9 up)
# one UNet step with the kernel against the same step with naive_attention
# forced (same weights, t, noise, bf16 compute): the kernel rounds P to bf16
# before P·V.  Read: loss 4.2e-5 apart, gradients 7.9e-3 (conv_out) to
# 2.0e-2 (conv_in, the far end of the backward) of their largest
TRAIN_LOSS_REL = 1e-3
TRAIN_GRAD_REL = 5e-2
TRAIN_GRAD_PARAMS = ("conv_in.weight", "down_0_attn_0.block.attn1.to_q.weight", "conv_out.weight")
GMFLOW_HW = (384, 512)
# one supervised GMFlow step at 64x64, float32 (TF32 off), card against CPU.
# Read: loss 5.4e-6 apart, gradients 3.9e-5 of the largest
GMFLOW_LOSS_REL = 1e-4
GMFLOW_GRAD_REL = 1e-3


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, on the host in float32."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def train_flash_grad(seed: int, dev) -> None:
    """F18 on the card: flash's output carries a grad_fn, and its dq / dk /
    dv equal autograd through naive_attention, at the UNet's self-attention
    shapes and one masked case with empty rows; forward + backward timed
    beside naive's and SDPA's."""
    from fresco_torch.attention.flash import flash_attention, naive_attention

    gen = torch.Generator(device=dev).manual_seed(seed + 150)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [(f"self S={s} d={d}", s, d, False) for s, d in TRAIN_ATTN] + [("masked S=1024 d=80", 1024, 80, True)]
    for name, s, d, masked in cases:
        q, k, v, g = (torch.randn(2, 8, s, d, generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
        mask = None
        if masked:
            mask = torch.rand(2, s, generator=gen, device=dev) > 0.5
            mask[1] = False  # no valid key: zero output, zero gradients
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*qkv, mask)
        if out.grad_fn is None:
            fail(f"train flash {name}: the kernel's output has no grad_fn (F18)")
        out.backward(g)
        ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
        naive_attention(*ref_in, mask).backward(g)
        rels = [_rel(a.grad, b.grad) for a, b in zip(qkv, ref_in)]
        empty = all(bool((t[1] == 0).all()) for t in (out, *(x.grad for x in qkv))) if masked else None
        times = {}
        if dev.type == "cuda":
            times = {"kernel": cuda_ms(lambda: flash_attention(*qkv, mask).backward(g), 5),
                     "plain": cuda_ms(lambda: naive_attention(*qkv, mask).backward(g), 5)}
            if not masked:
                times["sdpa"] = cuda_ms(lambda: sdpa(*qkv).backward(g), 5)
            times["kernel fwd"] = cuda_ms(lambda: flash_attention(q, k, v, mask), 5)
        print(f"train flash {name} [2,8,{s},{d}] bf16: grad_fn {type(out.grad_fn).__name__}; dq/dk/dv max|d|/max|g| "
              + "/".join(f"{r:.3e}" for r in rels) + f" (limit {FLASH_GRAD_REL})"
              + ("" if empty is None else f"; empty row: output and gradients zero {empty}")
              + "; ms forward+backward " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + f" ({CARD})")
        if max(rels) > FLASH_GRAD_REL or empty is False:
            fail(f"train flash {name}: gradients differ from naive_attention's VJP")


def _train_unet(seed: int, dev, cfg):
    from fresco_torch.models.layers import set_compute_dtype
    from fresco_torch.models.unet import UNet2DCondition

    with torch.device("meta"):
        unet = UNet2DCondition(cfg)
    unet = _seeded_(unet.to_empty(device=dev), torch.Generator(device=dev).manual_seed(seed + 151))
    return set_compute_dtype(unet.train().requires_grad_(True), torch.bfloat16)


def train_unet(seed: int, dev, cfg=None, res: int = 512) -> None:
    """The UNet fine-tuning step at full SD1.5 width: float32 parameters
    computing in bf16, batch 2 at res px, AdamW 1e-5, TRAIN_STEPS steps
    (flash launched in every self-attention, the gradient through it);
    then one step with the kernel against the same step with naive_attention
    forced in its place."""
    from fresco_torch.attention import fresco_attention
    from fresco_torch.attention.flash import flash_attention, naive_attention
    from fresco_torch.diffusion.scheduler import DDPMScheduler
    from fresco_torch.models.unet import UNetConfig
    from fresco_torch.parallel import TrainState, make_train_state, train_step

    cfg = cfg or UNetConfig()
    gen = torch.Generator(device=dev).manual_seed(seed + 152)
    lat = torch.randn(2, res // 8, res // 8, 4, generator=gen, device=dev)
    ctx = torch.randn(2, 77, cfg.cross_attention_dim, generator=gen, device=dev)
    sched = DDPMScheduler()
    _sync(dev)
    _reset_peak(dev)
    t0 = time.perf_counter()
    unet = _train_unet(seed, dev, cfg)
    state = make_train_state(unet, lr=1e-5)
    n_params = sum(p.numel() for p in unet.parameters())
    _sync(dev)
    t_build = time.perf_counter() - t0
    watch = {n: p for n, p in unet.named_parameters() if n in TRAIN_GRAD_PARAMS}
    flash_attention.launches = 0
    secs, losses, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = {n: p.detach().clone() for n, p in watch.items()}
        n0 = flash_attention.launches
        t0 = time.perf_counter()
        state, loss = train_step(state, sched, lat, ctx, seed=seed)
        loss = float(loss)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        per_step.append(flash_attention.launches - n0)
        if not math.isfinite(loss):
            fail(f"train unet: non-finite loss {loss}")
        still = [n for n, p in watch.items() if torch.equal(p.detach(), before[n])]
        if still:
            fail(f"train unet: parameters did not move: {still}")
    launches = flash_attention.launches
    peak = _peak_gib(dev)
    print(f"train unet: UNet {cfg.block_out_channels} {n_params / 1e6:.1f} M float32 parameters, bf16 compute, batch 2 at {res} px "
          f"({res // 8}x{res // 8}x4 latents), 77x{cfg.cross_attention_dim} context, AdamW 1e-5: built in "
          f"{t_build:.2f} s; {TRAIN_STEPS} steps, losses {', '.join(f'{x:.5f}' for x in losses)}; step seconds "
          f"{', '.join(f'{x:.3f}' for x in secs)} (median after the first {float(np.median(secs[1:])):.3f}); peak "
          f"device memory {peak:.2f} GiB; flash launches {launches} ({per_step} a step) ({CARD})")
    if dev.type == "cuda" and per_step != [TRAIN_FLASH_PER_STEP] * TRAIN_STEPS:
        fail(f"train unet: flash launched {per_step} times a step, expected {TRAIN_FLASH_PER_STEP}")

    # the kernel step against the naive step: the same weights, t and noise
    t = torch.randint(0, 1000, (2,), generator=gen, device=dev)
    noise = torch.randn(lat.shape, generator=gen, device=dev)
    del state
    results = {}
    for name, attn in (("kernel", flash_attention), ("naive", naive_attention)):
        fresco_attention.flash_attention = attn
        try:
            st = TrainState(unet, torch.optim.SGD(unet.parameters(), lr=0.0))
            _, loss = train_step(st, sched, lat, ctx, t=t, noise=noise)
            results[name] = (float(loss), {n: p.grad.detach().clone() for n, p in watch.items()})
        finally:
            fresco_attention.flash_attention = flash_attention
    (lk, gk), (ln, gn) = results["kernel"], results["naive"]
    loss_rel = abs(lk - ln) / abs(ln)
    grad_rel = {n: _rel(gk[n], gn[n]) for n in TRAIN_GRAD_PARAMS}
    print(f"train unet: one step with the kernel against naive_attention forced (same weights, t, noise): loss "
          f"{lk:.6f} vs {ln:.6f}, relative {loss_rel:.3e} (limit {TRAIN_LOSS_REL}); gradients max|d|/max|g| "
          + ", ".join(f"{n} {r:.3e}" for n, r in grad_rel.items()) + f" (limit {TRAIN_GRAD_REL})")
    if loss_rel > TRAIN_LOSS_REL or max(grad_rel.values()) > TRAIN_GRAD_REL:
        fail("train unet: the kernel step and the naive step disagree")
    del unet, results, gk, gn, watch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def train_gmflow(seed: int, dev, cfg=None, hw=GMFLOW_HW) -> None:
    """GMFlow at full width, batch 2: two supervised steps on SyntheticIndex
    pairs and two unsupervised steps on make_inputs frames written as PNGs
    and read by index_frame_dir and FlowLoader; then one supervised 64x64
    step on the card against the same step on the CPU, float32."""
    import copy as copy_
    import tempfile

    from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
    from fresco_torch.models.layers import init_flax_default_
    from fresco_torch.parallel import flow_data as fd
    from fresco_torch.parallel.flow_train import flow_train_step, make_flow_train_state
    from fresco_torch.scripts.train_gmflow import SyntheticIndex

    cfg = cfg or GMFlowConfig()
    cpu = torch.device("cpu")
    src = init_flax_default_(GMFlow(cfg), torch.Generator().manual_seed(seed + 153))
    for mode in ("supervised", "unsupervised"):
        model = copy_.deepcopy(src).to(dev)
        state = make_flow_train_state(model, steps=4)
        with tempfile.TemporaryDirectory(prefix="fresco_frames_") as root:
            if mode == "supervised":
                index = SyntheticIndex(size=4, hw=hw, seed=seed)
            else:
                from PIL import Image  # flow_data.read_image decodes through Pillow

                for i, f in enumerate(make_inputs(seed, 5, hw)[0]):
                    Image.fromarray(f).save(f"{root}/{i:04d}.png")
                index = fd.index_frame_dir(root)
            _sync(dev)
            _reset_peak(dev)
            losses, secs = [], []
            t_all = time.perf_counter()
            for batch in fd.FlowLoader(index, 2, seed=seed, device=dev):
                t0 = time.perf_counter()
                extra = (batch["flow"], batch["valid"]) if mode == "supervised" else ()
                state, loss = flow_train_step(state, batch["img0"], batch["img1"], *extra)
                losses.append(float(loss))
                _sync(dev)
                secs.append(time.perf_counter() - t0)
            t_all = time.perf_counter() - t_all
        if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
            fail(f"train gmflow {mode}: losses {losses}")
        print(f"train gmflow {mode}: GMFlow {cfg.feature_channels} channels, {cfg.num_transformer_layers} layers, "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
              f"parameters, batch 2 at {hw[0]}x{hw[1]}, {len(losses)} steps ({len(index)} pairs from "
              f"{'SyntheticIndex' if mode == 'supervised' else 'PNGs via index_frame_dir'}, FlowLoader): losses "
              f"{', '.join(f'{x:.5f}' for x in losses)}; step seconds {', '.join(f'{x:.3f}' for x in secs)}, "
              f"{t_all:.2f} s with loading; peak device memory {_peak_gib(dev):.2f} GiB ({CARD})")
        del model, state

    # card vs CPU: one supervised step at 64x64, float32
    img0, img1, flow, valid = (torch.from_numpy(a[None]).repeat(2, *[1] * a.ndim)
                               for a in SyntheticIndex(size=1, hw=(64, 64), seed=seed).load(0))
    out = []
    for d in (dev, cpu):
        model = copy_.deepcopy(src).to(d)
        state = make_flow_train_state(model, steps=4)
        _, loss = flow_train_step(state, *(x.to(d) for x in (img0, img1, flow, valid)))
        out.append((float(loss), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}))
    (lc, gc), (lh, gh) = out
    loss_rel = abs(lc - lh) / abs(lh)
    grad_abs = max((gc[n] - gh[n]).abs().max().item() for n in gh)
    grad_max = max(g.abs().max().item() for g in gh.values())
    print(f"train gmflow 64x64 supervised step, float32, card vs CPU: loss {lc:.6f} vs {lh:.6f}, relative "
          f"{loss_rel:.3e} (limit {GMFLOW_LOSS_REL}); largest gradient difference {grad_abs:.3e} of largest "
          f"gradient {grad_max:.3e}, {grad_abs / grad_max:.3e} (limit {GMFLOW_GRAD_REL})")
    if loss_rel > GMFLOW_LOSS_REL or grad_abs / grad_max > GMFLOW_GRAD_REL:
        fail("train gmflow: card and CPU disagree")


def train_driver(seed: int, dev, tiny: bool = False) -> None:
    """fresco_torch/scripts/train_gmflow.py --synthetic --steps 4 --ckpt-every 2
    on the card, then --resume of step_2: the loaded parameters bit-equal to
    the saved ones."""
    import os
    import tempfile

    from fresco_torch.scripts import train_gmflow as drv
    from fresco_torch.utils.checkpoint import load_params

    with tempfile.TemporaryDirectory(prefix="fresco_ckpt_") as root:
        common = ["--synthetic", "--device", str(dev), "--seed", str(seed)] + (["--tiny"] if tiny else [])
        t0 = time.perf_counter()
        run = drv.main(common + ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", root, "--log-every", "1"])
        _sync(dev)
        t_run = time.perf_counter() - t0
        files = sorted(os.listdir(root))
        final = load_params(f"{root}/final")
        saved_equal = all(torch.equal(final[k], v.cpu()) for k, v in run["model"].state_dict().items())
        back = drv.main(common + ["--steps", "0", "--resume", f"{root}/step_2"])
        step2 = load_params(f"{root}/step_2")
        loaded_equal = all(torch.equal(step2[k], v.cpu()) for k, v in back["model"].state_dict().items())
        moved = any(not torch.equal(step2[k], final[k]) for k in final)
    print(f"train driver: train_gmflow --synthetic --steps 4 --ckpt-every 2 on {dev}: {run['done']} steps in "
          f"{t_run:.2f} s, losses {', '.join(f'{x:.4f}' for x in run['losses'])}, files {files}; final equal to the "
          f"trained module {saved_equal}; --resume step_2 loads it bit-equal {loaded_equal}; steps 3-4 moved the "
          f"weights {moved}")
    if run["done"] != 4 or files != ["final", "step_2", "step_4"] or not (saved_equal and loaded_equal and moved):
        fail("train driver: checkpoint or resume failed")


def phase_train(seed: int, dev, unet_cfg=None, res: int = 512, gmflow_cfg=None, gmflow_hw=GMFLOW_HW,
                tiny_driver: bool = False) -> None:
    """Phase 15: flash's gradient (F18), the UNet fine-tuning step and the
    GMFlow steps at full width, and the GMFlow training driver."""
    train_flash_grad(seed, dev)
    train_unet(seed, dev, unet_cfg, res)
    train_gmflow(seed, dev, gmflow_cfg, gmflow_hw)
    train_driver(seed, dev, tiny_driver)


# ---------------------------------------------------------------- webui
WEBUI_FRAMES = 48            # data/music.mp4 cut with the WebUI's frame_count
WEBUI_INTERVALS = (4, 8)     # config_music's 10 / 30 select 3 keyframes in 48 frames (one batch); 4 / 8 select 10
WEBUI_SECOND = dict(num_inference_steps=12, x0_strength=0.75, use_intraattn=False, use_interattn=False)


def phase_webui(seed: int, dev, tiny: bool = False, n: int = WEBUI_FRAMES, res: int | None = None) -> None:
    """Phase 16: the WebUI's handlers on config_music from its file, read
    through example_inputs: process1, a second get_pipeline with other steps,
    strength and attention toggles (the same pipeline, no second
    build_models) and process1 again, process2 into blend.mp4, then a
    controlnet_type change to depth, which must rebuild.  The clip is decoded
    with this machine's cv2; a decode that fails raises."""
    import inspect
    import os
    import tempfile

    import cv2
    from PIL import Image

    from fresco_torch import kernels, webui
    from fresco_torch.ops.image import resize_image
    from fresco_torch.pipeline import runner
    from fresco_torch.utils import clips

    root = os.path.dirname(os.path.abspath(__file__))
    names = list(inspect.signature(webui.ui_to_config).parameters)
    ui = dict(zip(names, webui.example_inputs(os.path.join(root, "config", "config_music.yaml"))))
    ui["file_path"] = os.path.normpath(os.path.join(root, ui["file_path"]))
    decoded = clips.read_frames(ui["file_path"], n)
    if decoded is None or len(decoded) != n:
        fail(f"webui: decoding {ui['file_path']} gave {None if decoded is None else len(decoded)} frames, "
             f"not {n}")
    print(f"webui: {ui['file_path']} decoded by cv2: {n} frames {decoded[0].shape[1]}x{decoded[0].shape[0]}")
    mininterv, maxinterv = WEBUI_INTERVALS
    ui.update(frame_count=n, mininterv=mininterv, maxinterv=maxinterv, seed=seed)
    if res is not None:
        ui["resolution"] = res
    if tiny:
        ui.update(num_inference_steps=4, x0_strength=0.75)
    builds = []
    real_build = runner.build_models

    def counting_build(config, **kw):
        builds.append(config.controlnet_type)
        return real_build(config, **kw)

    def detector_name(pipe) -> str:
        return getattr(pipe.bundle.detector, "func", pipe.bundle.detector).__name__

    def action(label, fn):
        before = kernels.launches()
        _reset_peak(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        wall = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in kernels.launches().items()}
        print(f"webui: {label}: {wall:.2f} s, peak {_peak_gib(dev):.2f} GiB, launches {delta}, {CARD}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        ui["save_path"] = os.path.join(tmp, "music") + os.sep
        old_state = webui.STATE
        webui.STATE = webui.GlobalState(device=dev, random_aux_weights=True)
        runner.build_models = counting_build
        try:
            kernels.reset_launches()
            cfg = webui.ui_to_config(*[ui[k] for k in names])
            keys = action("process1", lambda: webui.process1(cfg, tiny=tiny))
            pipe = webui.STATE.pipeline
            written = sorted(os.listdir(os.path.join(cfg.save_path, "video")))
            if written != [f"{i:04d}.png" for i in range(n)]:
                fail(f"webui: process1 wrote {len(written)} input frames, not {n}")
            for i in (0, n - 1):
                png = np.asarray(Image.open(os.path.join(cfg.save_path, "video", f"{i:04d}.png")))
                if not np.array_equal(png, resize_image(decoded[i], cfg.resolution)):
                    fail(f"webui: frame {i} written by process1 is not the decoded clip's")
            batches = runner.keyframe_sublists(keys, cfg.batch_size)
            det = detector_name(pipe)
            print(f"webui: {len(keys)} keyframes {keys} in {len(batches)} batches, frames "
                  f"{png.shape[1]}x{png.shape[0]}, detector {det}, saliency {'on' if pipe.bundle.saliency_fn else 'off'}")
            if len(batches) < 2:
                fail(f"webui: {len(batches)} keyframe batch; the phase needs two")
            if not tiny and (det != "hed_detector" or pipe.bundle.saliency_fn is None):
                fail(f"webui: config_music built detector {det} and saliency {pipe.bundle.saliency_fn}")

            ui.update(WEBUI_SECOND)
            cfg2 = webui.ui_to_config(*[ui[k] for k in names])
            pipe2 = action("get_pipeline (steps, strength, attention toggles)",
                           lambda: webui.STATE.get_pipeline(cfg2, tiny=tiny))
            if pipe2 is not pipe or builds != [cfg.controlnet_type]:
                fail(f"webui: the second get_pipeline rebuilt (builds {builds})")
            sc = pipe.sampler.scheduler
            if (pipe.config is not cfg2 or sc.num_inference_steps != cfg2.num_inference_steps
                    or pipe._base_sampler_cfg.num_warmup_steps != cfg2.num_warmup_steps
                    or pipe._base_sampler_cfg.step_interattn_end <= 1000):
                fail("webui: set_config did not take the new steps, strength and toggles")
            keys2 = action("process1 again", lambda: webui.process1(cfg2, tiny=tiny))
            if keys2 != keys or builds != [cfg.controlnet_type]:
                fail(f"webui: the second process1 gave keys {keys2} with builds {builds}")

            out = action("process2", lambda: webui.process2(cfg2, keys2))
            cap = cv2.VideoCapture(out)
            shown = 0
            while True:
                ok, f = cap.read()
                if not ok:
                    break
                shown += 1
                if f.shape != png.shape:
                    fail(f"webui: blend.mp4 frame of shape {f.shape}, not {png.shape}")
            cap.release()
            blended = sorted(os.listdir(os.path.join(cfg.save_path, "blend")))
            print(f"webui: blend.mp4 {os.path.getsize(out)} bytes, {shown} frames read back, {len(blended)} PNGs")
            if shown != n or len(blended) != n:
                fail(f"webui: blend.mp4 holds {shown} frames and blend/ {len(blended)}, not {n}")

            ui["controlnet_type"] = "depth"
            cfg3 = webui.ui_to_config(*[ui[k] for k in names])
            del pipe, pipe2  # get_pipeline drops its own reference before the depth build
            pipe3 = action("get_pipeline (controlnet_type depth)", lambda: webui.STATE.get_pipeline(cfg3, tiny=tiny))
            det = detector_name(pipe3)
            depth = pipe3.bundle.detector(resize_image(decoded[0], cfg3.resolution))
            print(f"webui: rebuilt for depth: builds {builds}, detector {det}, map {depth.shape} {depth.dtype}")
            if builds != [cfg.controlnet_type, "depth"] or (not tiny and det != "depth_detector"):
                fail(f"webui: the depth change did not rebuild once into MiDaS (builds {builds}, detector {det})")
        finally:
            runner.build_models = real_build
            webui.STATE = old_state
    launches = kernels.launches()
    print(f"webui: launches over the phase {launches} (bmm as the sign-gram apply), {CARD}")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        fail(f"webui did not launch every main-path kernel: {launches}")


# ---------------------------------------------------------------- mesh
MESH_SHAPES = ((2, 1), (1, 2), (2, 2))   # (data, model); on one card every rank shares cuda:0, over gloo
MESH_FRAMES = 8
# config_music's settings with the denoise loop cut from 20 steps (17 after
# warmup) to 4 (2 after warmup): the comparison needs every mechanism, not
# every step, and a step over gloo through host memory costs ~10x one alone;
# feature optimization (20 Adam iterations) in both, background smoothing in the last
MESH_STEPS = dict(num_inference_steps=4, num_warmup_steps=2, end_opt_step=4, bg_smoothing_steps=(3,))
# Sharded against single on the card, bf16 (H100 80GB HBM3, 700 W), read
# with known flows and only the UNet and ControlNet split.  The
# witness (smoke.rank_sized_layers: one process doing a rank's arithmetic,
# no collective) reads what kernels run at a rank's shapes, row places and
# TP partial sums alone move the single run: latents 5.10e-2 (2, 1),
# 5.30e-2 (1, 2), 5.96e-2 (2, 2) relative, two random-weight denoise steps
# at guidance 7.5 amplifying one rounding to that; decoded PSNR 24.60,
# 24.33, 23.66 dB.  Every rank's latents equal its witness's bit for bit
# with feature optimization off (read 0.0 at each shape in three calls), so
# MESH_WITNESS_REL holds the sharded run to the witness's arithmetic: one
# differing rounding would read ~5e-2.  With it on, the feature
# optimization's sums over data ranks round otherwise: decoded PSNR against
# the witness 27.21 (2, 1), inf (1, 2), 28.95 dB (2, 2).  The vs-single
# bounds leave about 2x the witness's own distance (the runs are
# deterministic); the training step's loss read 2.04e-4, gradients 2.05e-2.
MESH_WITNESS_REL = 1e-3           # optimization off: latents vs the witness, relative Frobenius
MESH_PSNR_WITNESS_FLOOR = 24.0    # optimization on: decoded frames vs the witness, dB
MESH_LATENT_REL = 0.12            # optimization off: latents vs single, relative Frobenius
MESH_PSNR_FLOOR = 20.0            # optimization on: decoded frames vs single, dB
MESH_TRAIN_LOSS_REL = 1e-3
MESH_TRAIN_GRAD_REL = 5e-2   # max |d| / max |g|, as phase 15's kernel-vs-naive step
MESH_TIMEOUT_S = 900         # a world's rendezvous and each of its collectives


def _mesh_batches(seed: int, dev, mesh_shape, tiny: bool = False, res: int = 512, witness=None,
                  steps=MESH_STEPS) -> dict:
    """config_music's batch of MESH_FRAMES keyframes (its denoise loop at
    ``steps``) on this process's mesh, the bundle's GMFlow the flow source,
    with feature optimization off and then on: the latents of the first,
    the decoded frames of the second, the wall, peak memory and kernel
    launches of each, and each model's split layers and parameter bytes on
    this rank (``sharding.split_report``).  ``witness``: the single process
    doing a rank's arithmetic of that (data, model) mesh
    (``smoke.rank_sized_layers``)."""
    import contextlib

    from fresco_torch import kernels
    from fresco_torch.parallel.sharding import split_report
    from fresco_torch.parallel.smoke import rank_sized_layers
    from fresco_torch.pipeline.runner import FrescoPipeline, build_models

    cfg = music_config(mesh_shape=tuple(mesh_shape), resolution=res, use_fresco_opt=False, **steps)
    t0 = time.perf_counter()
    bundle = build_models(cfg, tiny=tiny, seed=seed, device=dev, random_aux_weights=True)
    frames, _, detector = make_inputs(seed, MESH_FRAMES, res)
    bundle.detector = detector
    pipe = FrescoPipeline(cfg, bundle)
    if bundle.flow_fn is not None or bundle.gmflow is None:
        fail("mesh: the batch must take its flows from the bundle's GMFlow")
    out = {"build_s": time.perf_counter() - t0, "split": split_report(bundle)}
    prompts, negs = prompts_for(cfg, MESH_FRAMES)
    interframe, seen = pipe._interframe, []

    def keep_flows(frames_255):  # GMFlow's flows and occlusion masks of the first batch, whole on every rank
        got = interframe(frames_255)
        seen.append(got)
        return got

    pipe._interframe = keep_flows
    with rank_sized_layers(bundle, *witness) if witness else contextlib.nullcontext():
        for opt in (False, True):
            pipe.set_config(cfg.replace(use_fresco_opt=opt))
            kernels.reset_launches()
            _reset_peak(dev)
            t0 = time.perf_counter()
            latents, _ = pipe._translate_batch(frames, prompts, negs, None, False)
            images = pipe.decode(latents)
            _sync(dev)
            key = "opt" if opt else "plain"
            out[key] = {"latents": latents.float().cpu(), "images": images, "wall_s": time.perf_counter() - t0,
                        "peak_gib": _peak_gib(dev), "launches": kernels.launches()}
    flows, occs, _, _ = seen[0]
    out["flows"], out["occ"] = torch.cat(list(flows)).float().cpu(), torch.cat(list(occs)).cpu()
    return out


def _mesh_train(seed: int, dev, mesh=None, cfg=None, res: int = 512) -> dict:
    """One UNet training step at full width (phase 15's UNet, batch 2, bf16
    compute), SGD at lr 0 so the gradients are read as they are: the loss
    and the gradients of TRAIN_GRAD_PARAMS, the whole batch's on every rank."""
    from fresco_torch.diffusion.scheduler import DDPMScheduler
    from fresco_torch.models.unet import UNetConfig
    from fresco_torch.parallel import TrainState, train_step

    cfg = cfg or UNetConfig()
    gen = torch.Generator(device=dev).manual_seed(seed + 171)
    lat = torch.randn(2, res // 8, res // 8, 4, generator=gen, device=dev)
    ctx = torch.randn(2, 77, cfg.cross_attention_dim, generator=gen, device=dev)
    unet = _train_unet(seed, dev, cfg)
    st = TrainState(unet, torch.optim.SGD(unet.parameters(), lr=0.0))
    t0 = time.perf_counter()
    _, loss = train_step(st, DDPMScheduler(), lat, ctx, seed=seed, mesh=mesh)
    loss = float(loss)
    _sync(dev)
    grads = {n: p.grad.detach().float().cpu() for n, p in unet.named_parameters() if n in TRAIN_GRAD_PARAMS}
    return {"loss": loss, "grads": grads, "step_s": time.perf_counter() - t0, "peak_gib": _peak_gib(dev)}


def rank_where(dev) -> dict:
    """This rank's backend, card index and the card's name, as read."""
    import torch.distributed as dist

    cuda = dev.type == "cuda"
    return {"backend": dist.get_backend(), "card": dev.index if cuda else None,
            "name": torch.cuda.get_device_name(dev) if cuda else "cpu"}


def check_where(label: str, where: list[dict], dev) -> str:
    """Fail unless rank r of a world lies on card r modulo the visible
    cards with the backend that ``choose_backend`` gives such a world, as
    ``launch`` deals them; returns the line that says where the ranks ran."""
    from fresco_torch.parallel.distributed import choose_backend

    cuda = dev.type == "cuda"
    n_cards = torch.cuda.device_count() if cuda else 0
    backend = choose_backend(dev.type, len(where), n_cards)[0]
    for r, w in enumerate(where):
        card = r % n_cards if cuda else None
        if w["backend"] != backend or w["card"] != card:
            fail(f"{label} rank {r}: {w['backend']} on card {w['card']}, expected {backend} on card {card}")
    if not cuda:
        return f"{len(where)} ranks over {backend} on the CPU"
    return (f"{len(where)} ranks over {backend}: " + ", ".join(f"rank {r} on card {w['card']} ({w['name']})"
                                                             for r, w in enumerate(where))
            + ("; the ranks share a card" if len(where) > n_cards else "; a card a rank"))


def _wave_clip(seed: int, dev, keys, hw):
    """Phase 13's clip (``keys`` at ``hw``) as ``blend_video_frames`` takes
    it: the frames, the styled keyframes and the flow function."""
    frames, flows, _ = make_inputs(seed, keys[-1] + 1, hw)
    return (dict(enumerate(frames)), {k: style_of(frames[k]) for k in keys}, pair_flow_fn(frames, flows, dev))


def _mesh_wave(rank: int, seed: int, dev, keys, hw) -> dict:
    """Phase 13's wave clip (``keys`` at ``hw``) through
    ``blend_video_frames(n_devices="auto")`` over this world's ranks, a
    chain a rank: rank 0's blended frames (None on the others), the wall,
    the chains this rank ran and its row_gather and patch_eval launches."""
    from fresco_torch import kernels
    from fresco_torch.propagate.video_blend import blend_video_frames

    frames, styled, flow_fn = _wave_clip(seed, dev, keys, hw)
    mine = (frames, styled) if rank == 0 else (None, None)
    timers: dict = {}
    kernels.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    out = blend_video_frames(*mine, list(keys), flow_fn=flow_fn, n_devices="auto", device=dev, timers_out=timers)
    _sync(dev)
    launches = kernels.launches()
    return {"frames": out, "wall_s": time.perf_counter() - t0, "chains": timers["chains"],
            "launches": {n: launches[n] for n in ("row_gather", "patch_eval")}}


def _mesh_rank(rank: int, dev, shape, seed: int, tiny: bool, res: int, card: str, train_cfg, train_res,
               steps=MESH_STEPS, wave=None):
    """One spawned rank of phase 17: where it runs, then its batches, and
    (``wave``: phase 13's keys and size) its share of the wave clip."""
    global CARD
    CARD = card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fresco_torch import kernels
    from fresco_torch.parallel.sharding import make_mesh

    if dev.type == "cuda":
        kernels.load()
    out = {"where": rank_where(dev), **_mesh_batches(seed, dev, shape, tiny, res, steps=steps)}
    if tuple(shape) == (2, 1):
        out["train"] = _mesh_train(seed, dev, make_mesh(*shape), train_cfg, train_res)
    if wave is not None:
        out["wave"] = _mesh_wave(rank, seed, dev, *wave)
    return out


def _bytes_line(split: dict, whole: dict | None = None) -> str:
    """Each model's parameter MiB on a rank (and of the whole model, with
    the split layers, where ``whole`` is given)."""
    mib = lambda n: n / 2**20  # noqa: E731
    if whole is None:
        return ", ".join(f"{k} {mib(v['bytes']):.2f} MiB" for k, v in split.items())
    return ", ".join(f"{k} {mib(v['bytes']):.2f} of {mib(whole[k]['bytes']):.2f} MiB ({v['split']}/{v['layers']})"
                     for k, v in split.items())


def _lat_rel(a: dict, b: dict) -> float:
    """The relative Frobenius distance of two runs' latents (optimization off)."""
    return float((a["plain"]["latents"] - b["plain"]["latents"]).norm() / b["plain"]["latents"].norm())


def _psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * math.log10(255.0 ** 2 / mse)


def mesh_probe(dev, world: int = 2) -> dict:
    """What this machine's torch.distributed offers: the backends, NCCL's
    version and, in ``world`` spawned ranks dealt over the visible cards,
    each rank's backend and card, whether the backend all-gathers,
    all-reduces and broadcasts CUDA tensors itself with the right values,
    and a gather of a 2x4x4096x320 bf16 tensor (cross-frame attention's K
    at 512 px) from every rank, handed to the backend as it lies; where the
    ranks share a card (gloo), also one staged through host memory by hand,
    timed in turns (NCCL takes no host tensor)."""
    import torch.distributed as dist

    from fresco_torch.parallel.distributed import launch

    info = {"nccl": dist.is_nccl_available(), "gloo": dist.is_gloo_available(),
            "nccl_version": ".".join(map(str, torch.cuda.nccl.version())) if dev.type == "cuda" else None,
            "world": world}
    info["ranks"] = launch(_probe_rank, world, world, device=dev.type, timeout_s=120)
    print(f"mesh probe, {world} ranks: {info} ({CARD})")
    return info


def _probe_rank(rank: int, dev, world: int) -> dict:
    import torch.distributed as dist

    from fresco_torch.core import comm

    out = rank_where(dev)
    x = torch.full((4,), float(rank + 1), device=dev)

    def gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return torch.cat(parts), torch.tensor([float(r + 1) for r in range(world) for _ in range(4)])

    def reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y, torch.full((4,), world * (world + 1) / 2)

    def bcast():
        y = x.clone()
        dist.broadcast(y, src=1)
        return y, torch.full((4,), 2.0)

    for name, op in (("all_gather", gather), ("all_reduce", reduce), ("broadcast", bcast)):
        try:
            got, want = op()
            out[name] = "ok" if got.device == dev and torch.equal(got.cpu(), want) else f"wrong: {got.tolist()}"
        except Exception as e:  # the probe reports what the backend refuses
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    if dev.type != "cuda":
        return out
    group = dist.group.WORLD
    k = torch.randn(2, 4, 4096, 320, device=dev).to(torch.bfloat16)
    fns = {"native": lambda: comm.all_gather_cat(k, group, world)}
    if out["backend"] == "gloo":
        fns["staged"] = lambda: comm.all_gather_cat(k.cpu(), group, world).to(dev)
        if not torch.equal(fns["staged"](), fns["native"]()):
            out["gather_ms"] = "native and staged gathers differ"
            return out
    ms = {name: [] for name in fns}
    for _ in range(5):
        for name, fn in fns.items():
            dist.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            ms[name].append((time.perf_counter() - t0) * 1e3)
    out["gather_ms"] = {n: float(np.median(v)) for n, v in ms.items()}
    return out


def _check_mesh_wave(seed: int, dev, wave, ranks: list, serial: dict | None) -> dict:
    """Fail unless rank 0's wave frames equal the serial stage's bit for
    bit, the other ranks returned None, every chain ran once and (on the
    card) every rank launched row_gather and patch_eval; returns the walls."""
    from fresco_torch.propagate.video_blend import blend_video_frames

    keys, hw = wave
    if serial is None:
        frames, styled, flow_fn = _wave_clip(seed, dev, keys, hw)
        serial = blend_video_frames(frames, styled, list(keys), flow_fn=flow_fn, n_devices=1, device=dev)
    got = ranks[0]["wave"]["frames"]
    same = sorted(got) == sorted(serial) and all(np.array_equal(got[i], serial[i]) for i in serial)
    chains = sorted((c["seq_i"], c["d"], c["rank"]) for r in ranks for c in r["wave"]["chains"])
    want = [(i, d) for i, (beg, end) in enumerate(zip(keys[:-1], keys[1:])) if end - beg > 1 for d in range(2)]
    out = {"bit_equal": same, "walls_s": [r["wave"]["wall_s"] for r in ranks], "chains": chains,
           "launches": [r["wave"]["launches"] for r in ranks]}
    print(f"mesh (2, 1) wave: {keys[-1] + 1} frames {hw[0]}x{hw[1]}, keys {list(keys)}, blend_video_frames over the "
          f"two ranks, a chain a rank: walls {', '.join(f'{w:.2f}' for w in out['walls_s'])} s; chains (interval, "
          f"direction, rank) {chains}; launches {out['launches']}; rank 0's frames bit-equal to the serial stage's "
          f"{same} ({CARD})")
    if not same or any(r["wave"]["frames"] is not None for r in ranks[1:]):
        fail("mesh (2, 1) wave: rank 0's frames differ from the serial stage's, or another rank returned frames")
    if sorted(c[:2] for c in chains) != want or {c[2] for c in chains} != set(range(len(ranks))):
        fail(f"mesh (2, 1) wave: chains {chains}, expected {want} over every rank")
    if dev.type == "cuda" and min(n for r in out["launches"] for n in r.values()) <= 0:
        fail(f"mesh (2, 1) wave: a rank did not launch row_gather and patch_eval: {out['launches']}")
    return out


def phase_mesh(seed: int, dev, tiny: bool = False, res: int = 512, train_cfg=None, train_res: int = 512,
               shapes=MESH_SHAPES, dryrun: bool = True, steps=MESH_STEPS, probe: bool = True, waves: bool = True,
               wave_hw=PROP_HW, wave_serial: dict | None = None) -> dict:
    """Phase 17: the device mesh (parallel/).  Each (data, model) world of
    ``shapes`` runs in spawned ranks that ``launch`` deals round-robin over
    the visible cards (on one card every rank shares it over gloo; with a
    card a rank they go over NCCL), its denoise loop at ``steps``, each
    rank held against the single process and against its witness; the
    (2, 1) world also takes a UNet training step and (``waves``) runs
    phase 13's wave clip (WAVE_KEYS at ``wave_hw``) through
    ``blend_video_frames`` over its two ranks, a chain a rank, rank 0's
    frames held bit for bit to the serial stage's (``wave_serial``, phase
    13's; made here when None).  ``probe``: first the probe and the process
    group of one.  Returns the readings."""
    import os
    import tempfile

    import torch.distributed as dist

    from fresco_torch.parallel.distributed import initialize, launch
    from fresco_torch.parallel.dryrun import dryrun_multichip

    readings = {"steps": dict(steps)}
    if probe:
        readings["probe"] = mesh_probe(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    single = _mesh_batches(seed, dev, (1, 1), tiny, res, steps=steps)
    for key in ("plain", "opt"):
        r = single[key]
        print(f"mesh: single process, feature optimization {'on' if key == 'opt' else 'off'}: "
              f"{MESH_FRAMES} x {res} px, {music_config(**steps).num_inference_steps} steps, wall {r['wall_s']:.2f} s, "
              f"peak {r['peak_gib']:.2f} GiB, launches {r['launches']} ({CARD})")
    print("mesh: single process, parameter bytes whole: " + _bytes_line(single["split"]))

    if probe:  # a process group of one over NCCL: the (1, 1) mesh is the plain path, bit for bit
        with tempfile.TemporaryDirectory() as tmp:
            initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0, device_type=dev.type)
            try:
                world1 = _mesh_batches(seed, dev, (1, 1), tiny, res, steps=steps)
                backend = dist.get_backend()
            finally:
                dist.destroy_process_group()
        same = all(torch.equal(world1[k]["latents"], single[k]["latents"]) for k in ("plain", "opt"))
        print(f"mesh: process group of 1 ({backend}), mesh (1, 1): latents bit-equal to the plain path {same}")
        if not same:
            fail("mesh: the (1, 1) mesh in a process group of one differs from the plain path")

    train_single = _mesh_train(seed, dev, None, train_cfg, train_res) if (2, 1) in map(tuple, shapes) else None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings["single"] = {k: {x: single[k][x] for x in ("wall_s", "peak_gib", "launches")} for k in ("plain", "opt")}
    for shape in shapes:
        # the witness: this process doing a rank's arithmetic of the mesh
        # (its kernel shapes, TP's partial sums) with no collective
        witness = _mesh_batches(seed, dev, (1, 1), tiny, res, witness=shape, steps=steps)
        w_lat, w_psnr = _lat_rel(witness, single), _psnr_u8(witness["opt"]["images"], single["opt"]["images"])
        print(f"mesh {shape}: witness (one process, a rank's arithmetic, no collective) vs single: off: latents "
              f"rel fro {w_lat:.3e}; on: decoded PSNR {w_psnr:.2f} dB ({CARD})")
        world = shape[0] * shape[1]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        wave = (tuple(WAVE_KEYS), tuple(wave_hw)) if waves and tuple(shape) == (2, 1) else None
        t0 = time.perf_counter()
        ranks = launch(_mesh_rank, world, shape, seed, tiny, res, CARD, train_cfg, train_res, steps, wave,
                       device=dev.type, timeout_s=MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if wave is not None:
            readings[f"{tuple(shape)} wave"] = _check_mesh_wave(seed, dev, wave, ranks, wave_serial)
        where = check_where(f"mesh {shape}", [out["where"] for out in ranks], dev)
        rows = []
        for r, out in enumerate(ranks):
            lat_rel, psnr = _lat_rel(out, single), _psnr_u8(out["opt"]["images"], single["opt"]["images"])
            lat_w, psnr_w = _lat_rel(out, witness), _psnr_u8(out["opt"]["images"], witness["opt"]["images"])
            max_w = {k: float((out[k]["latents"] - witness[k]["latents"]).abs().max()) for k in ("plain", "opt")}
            rows.append({"rank": r, **out["where"], "latent_rel": lat_rel, "psnr_db": psnr,
                         "latent_rel_witness": lat_w, "psnr_db_witness": psnr_w, "latent_max_abs_witness": max_w,
                         **{f"{k}_{x}": out[k][x] for k in ("plain", "opt") for x in ("wall_s", "peak_gib", "launches")}})
            print(f"mesh {shape} rank {r} ({out['where']['backend']}, card {out['where']['card']}): off: latents "
                  f"rel fro vs witness {lat_w:.3e} (limit {MESH_WITNESS_REL}), max |d| {max_w['plain']:.3e}, "
                  f"vs single {lat_rel:.3e} (limit {MESH_LATENT_REL}), wall {out['plain']['wall_s']:.2f} s, peak "
                  f"{out['plain']['peak_gib']:.2f} GiB, launches {out['plain']['launches']}; on: decoded PSNR vs "
                  f"witness {psnr_w:.2f} dB (floor {MESH_PSNR_WITNESS_FLOOR}), vs single {psnr:.2f} dB (floor "
                  f"{MESH_PSNR_FLOOR}), latents max |d| vs witness {max_w['opt']:.3e}, wall "
                  f"{out['opt']['wall_s']:.2f} s, peak {out['opt']['peak_gib']:.2f} GiB, "
                  f"launches {out['opt']['launches']} ({CARD})")
            flow_d = {k: float((out["flows"] - ref["flows"]).abs().max()) for k, ref in (("witness", witness),
                                                                                         ("single", single))}
            flips = {k: int((out["occ"] != ref["occ"]).sum()) for k, ref in (("witness", witness), ("single", single))}
            rows[-1].update(flow_max_abs=flow_d, occ_flips=flips)
            print(f"mesh {shape} rank {r}: GMFlow's flows (largest |f| {float(single['flows'].abs().max()):.2f} px) "
                  f"max |d| vs witness {flow_d['witness']:.3e}, vs single {flow_d['single']:.3e} px; occlusion "
                  f"pixels flipped vs witness {flips['witness']}, vs single {flips['single']} of "
                  f"{out['occ'].numel()} ({CARD})")
            print(f"mesh {shape} rank {r}: parameter bytes on the rank (layers split over model / Dense and "
                  f"Conv layers): {_bytes_line(out['split'], single['split'])}; peak {out['plain']['peak_gib']:.2f} "
                  f"/ {out['opt']['peak_gib']:.2f} GiB (off / on) ({CARD})")
            rows[-1]["split"] = out["split"]
            if shape[1] > 1 and any(v["split"] == 0 for v in out["split"].values()):
                fail(f"mesh {shape} rank {r}: a model is not split over model: {out['split']}")
            if not (lat_w <= MESH_WITNESS_REL and psnr_w >= MESH_PSNR_WITNESS_FLOOR):
                fail(f"mesh {shape} rank {r}: sharded differs from its witness")
            if not (lat_rel <= MESH_LATENT_REL and psnr >= MESH_PSNR_FLOOR):
                fail(f"mesh {shape} rank {r}: sharded differs from single")
            if dev.type == "cuda":
                for k in ("plain", "opt"):
                    if min(out[k]["launches"][n] for n in ("flash_attn_fwd", "sign_gram", "bmm")
                           if k == "opt" or n == "flash_attn_fwd") <= 0:
                        fail(f"mesh {shape} rank {r}: a main-path kernel did not launch: {out[k]['launches']}")
            if "train" in out:
                tr = out["train"]
                loss_rel = abs(tr["loss"] - train_single["loss"]) / abs(train_single["loss"])
                grad_rel = {n: _rel(tr["grads"][n], train_single["grads"][n]) for n in TRAIN_GRAD_PARAMS}
                rows[-1].update(train_loss_rel=loss_rel, train_grad_rel=max(grad_rel.values()),
                                train_step_s=tr["step_s"], train_peak_gib=tr["peak_gib"])
                print(f"mesh {shape} rank {r}: UNet training step (batch 2 over data, {train_res} px) vs single: "
                      f"loss {tr['loss']:.6f} vs {train_single['loss']:.6f}, rel {loss_rel:.3e} (limit "
                      f"{MESH_TRAIN_LOSS_REL}); gradients max|d|/max|g| "
                      + ", ".join(f"{n} {v:.3e}" for n, v in grad_rel.items())
                      + f" (limit {MESH_TRAIN_GRAD_REL}); step {tr['step_s']:.2f} s, peak {tr['peak_gib']:.2f} GiB "
                        f"(single {train_single['step_s']:.2f} s) ({CARD})")
                if loss_rel > MESH_TRAIN_LOSS_REL or max(grad_rel.values()) > MESH_TRAIN_GRAD_REL:
                    fail(f"mesh {shape}: the sharded training step differs from the single one")
        print(f"mesh {shape}: {where}; call wall {wall:.2f} s (walls reported, not judged)")
        readings[str(shape)] = {"witness": {"latent_rel": w_lat, "psnr_db": w_psnr}, "call_wall_s": wall,
                                "ranks": rows}
    if dryrun:
        readings["dryrun"] = dryrun_multichip(4, device=dev.type)
        print(f"mesh: dryrun_multichip(4, device={dev.type!r}) passed ({CARD})")
    return readings


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    try:
        from fresco_torch import kernels
    except ImportError as e:  # the script alone, outside a checkout: fail by design, and say so
        fail(f"fresco_torch does not import here ({e}): run chip_smoke.py from the root of a checkout")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    global CARD
    CARD = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
            else f"nvidia-smi unavailable (rc {smi.returncode})")
    print(CARD)

    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {len(kernels.build_info.paths)} libraries, one nvcc per source in parallel, "
          f"{time.perf_counter() - t0:.2f} s (nvcc wall {kernels.build_info.seconds:.2f} s)")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flash_rows, flash_err = phase_flash(gen, dev)
    gram_rows, gram_err = phase_gram(gen, dev)
    fg_rows, fg_err = phase_factored_gram(gen, dev)
    phase_small(args.seed, dev)
    launches = phase_slice(args.seed, dev, gram_rows)
    gather_rows_ = phase_gather(gen, dev)
    pe_rows, pe_err, pe_shape_ms = phase_patch_eval(args.seed, dev)
    phase_small_propagate(args.seed, dev)
    launches.update(phase_propagate(args.seed, dev, pe_shape_ms))
    gemm_rows, gemm_err = phase_gemm(gen, dev)
    phase_aux(args.seed, dev)
    phase_e2e(args.seed, dev, gram_rows=gram_rows, pe_shape_ms=pe_shape_ms)
    phase_weights(args.seed, dev, gram_rows)
    waves = phase_entry_points(args.seed, dev)
    phase_detectors(args.seed, dev, gram_rows)
    phase_train(args.seed, dev)
    phase_webui(args.seed, dev)
    phase_mesh(args.seed, dev, wave_serial=waves["blend"])

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
        row("sign_gram_factored", "fresco_torch/csrc/factored_gram.cu",
            "none (XLA's chunked einsums, fresco_tpu/diffusion/guidance.py:394-413)", fg_err,
            fg_rows[(16, 5120, 640)]),
    ]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
