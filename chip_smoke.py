"""GPU smoke test of fresco_torch: kernels against their plain versions,
then one full-width keyframe batch through the pipeline.

Run from the root of a checkout on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit:

    python3 chip_smoke.py [--seed N]

Phases (each prints its own lines; any failure exits non-zero):
  1. build   : nvcc-compile fresco_torch/csrc into a shared library;
  2. flash   : the flash-attention kernel against plain float32 attention
               on the same bf16 inputs, at the shapes of the main path
               (UNet/ControlNet self-attention d = 40/80/160, cross-frame
               attention over compacted ragged keys, VAE mid-block d = 512);
  3. gram    : the sign-gram kernels against the chunked plain version at
               the four decoder-stage shapes and a ragged hw = 1280 in
               bf16 (the main path's gram dtype), and at two of them in
               float32;
  4. small   : a small-width 64 px batch (FRESCO attention on, feature
               optimization off) on the card (kernels, bf16) and on the CPU
               (plain versions, float32) with the same weights and noise,
               compared;
  5. slice   : one batch of 8 keyframes at 512x512 through
               FrescoPipeline._translate_batch and decode, at full SD1.5
               width (UNet, ControlNet, VAE, CLIP-L text) with random
               weights from a seeded torch.Generator, config_music's
               settings.  Both kernels' launch counters must move.
The line before the last is the kernel table as JSON; the last line is
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
# the shapes below; dropping one 64-key tile at S = 4096 moves the output
# by ~1.8e-2 at its maximum.
FLASH_ATOL = 5e-3
# and the relative Frobenius error, ||d|| / ||ref||, which a wrong tile or
# a lost row moves by far more than rounding does
FLASH_REL_FRO = 1e-2
GRAM_REL_FRO = 5e-2     # sign-gram vs plain, relative Frobenius (near-tie sign flips)
# |G - C| at any flipped sign: G is accumulated in float32 in both, so a
# flip may only come from summation order (measured <= 1.2e-6); rounding G
# to bf16 before the subtraction would flip signs up to |G - C| ~ 4e-3.
GRAM_TIE = 1e-4
GRAM_APPLY_REL = 1e-5   # apply kernel vs S_kernel·v in float32
# small batch without the feature optimization, bf16 kernels on the card vs
# f32 plain on the CPU (bf16 rounding through 6 random-weight denoise steps
# measures 2.3e-2 between the CPU's own bf16 and f32 runs; with the feature
# optimization sign() amplifies it to ~1e-1, so that path is held by the
# gram phase and the slice's launch counters instead)
SMALL_REL_FRO = 6e-2


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


def phase_flash(gen, dev):
    from fresco_torch.attention.flash import flash_attention

    def heads(b, s, h, d):  # [B,S,H,D] memory, [B,H,S,D] view (as the model's head split)
        return torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)

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
        out = flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = plain_attention_chunked(q, k, v, mask, qc)
        diff = out.float() - ref
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.norm()).item()
        ms = cuda_ms(lambda: flash_attention(q, k, v, mask))
        plain_ms = cuda_ms(lambda: plain_attention_chunked(q, k, v, mask, qc), iters=2)
        print(f"flash {name:18s} B={b} H={h} Sq={sq} Sk={skk}: max|d|={err:.3e} (tol {FLASH_ATOL}), "
              f"max|ref|={ref.abs().max().item():.3e}, rel fro {rel:.3e} (tol {FLASH_REL_FRO}), "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if not (err <= FLASH_ATOL and rel <= FLASH_REL_FRO):
            fail(f"flash {name}: max|d| {err}, rel fro {rel}")
        rows[name] = (ms, plain_ms)
        max_err = max(max_err, err)
        del q, k, v, out, ref, diff
    # a batch row with no valid key must give exact zeros
    q, k, v = heads(2, 300, 8, 40), heads(2, 200, 8, 40), heads(2, 200, 8, 40)
    m = torch.ones(2, 200, dtype=torch.bool, device=dev)
    m[1] = False
    out = flash_attention(q, k, v, m)
    torch.cuda.synchronize()
    if not bool((out[1] == 0).all()):
        fail("flash: a row with no valid key is not exact zeros")
    err = (out[0].float() - plain_attention_chunked(q[:1], k[:1], v[:1], m[:1], 300)[0]).abs().max().item()
    print(f"flash empty row: exact zeros, valid row max|d|={err:.3e} (tol {FLASH_ATOL})")
    if not err <= FLASH_ATOL:
        fail(f"flash empty-row case: valid row max|d| {err}")
    max_err = max(max_err, err)
    return rows, max_err


def phase_gram(gen, dev):
    """Two checks per shape: every sign the kernel's S differs from the
    plain sign on must be a near tie (|G - C| below GRAM_TIE: bf16 C
    rounding, other summation order); and the apply product must equal
    S_kernel·v in float32 (GRAM_APPLY_REL).  The relative Frobenius error
    against the plain version is bounded by GRAM_REL_FRO (a few flips move
    it ~1e-2 at hw = 64, where a row has only 64 terms)."""
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
        s_kernel = gk.sign_matrix(v, corr)[:, :, :hw].float()
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
        ms = cuda_ms(lambda: gk.sign_gram_apply(v, corr))
        plain_ms = cuda_ms(lambda: gk.sign_gram_plain(v, corr), iters=3)
        print(f"gram {str(dtype)[6:]} hw={hw} c={c} B={b}: rel fro {rel:.3e} (tol {GRAM_REL_FRO}), max|d|={err:.3e}, "
              f"flipped signs {flips}/{b * hw * hw} (largest |G-C| at a flip {tie_max:.2e}, tol {GRAM_TIE}), "
              f"apply vs S_kernel.v rel {apply_rel:.2e} (tol {GRAM_APPLY_REL}), "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if not (rel <= GRAM_REL_FRO and tie_max <= GRAM_TIE and apply_rel <= GRAM_APPLY_REL):
            fail(f"gram {dtype} hw={hw} c={c}: rel {rel}, tie {tie_max}, apply {apply_rel}")
        rows[(dtype, hw, c)] = (ms, plain_ms)
        max_err = max(max_err, err)
        del v, vf, vr, corr, out, ref, s_kernel, ref_ks
    return rows, max_err


def make_inputs(seed: int, n: int, res: int):
    """Seeded frames: smoothed-noise texture under a sub-pixel global
    translation per frame plus a moving disc; their analytic
    bidirectional flows; a Sobel edge detector."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    pad = 48
    tex = ndimage.gaussian_filter(rng.standard_normal((res + 2 * pad, res + 2 * pad, 3)), (3, 3, 0))
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255.0
    shifts = np.cumsum(rng.uniform(-2.5, 2.5, (n, 2)), axis=0)  # (dx, dy) per frame
    shifts -= shifts[0]
    centers = np.array([res * 0.3, res * 0.5]) + np.arange(n)[:, None] * np.array([res * 0.04, res * 0.01])
    radius = res * 0.12
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float64)
    frames, discs = [], []
    for i in range(n):
        coords = [yy + pad - shifts[i, 1], xx + pad - shifts[i, 0]]
        img = np.stack([ndimage.map_coordinates(tex[..., ch], coords, order=1) for ch in range(3)], -1)
        disc = (xx - centers[i, 0]) ** 2 + (yy - centers[i, 1]) ** 2 < radius ** 2
        img[disc] = [235.0, 60.0, 40.0] + 15.0 * np.sin(xx[disc, None] / 6.0)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        discs.append(disc)
    fwd = np.zeros((n, res, res, 2), np.float32)
    bwd = np.zeros((n, res, res, 2), np.float32)
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


def phase_slice(seed: int, dev):
    from fresco_torch.attention.flash import flash_attention
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
    t0 = time.perf_counter()
    latents, record = pipe._translate_batch(frames, prompts, negs, None, False)
    images = pipe.decode(latents)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attn_fwd": flash_attention.launches, "sign_gram": sign_gram_apply.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30

    ph = pipe.phases.times
    names = [("prompts", "encode_prompts"), ("interframe prep", "interframe_prep"),
             ("intraframe prep", "intraframe_prep"), ("attention params", "attn_params"),
             ("denoise loop", "denoise_loop"), ("decode", "vae_decode"),
             ("upload", "upload_frames"), ("control detector", "control_detector")]
    print("slice phases (s, synchronized): " + ", ".join(f"{a} {ph.get(b, 0.0):.3f}" for a, b in names))
    print(f"slice: {n} keyframes {res}x{res}, {cfg.num_inference_steps} steps, wall {wall:.2f} s, "
          f"peak device memory {peak_gb:.2f} GiB, launches {launches}")
    check_finite("slice_latents", latents)
    print(f"slice: latents finite, shape {tuple(latents.shape)}, |max| {latents.abs().max().item():.3f}; "
          f"record {tuple(record.shape)}; output {images.shape} {images.dtype}")
    if images.shape != (n, res, res, 3) or images.dtype != np.uint8:
        fail(f"slice output {images.shape} {images.dtype}")
    if min(launches.values()) <= 0:
        fail(f"slice did not launch every kernel: {launches}")
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
    print(f"build: {kernels.build_info.path} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kernels.build_info.seconds:.2f} s)")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flash_rows, flash_err = phase_flash(gen, dev)
    gram_rows, gram_err = phase_gram(gen, dev)
    phase_small(args.seed, dev)
    launches = phase_slice(args.seed, dev)

    f_ms, f_plain = flash_rows["self d=40"]
    g_ms, g_plain = gram_rows[(torch.bfloat16, 4096, 640)]
    table = {"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda", "source": "fresco_torch/csrc/flash_attn.cu",
         "replaces": "fresco_tpu/attention/flash.py:31", "launches": launches["flash_attn_fwd"],
         "max_abs_err": flash_err, "ms": f_ms, "plain_ms": f_plain},
        {"name": "sign_gram", "route": "cuda", "source": "fresco_torch/csrc/sign_gram.cu",
         "replaces": "fresco_tpu/ops/gram_kernel.py:30", "launches": launches["sign_gram"],
         "max_abs_err": gram_err, "ms": g_ms, "plain_ms": g_plain},
    ]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
