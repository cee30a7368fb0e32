"""Typed configuration for the FRESCO pipeline (PyTorch port).

The same schema as ``fresco_tpu/core/config.py``, kept as its own copy:
``fresco_tpu.core`` imports jax on package import, and this package
never does.  The reference's hard-coded
magic numbers (attention scales 0.2, intra_weight=1e2, Adam
iters=20/lr=0.2, num_intraattn_steps=1, step_interattn_end=350,
bg_smoothing_steps=[16,17], guidance_scale=7.5 — reference
src/diffusion_hacked.py:41-42,417,433 and src/pipe_FRESCO.py:87) are
typed fields here.  The benchmark builds it from a configuration file's
``fresco`` block; the frozen pipeline refuses ``use_freeu``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class FrescoConfig:
    # --- data ---
    file_path: str = ""
    save_path: str = "./output/"
    mininterv: int = 5
    maxinterv: int = 20

    # --- diffusion ---
    seed: int = 0
    prompt: str = ""
    a_prompt: str | None = None  # auto-derived from sd_path if None
    n_prompt: str | None = None
    sd_path: str = "runwayml/stable-diffusion-v1-5"
    vae_path: str | None = "stabilityai/sd-vae-ft-mse"
    lora_path: str | None = None
    lora_scale: float = 1.0
    use_controlnet: bool = True
    controlnet_type: str = "hed"  # 'hed' | 'depth' | 'canny'
    controlnet_path: str | None = None  # default: lllyasviel/sd-controlnet-<type>
    cond_scale: float = 0.7
    # canny thresholds (reference run_fresco.py:106 / webUI.py:469-478)
    canny_low: int = 50
    canny_high: int = 100
    use_freeu: bool = False
    guidance_scale: float = 7.5

    # per-keyframe prompt suffixes, e.g. {38: ', closed eyes'}
    # (reference run_fresco.py:135-137)
    extra_prompts: tuple = ()

    # --- video-to-video translation ---
    batch_size: int = 8
    resolution: int = 512
    num_inference_steps: int = 20
    num_warmup_steps: int = 6
    end_opt_step: int = 15
    run_ebsynth: bool = False
    max_process: int = 4
    # propagation gradient blending toggle (reference webUI.py:566-571)
    use_poisson: bool = True
    # cap on input frames read (reference webUI.py frame_count slider;
    # None/0 = all frames)
    frame_count: int | None = None

    # --- supporting models (converted-checkpoint paths; see models/convert.py) ---
    gmflow_path: str = "./model/gmflow_sintel-0c07dcb3.pth"
    sod_path: str = "./model/epoch_resnet.pth"
    use_saliency: bool = True

    # --- FRESCO mechanism knobs (reference magic numbers, now configurable) ---
    use_fresco_attn: bool = True
    use_cfattn: bool = True     # cross-frame attention independently toggleable
    use_fresco_opt: bool = True
    intraattn_scale_factor: float = 0.2  # diffusion_hacked.py:41
    interattn_scale_factor: float = 0.2  # diffusion_hacked.py:42
    intra_weight: float = 1e2            # diffusion_hacked.py:417
    opt_iters: int = 20                  # diffusion_hacked.py:417
    opt_lr: float = 0.2                  # diffusion_hacked.py:433
    optimize_temporal: bool = True
    num_intraattn_steps: int = 1         # pipe_FRESCO.py:87
    step_interattn_end: int = 350        # pipe_FRESCO.py:87
    bg_smoothing_steps: tuple[int, ...] = (16, 17)  # pipe_FRESCO.py:87
    repeat_noise: bool = True
    photo_occ_thresh: float = 0.25       # diffusion_hacked.py:923 (×255)
    # dtype for gram matmuls AND stored reference correlations (threaded
    # into intraframe_params so "float32" gives strict end-to-end parity)
    gram_dtype: str = "bfloat16"
    # dtype for the auxiliary model forwards (GMFlow interframe flows,
    # EGNet saliency).  The reference runs both fp32 on CUDA
    # (run_fresco.py:91-98).  "float32" = strict parity.
    aux_dtype: str = "bfloat16"
    # cross-frame attention valid-key compaction: "auto" sizes the cap
    # from the measured valid-key count per batch (never truncates —
    # exact reference semantics, diffusion_hacked.py:225-247); a number
    # fixes the cap at xK of hw (may truncate, warned once); 0 = dense
    cf_key_cap: float | str = "auto"

    dtype: str = "bfloat16"              # compute dtype for SD/ControlNet/VAE

    def replace(self, **kw: Any) -> "FrescoConfig":
        return dataclasses.replace(self, **kw)


def default_prompts(sd_path: str) -> tuple[str, str]:
    """Auto positive/negative prompt suffixes by model family.

    Mirrors reference run_fresco.py:122-127.
    """
    if "realistic" in sd_path.lower():
        a_prompt = (
            ", RAW photo, subject, (high detailed skin:1.2), 8k uhd, dslr, "
            "soft lighting, high quality, film grain, Fujifilm XT3, "
        )
        n_prompt = (
            "(deformed iris, deformed pupils, semi-realistic, cgi, 3d, render, "
            "sketch, cartoon, drawing, anime, mutated hands and fingers:1.4), "
            "(deformed, distorted, disfigured:1.3), poorly drawn, bad anatomy, "
            "wrong anatomy, extra limb, missing limb, floating limbs, "
            "disconnected limbs, mutation, mutated, ugly, disgusting, amputation"
        )
    else:
        a_prompt = ", best quality, extremely detailed, "
        n_prompt = (
            "longbody, lowres, bad anatomy, bad hands, missing finger, "
            "extra digit, fewer digits, cropped, worst quality, low quality"
        )
    return a_prompt, n_prompt


def keyframe_sublists(keys: Sequence[int], batch_size: int) -> list[list[int]]:
    """Split keyframe indices into translation batches.

    First batch carries 2 anchor frames; later batches are topped up with
    [first, last] of the previous batch at inference time (propagation mode).
    Mirrors reference run_fresco.py:145-154.
    """
    keys = list(keys)
    sublists = [keys[i : i + batch_size - 2] for i in range(2, len(keys), batch_size - 2)]
    if not sublists:
        sublists = [[]]
    sublists[0].insert(0, keys[0])
    sublists[0].insert(1, keys[1])
    if len(sublists) > 1 and len(sublists[-1]) < 3:
        add_num = 3 - len(sublists[-1])
        sublists[-1] = sublists[-2][-add_num:] + sublists[-1]
        sublists[-2] = sublists[-2][:-add_num]
    if len(sublists) > 1 and not sublists[-2]:
        del sublists[-2]
    return sublists
