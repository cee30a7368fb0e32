"""Model stack and keyframe-batch translation (PyTorch).

Counterpart of ``fresco_tpu/pipeline/runner.py`` (reference
run_fresco.py:23-100,111-270) for one keyframe batch:
``FrescoPipeline._prepare_batch`` (frames, prompts, control edges,
inter/intra-frame params, attention params), ``_run_batch`` (the denoise
loop) and ``decode`` — the calls ``translate_keyframes`` makes per batch.

Flows enter through ``ModelBundle.flow_fn`` (GMFlow is not ported yet),
the control detector through ``ModelBundle.detector`` (none by default:
canny is OpenCV's, which the port does not use, and HED is not ported).  ``build_models`` initializes random weights
with Flax's default initializers from a seeded ``torch.Generator``;
weights of the JAX package load through ``models/convert.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Any, Callable

import numpy as np
import torch

from fresco_torch.core.config import FrescoConfig
from fresco_torch.diffusion.guidance import GuidanceConfig
from fresco_torch.diffusion.sampler import FrescoSampler, FrescoState, SamplerConfig
from fresco_torch.diffusion.scheduler import DDPMScheduler
from fresco_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from fresco_torch.models.controlnet import ControlNet
from fresco_torch.models.layers import cast_model, init_flax_default_
from fresco_torch.models.unet import UNet2DCondition, UNetConfig
from fresco_torch.models.vae import AutoencoderKL, VAEConfig
from fresco_torch.ops.image import unit_range_to_uint8
from fresco_torch.pipeline import prepare
from fresco_torch.pipeline.text import encode_prompts, make_tokenizer


@dataclasses.dataclass
class ModelBundle:
    unet: UNet2DCondition
    vae: AutoencoderKL
    controlnet: ControlNet
    text_encoder: CLIPTextEncoder
    scheduler: DDPMScheduler
    tokenizer: Any
    detector: Callable[[np.ndarray], np.ndarray]
    device: torch.device
    # bidirectional flow: (frames, rolled) [F,H,W,3] in [0,255] ->
    # [2F,H,W,2] (forward flows, then backward)
    flow_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None


def _no_detector(img: np.ndarray) -> np.ndarray:
    raise NotImplementedError(
        "no control detector: canny needs OpenCV and HED is not ported (ROADMAP Slice 5); "
        "set ModelBundle.detector")


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means the card; the CPU runs only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _local_ckpt_dir(spec, ckpt_dir: str) -> str | None:
    """A checkpoint spec (path or hub id) -> an existing local directory."""
    if not spec:
        return None
    p = str(spec)
    if os.path.isdir(p):
        return p
    base = os.path.basename(p.rstrip("/"))
    for cand in (os.path.join(ckpt_dir, base), os.path.join(".", base)):
        if os.path.isdir(cand):
            return cand
    return None


def model_dtype(config: FrescoConfig) -> torch.dtype:
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


def build_models(config: FrescoConfig, *, tiny: bool = False, seed: int = 0,
                 device: torch.device | str | None = None) -> ModelBundle:
    """Random-weight model stack at full SD1.5 width or tiny widths.

    Modules are built on the meta device and materialized once on
    ``device``; weights are drawn from a ``torch.Generator`` seeded with
    ``seed`` on that device (``None``: the card; it raises without one).
    The UNet, ControlNet and VAE run in ``config.dtype``; the text encoder
    in float32."""
    device = resolve_device(device)
    if tiny:
        ucfg, vcfg, ccfg = UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()
        cond_embed = (4, 4, 8, 8)
    else:
        ucfg = UNetConfig(use_freeu=config.use_freeu, freeu_b1=config.freeu_b1,
                          freeu_b2=config.freeu_b2, freeu_s1=config.freeu_s1,
                          freeu_s2=config.freeu_s2)
        vcfg, ccfg = VAEConfig(), CLIPTextConfig()
        cond_embed = (16, 32, 96, 256)
    # the cross-attention width is the text encoder's (Flax infers it from
    # the context; the tiny configs leave cross_attention_dim unused)
    ucfg = dataclasses.replace(ucfg, cross_attention_dim=ccfg.hidden_size)
    with torch.device("meta"):
        unet = UNet2DCondition(ucfg)
        vae = AutoencoderKL(vcfg)
        controlnet = ControlNet(ucfg, cond_embed)
        text = CLIPTextEncoder(ccfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = model_dtype(config)
    mods = []
    for m, d in ((unet, dt), (vae, dt), (controlnet, dt), (text, torch.float32)):
        m = m.to_empty(device=device)
        init_flax_default_(m, gen)
        mods.append(cast_model(m, d).eval().requires_grad_(False))
    unet, vae, controlnet, text = mods

    if config.use_saliency and config.sod_path and os.path.exists(str(config.sod_path)):
        raise NotImplementedError("EGNet saliency is not ported yet")
    tokenizer = make_tokenizer(
        _local_ckpt_dir(config.sd_path, os.path.dirname(str(config.gmflow_path)) or "."),
        ccfg.vocab_size)
    return ModelBundle(unet, vae, controlnet, text,
                       DDPMScheduler(num_inference_steps=config.num_inference_steps),
                       tokenizer, _no_detector, device)


class PhaseTimes:
    """Accumulated per-phase wall seconds."""

    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)

    def add(self, name: str, dt: float) -> None:
        self.times[name] += dt


class FrescoPipeline:
    """run_fresco-equivalent orchestration of one keyframe batch."""

    # synchronize the device at each phase boundary so phase times are
    # device times, not enqueue times (off by default)
    sync_phases = False

    def __init__(self, config: FrescoConfig, bundle: ModelBundle | None = None, *,
                 tiny: bool = False, device: torch.device | str | None = None):
        self.config = config
        self.bundle = bundle or build_models(config, tiny=tiny, seed=config.seed, device=device)
        b = self.bundle
        self.device = b.device
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.sampler = FrescoSampler(b.unet, b.vae, b.controlnet, b.scheduler)
        self._base_sampler_cfg = self.make_sampler_cfg(config)
        self.phases = PhaseTimes()

    @staticmethod
    def make_sampler_cfg(config: FrescoConfig) -> SamplerConfig:
        gcfg = GuidanceConfig(iters=config.opt_iters, lr=config.opt_lr,
                              intra_weight=config.intra_weight,
                              optimize_temporal=config.optimize_temporal,
                              gram_dtype=config.gram_dtype)
        return SamplerConfig(
            num_inference_steps=config.num_inference_steps,
            num_warmup_steps=config.num_warmup_steps,
            guidance_scale=config.guidance_scale,
            use_controlnet=config.use_controlnet,
            repeat_noise=config.repeat_noise,
            num_intraattn_steps=config.num_intraattn_steps,
            step_interattn_end=config.step_interattn_end,
            end_opt_step=config.end_opt_step,
            guidance=gcfg,
            do_opt=config.use_fresco_opt,
        )

    @contextlib.contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync_phases and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.phases.add(name, time.perf_counter() - t0)

    def _interframe(self, frames_255):
        if self.bundle.flow_fn is None:
            raise NotImplementedError("GMFlow is not ported yet: set ModelBundle.flow_fn")
        return prepare.interframe_params(self.bundle.flow_fn, frames_255,
                                         photo_thresh=self.config.photo_occ_thresh)

    def _intraframe(self, frames_unit, prompt_embeds, noise, enc_noise):
        corr_dtype = torch.bfloat16 if self.config.gram_dtype == "bfloat16" else torch.float32
        b = self.bundle
        return prepare.intraframe_params(b.unet, b.vae, b.scheduler, frames_unit, prompt_embeds,
                                         noise=noise, enc_noise=enc_noise, corr_dtype=corr_dtype)

    def _translate_batch(self, imgs, prompts, n_prompts, record, propagation, noise=None):
        """Prep + denoise for one batch."""
        prepared = self._prepare_batch(imgs, prompts, n_prompts, noise)
        return self._run_batch(prepared, record, propagation, noise)

    def _prepare_batch(self, imgs, prompts, n_prompts, noise: dict | None = None):
        """Everything the sampler needs that does not depend on earlier
        batches.  ``noise`` may hold ``intra_noise`` / ``intra_enc_noise``
        (the intra-frame pass's diffusion and VAE posterior noise, standard
        normal [F,h,w,4]); missing ones are drawn from the pipeline's
        generator."""
        cfg = self.config
        b = self.bundle
        dev = self.device
        noise = noise or {}
        with self._phase("upload_frames"):
            frames_u8 = torch.as_tensor(np.stack(imgs), device=dev)
        frames_255 = frames_u8.to(torch.float32)
        frames_unit = frames_255 / 255.0 * 2.0 - 1.0
        with self._phase("encode_prompts"):
            prompt_embeds = encode_prompts(b.text_encoder, b.tokenizer, prompts, n_prompts)
        with self._phase("control_detector"):
            edges_np = np.stack([b.detector(im) for im in imgs])
        if edges_np.ndim == 3:
            edges_np = edges_np[..., None]
        edges_u8 = torch.as_tensor(edges_np, device=dev)
        edges = (edges_u8.to(torch.float32) / 255.0).expand(*edges_u8.shape[:3], 3)

        fresco_state = FrescoState()
        if cfg.use_fresco_attn or cfg.use_fresco_opt or cfg.use_saliency:
            with self._phase("interframe_prep"):
                flows, occs, cf_masks, trajectories = self._interframe(frames_255)
            f, H, W, _ = frames_unit.shape
            lshape = (f, H // 8, W // 8, 4)
            intra_noise = noise.get("intra_noise")
            intra_enc = noise.get("intra_enc_noise")
            if intra_noise is None:
                intra_noise = torch.randn(lshape, generator=self.generator, device=dev)
            if intra_enc is None:
                intra_enc = torch.randn(lshape, generator=self.generator, device=dev)
            with self._phase("intraframe_prep"):
                ref_feats, correlations = self._intraframe(frames_unit, prompt_embeds,
                                                           intra_noise, intra_enc)
            attn = None
            if cfg.use_fresco_attn:
                with self._phase("attn_params"):
                    attn = prepare.build_attn_params(
                        cf_masks if cfg.use_cfattn else None, ref_feats, trajectories,
                        intra_scale=cfg.intraattn_scale_factor,
                        inter_scale=cfg.interattn_scale_factor, cf_key_cap=cfg.cf_key_cap)
            fresco_state = FrescoState(
                attn=attn, fwd_flow=flows[0], bwd_flow=flows[1], fwd_occ=occs[0], bwd_occ=occs[1],
                correlations=correlations if cfg.use_fresco_opt else None)
        return {"frames_unit": frames_unit, "prompt_embeds": prompt_embeds, "edges": edges,
                "fresco_state": fresco_state}

    def _run_batch(self, prepared, record, propagation: bool, noise: dict | None = None):
        """The denoise loop on a ``_prepare_batch`` result.  ``noise`` may
        hold ``init_noise``, ``enc_noise`` and ``step_noise`` (see
        ``FrescoSampler.sample``); missing ones are drawn from the
        pipeline's generator.  Returns (latents, record_out)."""
        cfg = self.config
        noise = noise or {}
        sampler_cfg = dataclasses.replace(self._base_sampler_cfg, propagation_mode=propagation)
        cond_scale = np.full((cfg.num_inference_steps,), cfg.cond_scale)
        with self._phase("denoise_loop"):
            return self.sampler.sample(
                prepared["frames_unit"], prepared["prompt_embeds"], prepared["edges"], cond_scale,
                prepared["fresco_state"], record, sampler_cfg,
                init_noise=noise.get("init_noise"), enc_noise=noise.get("enc_noise"),
                step_noise=noise.get("step_noise"), generator=self.generator)

    def decode(self, latents) -> np.ndarray:
        """Latents -> uint8 keyframes [F,H,W,3] (run_fresco.py:250-253)."""
        with self._phase("vae_decode"):
            return unit_range_to_uint8(self.sampler.decode(latents))
