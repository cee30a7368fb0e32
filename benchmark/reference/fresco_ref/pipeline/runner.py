"""The keyframe stage, frozen: prep, denoise and decode of each batch.

A plain copy of the port's ``FrescoPipeline`` keyframe path as it stood
when the benchmark was written (one process, no mesh, no checkpoint
loading): ``translate_keyframes`` takes uint8 RGB frames at the working
resolution, the key indices and every batch's noise, and returns
{key index: uint8 RGB keyframe}.  The models come in a ``ModelBundle``
whose weights the benchmark made.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from benchmark.reference.fresco_ref.core.config import FrescoConfig, default_prompts, keyframe_sublists
from benchmark.reference.fresco_ref.diffusion.guidance import GuidanceConfig
from benchmark.reference.fresco_ref.diffusion.sampler import FrescoSampler, FrescoState, SamplerConfig
from benchmark.reference.fresco_ref.diffusion.scheduler import DDPMScheduler
from benchmark.reference.fresco_ref.models.gmflow import GMFlow
from benchmark.reference.fresco_ref.ops.image import unit_range_to_uint8
from benchmark.reference.fresco_ref.pipeline import prepare
from benchmark.reference.fresco_ref.pipeline.text import encode_prompts

_MODEL_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64}
_AUX_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def model_dtype(config: FrescoConfig) -> torch.dtype:
    """The UNet / ControlNet / VAE dtype."""
    return _MODEL_DTYPES.get(config.dtype, torch.float32)


def frame_dtype(config: FrescoConfig) -> torch.dtype:
    return torch.float64 if config.dtype == "float64" else torch.float32


def aux_dtype(config: FrescoConfig) -> torch.dtype:
    """Weights dtype of GMFlow and EGNet."""
    return _AUX_DTYPES.get(config.aux_dtype, torch.float32)


@dataclasses.dataclass
class ModelBundle:
    unet: Any
    vae: Any
    controlnet: Any
    text_encoder: Any
    tokenizer: Any
    detector: Callable[[np.ndarray], np.ndarray]
    device: torch.device
    gmflow: GMFlow | None = None
    saliency_fn: Callable[[np.ndarray], torch.Tensor] | None = None


class FrescoPipeline:
    def __init__(self, config: FrescoConfig, bundle: ModelBundle):
        if config.use_freeu:
            raise ValueError("the frozen keyframe path has no FreeU")
        self.bundle = bundle
        self.device = bundle.device
        self.config = config
        self.sampler = FrescoSampler(bundle.unet, bundle.vae, bundle.controlnet,
                                     DDPMScheduler(num_inference_steps=config.num_inference_steps))
        gcfg = GuidanceConfig(iters=config.opt_iters, lr=config.opt_lr, intra_weight=config.intra_weight,
                              optimize_temporal=config.optimize_temporal, gram_dtype=config.gram_dtype)
        self.sampler_cfg = SamplerConfig(
            num_inference_steps=config.num_inference_steps, num_warmup_steps=config.num_warmup_steps,
            guidance_scale=config.guidance_scale, use_controlnet=config.use_controlnet,
            repeat_noise=config.repeat_noise, num_intraattn_steps=config.num_intraattn_steps,
            step_interattn_end=config.step_interattn_end, bg_smoothing_steps=tuple(config.bg_smoothing_steps),
            end_opt_step=config.end_opt_step, guidance=gcfg, do_opt=config.use_fresco_opt)

    def flow_fn(self, a, b):
        """GMFlow on frames rounded to ``aux_dtype``, flows in float32."""
        dt = aux_dtype(self.config)
        with torch.no_grad():
            return self.bundle.gmflow(a.to(dt).float(), b.to(dt).float()).to(frame_dtype(self.config))

    def _prepare_batch(self, imgs, prompts, n_prompts, noise: dict):
        cfg, b, dev = self.config, self.bundle, self.device
        ftype = frame_dtype(cfg)
        frames_255 = torch.as_tensor(np.stack(imgs), device=dev).to(ftype)
        frames_unit = frames_255 / 255.0 * 2.0 - 1.0
        prompt_embeds = encode_prompts(b.text_encoder, b.tokenizer, prompts, n_prompts)
        edges_np = np.stack([b.detector(im) for im in imgs])
        if edges_np.ndim == 3:
            edges_np = edges_np[..., None]
        edges_u8 = torch.as_tensor(edges_np, device=dev)
        edges = (edges_u8.to(ftype) / 255.0).expand(*edges_u8.shape[:3], 3)
        fresco_state = FrescoState()
        if cfg.use_fresco_attn or cfg.use_fresco_opt or cfg.use_saliency:
            flows, occs, cf_masks, trajectories = prepare.interframe_params(
                self.flow_fn, frames_255, photo_thresh=cfg.photo_occ_thresh)
            saliency = None
            if cfg.use_saliency and b.saliency_fn is not None:
                saliency = b.saliency_fn(np.stack(imgs))
            if cfg.dtype == "float64":
                corr_dtype = torch.float64
            else:
                corr_dtype = torch.bfloat16 if cfg.gram_dtype == "bfloat16" else torch.float32
            ref_feats, correlations = prepare.intraframe_params(
                b.unet, b.vae, self.sampler.scheduler, frames_unit, prompt_embeds,
                noise=noise["intra_noise"], enc_noise=noise["intra_enc_noise"], corr_dtype=corr_dtype)
            attn = None
            if cfg.use_fresco_attn:
                attn = prepare.build_attn_params(
                    cf_masks if cfg.use_cfattn else None, ref_feats, trajectories,
                    intra_scale=cfg.intraattn_scale_factor, inter_scale=cfg.interattn_scale_factor,
                    cf_key_cap=cfg.cf_key_cap)
            fresco_state = FrescoState(
                attn=attn, fwd_flow=flows[0], bwd_flow=flows[1], fwd_occ=occs[0], bwd_occ=occs[1],
                saliency=saliency, correlations=correlations if cfg.use_fresco_opt else None)
        return frames_unit, prompt_embeds, edges, fresco_state

    def keyframe_batches(self, frames, key_ind: list[int]) -> list[tuple]:
        """(key indices, images, prompts, negative prompts) of each batch;
        each later batch puts the first keyframe overall and the previous
        batch's last keyframe in front as anchors."""
        cfg = self.config
        sublists = keyframe_sublists([k for k in key_ind if k < len(frames)], cfg.batch_size)
        a_prompt, n_prompt = default_prompts(cfg.sd_path)
        a_prompt = cfg.a_prompt if cfg.a_prompt is not None else a_prompt
        n_prompt = cfg.n_prompt if cfg.n_prompt is not None else n_prompt
        extra = dict(cfg.extra_prompts)
        batches = []
        for bi, sub in enumerate(sublists):
            imgs = [frames[i] for i in sub]
            prompts = [cfg.prompt + a_prompt + extra.get(i, "") for i in sub]
            if bi > 0:
                imgs = [batches[0][1][0], batches[-1][1][-1]] + imgs
                prompts = [batches[0][2][0], batches[-1][2][-1]] + prompts
            batches.append((sub, imgs, prompts, [n_prompt] * len(imgs)))
        return batches

    @torch.no_grad()
    def translate_keyframes(self, frames, key_ind: list[int], noise: list[dict],
                            n_batches: int | None = None) -> dict[int, np.ndarray]:
        """The first ``n_batches`` batches (all by default) of the keyframe
        stage with the latent record carried from batch to batch."""
        cfg = self.config
        result: dict[int, np.ndarray] = {}
        record = None
        for bi, (sub, imgs, prompts, negs) in enumerate(self.keyframe_batches(frames, key_ind)[:n_batches]):
            nz = noise[bi]
            frames_unit, prompt_embeds, edges, state = self._prepare_batch(imgs, prompts, negs, nz)
            scfg = dataclasses.replace(self.sampler_cfg, propagation_mode=bi > 0)
            cond_scale = np.full((cfg.num_inference_steps,), cfg.cond_scale)
            latents, record = self.sampler.sample(
                frames_unit, prompt_embeds, edges, cond_scale, state, record, scfg,
                init_noise=nz["init_noise"], enc_noise=nz["enc_noise"], step_noise=nz["step_noise"],
                bg_enc_noise=nz["bg_enc_noise"])
            images = unit_range_to_uint8(self.sampler.decode(latents))
            bias = 2 if bi > 0 else 0
            result.update({num: images[ind + bias] for ind, num in enumerate(sub)})
        return result
