"""FRESCO denoising sampler for one keyframe batch.

Counterpart of ``fresco_tpu/diffusion/sampler.py`` (reference
src/pipe_FRESCO.py:80-233): VAE encode (SDEdit init), then a Python loop
over the denoise steps — ControlNet, the FRESCO UNet (attention variants
and the feature optimization through ``guidance_fn``), CFG and the DDPM
step.  The per-step gates are Python bools.

Noise enters as arguments (the SDEdit init noise, the VAE posterior
noise, the per-step variance noise), so a test can hand both packages
the same arrays; when one is not given it is drawn from the
``torch.Generator`` passed in, on the frames' device.

``torch.profiler`` ranges (``fresco::controlnet``, ``fresco::unet``,
``fresco::optimize_feature``, the last nested in the UNet's) let a trace
split the loop; they cost a few microseconds per step when no profiler
runs.

Inter-batch propagation (pipe_FRESCO.py:175-179): ``record_in`` holds
anchor latents per step from the previous batch, ``record_out`` this
batch's.

Background smoothing (FRESCO's third mechanism, given a saliency
background mask): the optimized decoder features go through
``warp_and_fuse`` after the feature optimization, and at
``bg_smoothing_steps`` the predicted x0 is VAE-decoded, fused in image
space (chunk 1) and re-encoded, in frame groups of gcd(F, bg_vae_chunk)
(pipe_FRESCO.py:222-228).

Over a mesh (``FrescoSampler.mesh``, frames over ``data``) every rank
holds the whole latents, draws the whole batch's noise and runs the DDPM
step, record and restore on them alike; it runs the VAE, the ControlNet
and the UNet on its own frames (the CFG pair of each) and gathers their
outputs, and the FRESCO attention, the feature optimization and the
smoothing gather what couples frames.  A batch whose frames ``data`` does
not divide is replicated over ``data`` (``Mesh.for_frames``).  The
float64 mode (``frames`` in float64) keeps the latents in float64.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.profiler import record_function

from fresco_torch.attention.fresco_attention import FrescoAttnParams
from fresco_torch.core.comm import Mesh, gather_frames, local_frames
from fresco_torch.diffusion.guidance import GuidanceConfig, optimize_feature
from fresco_torch.diffusion.scheduler import DDPMScheduler
from fresco_torch.models.controlnet import embed_cond
from fresco_torch.ops.blend import warp_and_fuse


@dataclasses.dataclass
class FrescoState:
    """Per-batch precomputed FRESCO inputs (all optional)."""

    attn: FrescoAttnParams | None = None
    fwd_flow: torch.Tensor | None = None  # [F, H, W, 2]
    bwd_flow: torch.Tensor | None = None
    fwd_occ: torch.Tensor | None = None   # [F, H, W]
    bwd_occ: torch.Tensor | None = None
    saliency: torch.Tensor | None = None  # [F, h, w, 1] background mask
    correlations: dict | None = None      # {stage: [2F, hw, C]} factored


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_inference_steps: int = 20
    num_warmup_steps: int = 6
    guidance_scale: float = 7.5
    use_controlnet: bool = True
    repeat_noise: bool = True        # initial SDEdit noise tiled over frames
    num_intraattn_steps: int = 1
    step_interattn_end: int = 350
    bg_smoothing_steps: tuple[int, ...] = (16, 17)
    end_opt_step: int = 15
    opt_layers: tuple[int, ...] = (0, 1, 2, 3)
    guidance: GuidanceConfig = GuidanceConfig()
    propagation_mode: bool = False
    do_opt: bool = True
    bg_smooth_latents: bool = True  # decoded-image smoothing at bg_smoothing_steps
    bg_vae_chunk: int = 8           # frames per VAE round-trip group


class FrescoSampler:
    def __init__(self, unet, vae, controlnet, scheduler: DDPMScheduler, mesh: Mesh | None = None):
        self.unet, self.vae, self.controlnet, self.scheduler = unet, vae, controlnet, scheduler
        self.mesh = mesh or Mesh()

    def step_gates(self, cfg: SamplerConfig) -> list[dict]:
        """Per-step gates (pipe_FRESCO.py:171-174,222-228): one dict per
        step with t, use_intra, use_inter, do_opt, do_bg, step_index."""
        warmup = max(cfg.num_warmup_steps, 0)
        ts = self.scheduler.timesteps_np[warmup:]
        return [
            dict(t=int(t), use_intra=i < cfg.num_intraattn_steps,
                 use_inter=bool(t >= cfg.step_interattn_end),
                 do_opt=(i + warmup < cfg.end_opt_step) and cfg.do_opt,
                 do_bg=(i + warmup) in cfg.bg_smoothing_steps,
                 step_index=i + warmup)
            for i, t in enumerate(ts)
        ]

    def sample_noise(self, frames: torch.Tensor, cfg: SamplerConfig, gen: torch.Generator):
        """Draw the three noise inputs of ``sample`` from ``gen``."""
        f, H, W, _ = frames.shape
        shape = (f, H // 8, W // 8, 4)
        dev = frames.device
        init = torch.randn((1, *shape[1:]) if cfg.repeat_noise else shape, generator=gen, device=dev)
        n_steps = len(self.step_gates(cfg))
        return dict(
            init_noise=init.expand(shape),
            enc_noise=torch.randn(shape, generator=gen, device=dev),
            step_noise=torch.randn((n_steps, *shape), generator=gen, device=dev),
        )

    def _smooth_x0(self, x0, fresco: FrescoState, cfg: SamplerConfig, noise, lat_t, mesh: Mesh):
        """Decoded-image background smoothing of the predicted x0: VAE
        decode, ``warp_and_fuse`` (chunk 1), VAE encode with ``noise[g]``
        as group g's posterior noise, in groups of gcd(F, bg_vae_chunk).
        Over a mesh each rank decodes and encodes its own frames."""
        f = x0.shape[0]
        g = math.gcd(f // mesh.data, cfg.bg_vae_chunk)
        with record_function("fresco::bg_smoothing"):
            x0_l = local_frames(x0, mesh)
            img = torch.cat([self.vae.decode(x0_l[i : i + g]) for i in range(0, x0_l.shape[0], g)])
            img = gather_frames(img.to(lat_t), mesh)
            img = warp_and_fuse(img, fresco.fwd_flow, fresco.bwd_flow, fresco.fwd_occ,
                                fresco.bwd_occ, fresco.saliency, chunk=1)
            img_l, noise_l = local_frames(img, mesh), local_frames(torch.cat(list(noise)), mesh)
            return gather_frames(torch.cat([self.vae.encode(img_l[i : i + g], noise_l[i : i + g]).to(lat_t)
                                            for i in range(0, img_l.shape[0], g)]), mesh)

    @torch.no_grad()
    def sample(self, frames, prompt_embeds, edges, cond_scale, fresco: FrescoState,
               record_in, cfg: SamplerConfig, *, init_noise=None, enc_noise=None,
               step_noise=None, bg_enc_noise=None, generator: torch.Generator | None = None):
        """Translate one keyframe batch.

        frames [F,H,W,3] in [-1,1]; prompt_embeds [2F,77,C] (uncond
        first); edges [F,H,W,3] in [0,1] or None; cond_scale: per-step
        ControlNet scales [T]; record_in [T',2,h,w,4] or None.  Noise:
        init_noise [F,h,w,4], enc_noise [F,h,w,4], step_noise [T',F,h,w,4],
        bg_enc_noise {step index: [group noise [g,h,w,4], ...]} for the
        background-smoothing re-encode (drawn from ``generator`` where
        missing).  Every input holds the whole batch, on every rank of a
        mesh, except ``fresco.attn.ref_features`` and
        ``fresco.correlations``, which hold this rank's frames.  Returns
        (latents [F,h,w,4], record_out [T',2,h,w,4]), whole on every rank."""
        f = frames.shape[0]
        s = self.scheduler
        mesh = self.mesh.for_frames(f)
        fm = mesh if mesh.data > 1 else None
        lat_t = torch.promote_types(frames.dtype, torch.float32)
        if init_noise is None or enc_noise is None or step_noise is None:
            if generator is None:
                raise ValueError("sample: pass the noise tensors or a generator")
            drawn = self.sample_noise(frames, cfg, generator)
            init_noise = drawn["init_noise"] if init_noise is None else init_noise
            enc_noise = drawn["enc_noise"] if enc_noise is None else enc_noise
            step_noise = drawn["step_noise"] if step_noise is None else step_noise

        if cfg.num_warmup_steps < 0:
            latents = init_noise.to(lat_t)  # pure-noise init (pipe_FRESCO.py:155-157)
        else:
            latent_x0 = gather_frames(self.vae.encode(local_frames(frames, mesh), local_frames(enc_noise, mesh))
                                      .to(lat_t), mesh)
            latents = s.add_noise(latent_x0, init_noise.to(lat_t), int(s.timesteps_np[cfg.num_warmup_steps]))

        gates = self.step_gates(cfg)
        rec_list = []
        cond_emb = None
        if cfg.use_controlnet and edges is not None:
            cond_emb = embed_cond(self.controlnet, torch.cat([local_frames(edges, mesh)] * 2, dim=0))
        prompt_embeds = local_frames(prompt_embeds, mesh, chunk=2)
        scales = np.asarray(cond_scale, dtype=np.float64)[max(cfg.num_warmup_steps, 0):]

        for i, gate in enumerate(gates):
            t = gate["t"]
            if cfg.propagation_mode and record_in is not None:
                latents = latents.clone()
                latents[0:2] = record_in[i].to(lat_t)
            rec_list.append(torch.stack([latents[0], latents[f - 1]]))

            lmi = torch.cat([local_frames(latents, mesh)] * 2, dim=0)
            ctrl = None
            if cond_emb is not None:
                with record_function("fresco::controlnet"):
                    ctrl = self.controlnet(lmi, t, prompt_embeds, cond_emb, float(scales[i]),
                                           cond_is_embedded=True)
            attn = fresco.attn
            if attn is not None:
                attn = dataclasses.replace(attn, use_intra=gate["use_intra"], use_inter=gate["use_inter"], mesh=fm)
            guidance_fn = None
            if gate["do_opt"] and (fresco.correlations is not None or fresco.fwd_flow is not None):
                def guidance_fn(stage, x):
                    if stage not in cfg.opt_layers:
                        return x
                    corr = fresco.correlations.get(stage) if fresco.correlations is not None else None
                    with record_function("fresco::optimize_feature"):
                        y = optimize_feature(x, fresco.fwd_flow, fresco.bwd_flow, fresco.fwd_occ,
                                             fresco.bwd_occ, corr, cfg.guidance, corr_is_dense=False, mesh=fm)
                    if fresco.saliency is not None and fresco.fwd_flow is not None:
                        with record_function("fresco::bg_smoothing"):
                            y = warp_and_fuse(y, fresco.fwd_flow, fresco.bwd_flow, fresco.fwd_occ,
                                              fresco.bwd_occ, fresco.saliency, chunk=cfg.guidance.chunk, mesh=fm)
                    return y
            with record_function("fresco::unet"):
                eps = self.unet(lmi, t, prompt_embeds, controlnet_residuals=ctrl, fresco=attn,
                                guidance_fn=guidance_fn).to(lat_t)
            eps_u, eps_c = eps.chunk(2, dim=0)
            eps = gather_frames(eps_u + cfg.guidance_scale * (eps_c - eps_u), mesh)

            pred_x0 = s.predict_x0(latents, eps, t)
            if gate["do_bg"] and cfg.bg_smooth_latents and fresco.saliency is not None:
                noise = (bg_enc_noise or {}).get(gate["step_index"])
                if noise is None:
                    if generator is None:
                        raise ValueError("sample: pass bg_enc_noise or a generator")
                    g = math.gcd(f, cfg.bg_vae_chunk)
                    noise = [torch.randn((g, *latents.shape[1:]), generator=generator, device=latents.device)
                             for _ in range(f // g)]
                pred_x0 = self._smooth_x0(pred_x0, fresco, cfg, noise, lat_t, mesh)
            latents = s.step_from_x0(latents, pred_x0, t, step_noise[i])
        return latents, torch.stack(rec_list)

    @torch.no_grad()
    def decode(self, latents):
        """Final VAE decode to [-1,1] images, f32 (f64 stays f64)
        (run_fresco.py:250-253); over a mesh each rank decodes its frames
        and the images are gathered."""
        mesh = self.mesh.for_frames(latents.shape[0])
        img = self.vae.decode(local_frames(latents, mesh))
        img = img.to(torch.promote_types(img.dtype, torch.float32))
        return torch.clamp(gather_frames(img, mesh), -1.0, 1.0)
