"""Model stack and keyframe translation (PyTorch).

Counterpart of ``fresco_tpu/pipeline/runner.py`` (reference
run_fresco.py:23-270): ``build_models`` makes the model stack (SD1.5
UNet, ControlNet, VAE, CLIP text encoder, GMFlow, the control detector
and the EGNet saliency function); ``FrescoPipeline`` translates keyframe
batches.  ``translate_keyframes`` is the whole keyframe stage in memory:
frames in, {key index: uint8 keyframe} out, batch after batch with the
inter-batch latent record carried; ``translate_keyframe_files`` wraps it
with the video file, the PNGs under ``save_path`` and ``reuse``.
``evaluate_consistency`` scores a directory of frames.

Weights: every model gets random weights, Flax's default initializers
drawn from a ``torch.Generator`` seeded with ``seed``; Flax weights of
the JAX package load through ``models/convert.py``.  Loading torch
checkpoints (GMFlow, HED, EGNet, SD) is not ported yet.  The control
detector is HED for ``controlnet_type: hed`` when HED weights are given
(``random_aux_weights=True``), else OpenCV's canny where ``cv2`` can be
imported, else none (``ModelBundle.detector`` must then be set).
``ModelBundle.flow_fn`` overrides GMFlow as the flow source.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from fresco_torch.core.config import FrescoConfig, default_prompts, keyframe_sublists
from fresco_torch.diffusion.guidance import GuidanceConfig
from fresco_torch.diffusion.sampler import FrescoSampler, FrescoState, SamplerConfig
from fresco_torch.diffusion.scheduler import DDPMScheduler
from fresco_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from fresco_torch.models.controlnet import ControlNet
from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
from fresco_torch.models.layers import cast_model, init_flax_default_
from fresco_torch.models.unet import UNet2DCondition, UNetConfig
from fresco_torch.models.vae import AutoencoderKL, VAEConfig
from fresco_torch.ops.image import resize_image, unit_range_to_uint8
from fresco_torch.pipeline import prepare
from fresco_torch.pipeline.keyframes import read_video_rgb, select_keyframes_from_frames
from fresco_torch.pipeline.text import encode_prompts, make_tokenizer
from fresco_torch.utils.profiling import PhaseTimes, phase_timer


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
    # [2F,H,W,2] (forward flows, then backward); overrides ``gmflow``
    flow_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None
    gmflow: GMFlow | None = None
    # uint8 RGB [F,H,W,3] -> background mask [F,H/2,W/2,1] (EGNet)
    saliency_fn: Callable[[np.ndarray], torch.Tensor] | None = None


def _no_detector(img: np.ndarray) -> np.ndarray:
    raise NotImplementedError(
        "no control detector: HED needs weights (build_models(random_aux_weights=True); loading "
        "ControlNetHED.pth is not ported) and canny needs OpenCV (cv2); set ModelBundle.detector")


def _canny_detector(img: np.ndarray, low: int = 50, high: int = 100) -> np.ndarray:
    """Canny edges through OpenCV (reference annotator/canny, run_fresco.py:106)."""
    import cv2

    return cv2.Canny(img, low, high)


def _have_cv2() -> bool:
    """Whether OpenCV can be imported (without importing it)."""
    return importlib.util.find_spec("cv2") is not None


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


_AUX_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def aux_dtype(config: FrescoConfig) -> torch.dtype:
    """Weights dtype of GMFlow and EGNet (``config.aux_dtype``)."""
    return _AUX_DTYPES.get(config.aux_dtype, torch.float32)


def _checkpoint_not_ported(path: str, what: str) -> None:
    if path and os.path.exists(str(path)):
        raise NotImplementedError(
            f"loading the {what} checkpoint {path} is not ported yet; move it away to run with "
            "random weights, or pass random_aux_weights=True")


def build_models(config: FrescoConfig, *, tiny: bool = False, seed: int = 0,
                 device: torch.device | str | None = None,
                 random_aux_weights: bool = False) -> ModelBundle:
    """Random-weight model stack at full SD1.5 width or tiny widths.

    Modules are built on the meta device and materialized once on
    ``device``; weights are drawn from a ``torch.Generator`` seeded with
    ``seed`` on that device (``None``: the card; it raises without one).
    The UNet, ControlNet and VAE run in ``config.dtype``, the text
    encoder in float32, EGNet in ``config.aux_dtype``, GMFlow in float32 on
    weights rounded to ``config.aux_dtype`` and HED in float32.

    ``random_aux_weights=True`` gives HED (for ``controlnet_type: hed``,
    full width only) and EGNet (for ``use_saliency``) random weights, so
    that the control detector and background smoothing run without their
    checkpoints.  Without it, HED and EGNet run only from their
    checkpoints, whose loading is not ported: a present checkpoint raises,
    a missing one leaves canny (with ``cv2``) or no detector, and no
    saliency, as in the JAX package."""
    device = resolve_device(device)
    if tiny:
        ucfg, vcfg, ccfg = UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()
        gcfg = GMFlowConfig.tiny()
        cond_embed = (4, 4, 8, 8)
    else:
        ucfg = UNetConfig(use_freeu=config.use_freeu, freeu_b1=config.freeu_b1,
                          freeu_b2=config.freeu_b2, freeu_s1=config.freeu_s1,
                          freeu_s2=config.freeu_s2)
        vcfg, ccfg, gcfg = VAEConfig(), CLIPTextConfig(), GMFlowConfig()
        cond_embed = (16, 32, 96, 256)
    if not random_aux_weights:
        _checkpoint_not_ported(config.gmflow_path, "GMFlow")
    # the cross-attention width is the text encoder's (Flax infers it from
    # the context; the tiny configs leave cross_attention_dim unused)
    ucfg = dataclasses.replace(ucfg, cross_attention_dim=ccfg.hidden_size)
    with torch.device("meta"):
        unet = UNet2DCondition(ucfg)
        vae = AutoencoderKL(vcfg)
        controlnet = ControlNet(ucfg, cond_embed)
        text = CLIPTextEncoder(ccfg)
        gmflow = GMFlow(gcfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = model_dtype(config)
    mods = []
    for m, d in ((unet, dt), (vae, dt), (controlnet, dt), (text, torch.float32)):
        m = m.to_empty(device=device)
        init_flax_default_(m, gen)
        mods.append(cast_model(m, d).eval().requires_grad_(False))
    unet, vae, controlnet, text = mods
    # every GMFlow weight rounded to aux_dtype, norms included (the JAX
    # package casts the whole tree), and held in float32: the forward
    # computes in float32 in both packages (models/gmflow/model.py)
    gmflow = init_flax_default_(gmflow.to_empty(device=device), gen)
    gmflow = gmflow.to(aux_dtype(config)).float().eval().requires_grad_(False)

    tokenizer = make_tokenizer(
        _local_ckpt_dir(config.sd_path, os.path.dirname(str(config.gmflow_path)) or "."),
        ccfg.vocab_size)
    return ModelBundle(unet, vae, controlnet, text,
                       DDPMScheduler(num_inference_steps=config.num_inference_steps),
                       tokenizer, _build_detector(config, tiny, device, gen, random_aux_weights), device,
                       gmflow=gmflow,
                       saliency_fn=_build_saliency(config, device, gen, random_aux_weights))


def _random_module(cls, device, gen, dtype):
    with torch.device("meta"):
        m = cls()
    m = init_flax_default_(m.to_empty(device=device), gen)
    return m.to(dtype).eval().requires_grad_(False)


def _build_detector(config: FrescoConfig, tiny: bool, device, gen, random_aux_weights: bool):
    """The control detector (fresco_tpu runner.py:172-227)."""
    if config.controlnet_type == "hed" and not tiny:
        from fresco_torch.models.hed import HED, hed_detector

        hed_path = os.path.join(os.path.dirname(str(config.gmflow_path)) or ".", "ControlNetHED.pth")
        if random_aux_weights:
            return functools.partial(hed_detector, _random_module(HED, device, gen, torch.float32))
        _checkpoint_not_ported(hed_path, "HED")
    if _have_cv2():
        return functools.partial(_canny_detector, low=config.canny_low, high=config.canny_high)
    return _no_detector


def _build_saliency(config: FrescoConfig, device, gen, random_aux_weights: bool):
    """The EGNet background-mask function, or None without weights."""
    if not config.use_saliency:
        return None
    if not random_aux_weights:
        _checkpoint_not_ported(config.sod_path, "EGNet")
        return None
    from fresco_torch.models.egnet import EGNet, make_saliency_fn

    return make_saliency_fn(_random_module(EGNet, device, gen, aux_dtype(config)))


class FrescoPipeline:
    """run_fresco-equivalent orchestration."""

    # synchronize the device at each phase boundary so phase times are
    # device times, not enqueue times (off by default)
    sync_phases = False

    def __init__(self, config: FrescoConfig, bundle: ModelBundle | None = None, *,
                 tiny: bool = False, device: torch.device | str | None = None):
        """``bundle``: the models (``build_models``; pass one built with
        ``random_aux_weights=True`` for random HED and EGNet weights), else
        a random-weight stack is built."""
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
            bg_smoothing_steps=tuple(config.bg_smoothing_steps),
            end_opt_step=config.end_opt_step,
            guidance=gcfg,
            do_opt=config.use_fresco_opt,
        )

    def _phase(self, name: str):
        return phase_timer(self.phases, name, self.device if self.sync_phases else None)

    def gmflow_flow_fn(self):
        """The bundle's GMFlow as a flow function: frames rounded to
        ``config.aux_dtype``, flows in float32."""
        gm = self.bundle.gmflow
        if gm is None:
            raise RuntimeError("no flow source: the bundle has neither flow_fn nor gmflow")
        dt = aux_dtype(self.config)
        return lambda a, b: gm(a.to(dt).float(), b.to(dt).float())

    def _interframe(self, frames_255):
        flow_fn = self.bundle.flow_fn or self.gmflow_flow_fn()
        return prepare.interframe_params(flow_fn, frames_255, photo_thresh=self.config.photo_occ_thresh)

    def _intraframe(self, frames_unit, prompt_embeds, noise, enc_noise):
        corr_dtype = torch.bfloat16 if self.config.gram_dtype == "bfloat16" else torch.float32
        b = self.bundle
        return prepare.intraframe_params(b.unet, b.vae, b.scheduler, frames_unit, prompt_embeds,
                                         noise=noise, enc_noise=enc_noise, corr_dtype=corr_dtype)

    def _translate_batch(self, imgs, prompts, n_prompts, record, propagation, noise=None):
        """Prep + denoise for one batch."""
        prepared = self._prepare_batch(imgs, prompts, n_prompts, noise)
        return self._run_batch(prepared, record, propagation, noise)

    def _prepare_batch(self, imgs, prompts, n_prompts, noise: dict | None = None,
                       generator: torch.Generator | None = None):
        """Everything the sampler needs that does not depend on earlier
        batches.  ``noise`` may hold ``intra_noise`` / ``intra_enc_noise``
        (the intra-frame pass's diffusion and VAE posterior noise, standard
        normal [F,h,w,4]); missing ones are drawn from ``generator`` (the
        pipeline's by default)."""
        cfg = self.config
        b = self.bundle
        dev = self.device
        gen = generator or self.generator
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
            saliency = None
            if cfg.use_saliency and b.saliency_fn is not None:
                with self._phase("saliency"):
                    saliency = b.saliency_fn(np.stack(imgs))
            f, H, W, _ = frames_unit.shape
            lshape = (f, H // 8, W // 8, 4)
            intra_noise = noise.get("intra_noise")
            intra_enc = noise.get("intra_enc_noise")
            if intra_noise is None:
                intra_noise = torch.randn(lshape, generator=gen, device=dev)
            if intra_enc is None:
                intra_enc = torch.randn(lshape, generator=gen, device=dev)
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
                saliency=saliency, correlations=correlations if cfg.use_fresco_opt else None)
        return {"frames_unit": frames_unit, "prompt_embeds": prompt_embeds, "edges": edges,
                "fresco_state": fresco_state}

    def _run_batch(self, prepared, record, propagation: bool, noise: dict | None = None,
                   generator: torch.Generator | None = None):
        """The denoise loop on a ``_prepare_batch`` result.  ``noise`` may
        hold ``init_noise``, ``enc_noise``, ``step_noise`` and
        ``bg_enc_noise`` (see ``FrescoSampler.sample``); missing ones are
        drawn from ``generator`` (the pipeline's by default).  Returns
        (latents, record_out)."""
        cfg = self.config
        noise = noise or {}
        sampler_cfg = dataclasses.replace(self._base_sampler_cfg, propagation_mode=propagation)
        cond_scale = np.full((cfg.num_inference_steps,), cfg.cond_scale)
        with self._phase("denoise_loop"):
            return self.sampler.sample(
                prepared["frames_unit"], prepared["prompt_embeds"], prepared["edges"], cond_scale,
                prepared["fresco_state"], record, sampler_cfg,
                init_noise=noise.get("init_noise"), enc_noise=noise.get("enc_noise"),
                step_noise=noise.get("step_noise"), bg_enc_noise=noise.get("bg_enc_noise"),
                generator=generator or self.generator)

    def decode(self, latents) -> np.ndarray:
        """Latents -> uint8 keyframes [F,H,W,3] (run_fresco.py:250-253)."""
        with self._phase("vae_decode"):
            return unit_range_to_uint8(self.sampler.decode(latents))

    # --- the keyframe stage -------------------------------------------------
    def keyframe_batches(self, frames, key_ind: list[int] | None = None) -> list[tuple]:
        """(key indices, images, prompts, negative prompts) of each batch of
        the keyframe stage (run_fresco.py:111-175).  ``key_ind``: the
        keyframes (selected from the frames when None).

        Batches follow ``keyframe_sublists``; each later batch puts two
        anchors in front, the first keyframe overall and the previous
        batch's last keyframe (input frames, not outputs)."""
        cfg = self.config
        if key_ind is None:
            key_ind = select_keyframes_from_frames(frames, cfg.mininterv, cfg.maxinterv)
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

    def translate_keyframes(self, frames, key_ind: list[int] | None = None, *,
                            noise: list[dict] | None = None, verbose: bool = False,
                            on_batch: Callable[[dict[int, np.ndarray]], None] | None = None,
                            ) -> dict[int, np.ndarray]:
        """The keyframe stage in memory (run_fresco.py:111-270): uint8 RGB
        frames [H, W, 3] (at the working resolution) in, {key index: uint8
        RGB keyframe} out, batch by batch (``keyframe_batches``) with the
        latent record of each batch carried into the next.

        Every batch draws its noise from a fresh generator seeded with
        ``config.seed`` (the JAX package hands every batch the same key);
        ``noise[k]`` overrides batch k's (see ``_prepare_batch`` and
        ``_run_batch``).  Each batch's prep runs after the previous batch's
        decode: the JAX package's prep thread is not ported, since
        overlapping the prep with the previous denoise on a stream of its
        own was no faster on an H100 80GB HBM3 at 700 W
        (``ab_prep_overlap.py``).  ``on_batch``, when given, is called with
        each batch's {key index: keyframe} right after its decode, before
        the next batch starts (``translate_keyframe_files`` writes them
        there, as the JAX runner does)."""
        from fresco_torch.utils.guards import check_finite

        batches = self.keyframe_batches(frames, key_ind)
        if verbose:
            print(f"[fresco_torch] {len(batches)} batches: {[b[0] for b in batches]}")
        result: dict[int, np.ndarray] = {}
        record = None
        for bi, (sub, imgs, prompts, negs) in enumerate(batches):
            t0 = time.perf_counter()
            gen = torch.Generator(device=self.device).manual_seed(self.config.seed)
            nz = noise[bi] if noise else None
            prepared = self._prepare_batch(imgs, prompts, negs, nz, generator=gen)
            latents, record = self._run_batch(prepared, record, bi > 0, nz, generator=gen)
            check_finite(f"batch{bi}_latents", latents)
            images = self.decode(latents)
            bias = 2 if bi > 0 else 0
            done = {num: images[ind + bias] for ind, num in enumerate(sub)}
            result.update(done)
            if on_batch is not None:
                on_batch(done)
            if verbose:
                print(f"[fresco_torch] batch {bi + 1}/{len(batches)}: {len(sub)} keyframes in "
                      f"{time.perf_counter() - t0:.1f}s")
        if verbose:
            print("[fresco_torch] " + self.phases.report())
        return result

    def translate_keyframe_files(self, verbose: bool = True, reuse: bool = False) -> list[int]:
        """``translate_keyframes`` on the config's video file (decoded once,
        with OpenCV): the keyframes are selected on the decoded frames,
        every frame resized to the working resolution is written to
        save_path/video/%04d.png and the keyframes to save_path/keys/%04d.png,
        each batch's as soon as it is decoded (fresco_tpu/pipeline/runner.py
        writes them the same way), so a late failure keeps the batches
        before it.  ``reuse``: when every keyframe PNG exists already, skip the
        translation.  Returns the key indices."""
        from fresco_torch.propagate.video_blend import _codec

        Image = _codec()
        cfg = self.config
        for sub in ("keys", "video"):
            os.makedirs(os.path.join(cfg.save_path, sub), exist_ok=True)
        raw = read_video_rgb(cfg.file_path, int(cfg.frame_count) if cfg.frame_count else int(1e10))
        keys = select_keyframes_from_frames(raw, cfg.mininterv, cfg.maxinterv)
        frames = [resize_image(f, cfg.resolution) for f in raw]
        del raw
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(cfg.save_path, "video", "%04d.png" % i))
        key_path = lambda k: os.path.join(cfg.save_path, "keys", "%04d.png" % k)  # noqa: E731
        if reuse and all(os.path.exists(key_path(k)) for k in keys):
            if verbose:
                print("[fresco_torch] all keyframes present: skipping translation (resume)")
            return keys

        def save(batch: dict[int, np.ndarray]) -> None:
            for k, img in batch.items():
                Image.fromarray(img).save(key_path(k))

        self.translate_keyframes(frames, keys, verbose=verbose, on_batch=save)
        return keys

    def consistency_flow_fn(self):
        """The flow source of the metrics and the CLI's propagation: OpenCV's
        Farneback where ``cv2`` can be imported (random GMFlow weights give
        meaningless flows), else the bundle's GMFlow."""
        if _have_cv2():
            from fresco_torch.utils.classic_flow import pairwise_flow_fn

            return pairwise_flow_fn()
        return self.gmflow_flow_fn()

    def evaluate_consistency(self, frame_dir: str, max_frames: int = 32) -> dict:
        """Warp error and frame similarity of a frame directory (a centred
        window of ``max_frames`` consecutive frames)."""
        from fresco_torch import metrics
        from fresco_torch.propagate.video_blend import _codec

        files = sorted(f for f in os.listdir(frame_dir) if f.endswith((".png", ".jpg")))
        if len(files) > max_frames:
            lo = (len(files) - max_frames) // 2
            files = files[lo : lo + max_frames]
        if len(files) < 2:
            return {}
        Image = _codec()
        frames = np.stack([np.asarray(Image.open(os.path.join(frame_dir, f)).convert("RGB")) for f in files])
        return metrics.evaluate_translation(frames, self.consistency_flow_fn(), self.device)
