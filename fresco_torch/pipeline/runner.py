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

Weights: every model first gets random weights, Flax's default
initializers drawn from a ``torch.Generator`` seeded with ``seed``; then
``build_models`` loads the checkpoints it finds in
``scripts/fetch_weights.py``'s layout (``_maybe_load_pretrained``: SD1.5
UNet / VAE / text encoder under ``sd_path``, ``vae_path``, the ControlNet
under ``controlnet_path`` or ``sd-controlnet-<type>``, GMFlow at
``gmflow_path``, the control detector beside it, EGNet at ``sod_path``) through
``models/convert.py``, and merges ``lora_path``.  The control detector
is HED, MiDaS depth, M-LSD or the OpenPose body model for
``controlnet_type`` hed, depth, mlsd or openpose / pose (from its
checkpoint beside ``gmflow_path``, or random weights with
``random_aux_weights=True``; OpenPose also needs ``cv2``), else OpenCV's
canny where ``cv2`` can be imported, else none (``ModelBundle.detector``
must then be set).  ``ModelBundle.flow_fn`` overrides GMFlow as the flow
source.

A ``mesh_shape`` (data, model) of more than one rank runs SPMD, one
process per rank (F23, ``parallel/sharding.py``): the process group must
be initialized with ``prod(mesh_shape)`` ranks (``torchrun
--nproc-per-node N``, or ``parallel.distributed.initialize``), else the
pipeline raises before it builds a model.  The UNet, ControlNet, VAE, text
encoder and GMFlow are split over the mesh's ``model`` axis.  Every rank
reads the same inputs and gets the whole result; only rank 0 writes files.
``dtype="float64"`` computes the UNet, ControlNet, VAE, flows, grams,
latents and feature optimization in float64 (the sharding-validation
mode; on the card the kernels refuse it and raise).
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
from fresco_torch.models.convert import load_into, load_torch_state_dict
from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
from fresco_torch.models.layers import cast_model, init_flax_default_
from fresco_torch.models.unet import UNet2DCondition, UNetConfig
from fresco_torch.models.vae import AutoencoderKL, VAEConfig
from fresco_torch.ops.image import resize_image, unit_range_to_uint8
from fresco_torch.pipeline import prepare
from fresco_torch.pipeline.keyframes import read_video_rgb, select_keyframes_from_frames
from fresco_torch.pipeline.text import HashTokenizer, encode_prompts, make_tokenizer
from fresco_torch.utils.profiling import PhaseTimes, phase_timer


@dataclasses.dataclass
class ModelBundle:
    unet: UNet2DCondition
    vae: AutoencoderKL
    controlnet: ControlNet
    text_encoder: CLIPTextEncoder
    tokenizer: Any
    detector: Callable[[np.ndarray], np.ndarray]
    device: torch.device
    # bidirectional flow: (frames, rolled) [F,H,W,3] in [0,255] ->
    # [2F,H,W,2] (forward flows, then backward); overrides ``gmflow``
    flow_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None
    gmflow: GMFlow | None = None
    # uint8 RGB [F,H,W,3] -> background mask [F,H/2,W/2,1] (EGNet)
    saliency_fn: Callable[[np.ndarray], torch.Tensor] | None = None
    # seconds spent on each loaded checkpoint: {model: {read, convert, to_device}}
    load_seconds: dict = dataclasses.field(default_factory=dict)
    # the mesh whose model axis the five models are split over (None: whole)
    tp_mesh: Any = None
    # a whole copy of a split ``gmflow``, for a rank that goes on alone
    # (``FrescoPipeline.whole_gmflow``)
    gmflow_whole: GMFlow | None = None


def _no_detector(img: np.ndarray) -> np.ndarray:
    raise NotImplementedError(
        "no control detector: HED, MiDaS, M-LSD and OpenPose need their checkpoint beside gmflow_path (or "
        "build_models(random_aux_weights=True)) and canny needs OpenCV (cv2); set ModelBundle.detector")


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


_MODEL_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64}


def model_dtype(config: FrescoConfig) -> torch.dtype:
    """The UNet / ControlNet / VAE dtype: bfloat16, float64 (the
    sharding-validation mode, ``fresco_tpu/pipeline/runner.py:84-90``),
    else float32."""
    return _MODEL_DTYPES.get(config.dtype, torch.float32)


def frame_dtype(config: FrescoConfig) -> torch.dtype:
    """The frames' and flows' dtype: float64 in the float64 mode, else float32."""
    return torch.float64 if config.dtype == "float64" else torch.float32


_AUX_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def aux_dtype(config: FrescoConfig) -> torch.dtype:
    """Weights dtype of GMFlow and EGNet (``config.aux_dtype``)."""
    return _AUX_DTYPES.get(config.aux_dtype, torch.float32)


def build_models(config: FrescoConfig, *, tiny: bool = False, seed: int = 0,
                 device: torch.device | str | None = None,
                 random_aux_weights: bool = False, load_weights: bool = True) -> ModelBundle:
    """The model stack at full SD1.5 width or tiny widths.

    Modules are built on the meta device and materialized once on
    ``device``, with random weights drawn from a ``torch.Generator`` seeded
    with ``seed`` on that device (``None``: the card; it raises without
    one).  With ``load_weights``, the checkpoints found replace them (SD
    weights only at full width, ``_maybe_load_pretrained``) and a LoRA is
    merged at any width (``_maybe_apply_lora``), in the checkpoint's dtype,
    before the cast below; a run without checkpoints draws the same
    weights as one with ``load_weights=False``.  The UNet, ControlNet and
    VAE run in ``config.dtype``, the text encoder in float32, EGNet in
    ``config.aux_dtype``, GMFlow in float32 on weights rounded to
    ``config.aux_dtype`` and the control detector in float32.

    The control detector (HED, MiDaS, M-LSD or OpenPose by
    ``controlnet_type``, full width only) and EGNet (for
    ``use_saliency``) load their checkpoints; ``random_aux_weights=True``
    gives them random weights where the checkpoint is missing, so that the
    control detector and background smoothing run without it.  Without
    either, the detector falls back to canny (with ``cv2``) or none, and
    saliency is off, as in the JAX package."""
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
    # the cross-attention width is the text encoder's (Flax infers it from
    # the context; the tiny configs leave cross_attention_dim unused)
    ucfg = dataclasses.replace(ucfg, cross_attention_dim=ccfg.hidden_size)
    with torch.device("meta"):
        mods = {"unet": UNet2DCondition(ucfg), "vae": AutoencoderKL(vcfg),
                "controlnet": ControlNet(ucfg, cond_embed), "text": CLIPTextEncoder(ccfg),
                "gmflow": GMFlow(gcfg)}
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, m in mods.items():
        mods[name] = init_flax_default_(m.to_empty(device=device), gen)
    load_seconds: dict = {}
    loaded = _maybe_load_pretrained(config, mods, load_seconds) if load_weights and not tiny else {}
    if load_weights:
        loaded = _maybe_apply_lora(loaded, mods, config)
    for name, sd in loaded.items():
        t0 = time.perf_counter()
        load_into(mods[name], sd)
        _loaded(name, load_seconds, device, t0)
    dt = model_dtype(config)
    unet, vae, controlnet, text = (
        cast_model(mods[n], d).eval().requires_grad_(False)
        for n, d in (("unet", dt), ("vae", dt), ("controlnet", dt), ("text", torch.float32)))
    # every GMFlow weight rounded to aux_dtype, norms included (the JAX
    # package casts the whole tree), and held in float32: the forward
    # computes in float32 in both packages (models/gmflow/model.py)
    gmflow = mods["gmflow"].to(aux_dtype(config)).float().eval().requires_grad_(False)

    tokenizer = _make_tokenizer(config, ccfg, text_loaded="text" in load_seconds)
    detector = _build_detector(config, tiny, device, gen, random_aux_weights, load_seconds)
    saliency_fn = _build_saliency(config, device, gen, random_aux_weights, load_seconds)
    return ModelBundle(unet, vae, controlnet, text, tokenizer, detector, device, gmflow=gmflow,
                       saliency_fn=saliency_fn, load_seconds=load_seconds)


def _make_tokenizer(config: FrescoConfig, ccfg: CLIPTextConfig, text_loaded: bool):
    """CLIP's tokenizer from ``sd_path``'s files, else ``HashTokenizer``
    (``fresco_tpu/pipeline/text.py:66-72``); says so when real text-encoder
    weights would get hashed ids."""
    tokenizer = make_tokenizer(
        _local_ckpt_dir(config.sd_path, os.path.dirname(str(config.gmflow_path)) or "."),
        ccfg.vocab_size)
    if text_loaded and isinstance(tokenizer, HashTokenizer):
        print("[fresco_torch] text encoder weights loaded, but no CLIP tokenizer (needs transformers and "
              "the tokenizer files under sd_path): prompts are hashed by HashTokenizer, not CLIP's BPE")
    return tokenizer


def _find(base, sub: str, names) -> str | None:
    """The first of ``names`` under ``base/sub`` that exists."""
    if not base or not os.path.isdir(str(base)):
        return None
    for n in names:
        p = os.path.join(base, sub, n) if sub else os.path.join(base, n)
        if os.path.exists(p):
            return p
    return None


def _read_checkpoint(path: str, convert_fn, times: dict, name: str) -> dict[str, torch.Tensor]:
    """Read and convert one checkpoint, recording the seconds of each."""
    t0 = time.perf_counter()
    raw = load_torch_state_dict(path)
    t1 = time.perf_counter()
    sd = convert_fn(raw)
    times[name] = {"path": path, "read": t1 - t0, "convert": time.perf_counter() - t1}
    return sd


def _loaded(name: str, times: dict, device, t0: float) -> None:
    """Record the seconds since ``t0`` as ``name``'s move to ``device`` and
    report a checkpoint's load (LoRA-only merges into random weights have
    no checkpoint and are not reported)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = times.setdefault(name, {})
    t["to_device"] = time.perf_counter() - t0
    if "path" in t:
        print(f"[fresco_torch] loaded {name} weights from {t['path']} (read {t['read']:.2f} s, "
              f"convert {t['convert']:.2f} s, to {device.type} {t['to_device']:.2f} s)")


def _maybe_load_pretrained(config: FrescoConfig, mods: dict, times: dict | None = None) -> dict:
    """{model: state dict} of the local torch / diffusers checkpoints found
    (``fresco_tpu/pipeline/runner.py:_maybe_load_pretrained``): repo-id
    config values resolve to the ``scripts/fetch_weights.py`` layout
    through ``_local_ckpt_dir``; ``vae_path`` overrides ``sd_path/vae``; the
    ControlNet is ``controlnet_path`` or ``sd-controlnet-<type>``.  State
    dicts are in the checkpoint's dtypes, keyed for ``mods``' modules."""
    from fresco_torch.models import convert as C
    from fresco_torch.models.gmflow.convert import gmflow_map

    times = {} if times is None else times
    ckpt_dir = os.path.dirname(str(config.gmflow_path)) or "."
    sd_dir = _local_ckpt_dir(config.sd_path, ckpt_dir) or str(config.sd_path)
    vae_dir = _local_ckpt_dir(config.vae_path, ckpt_dir)
    cn_dir = (_local_ckpt_dir(config.controlnet_path, ckpt_dir)
              or _local_ckpt_dir(f"sd-controlnet-{config.controlnet_type}", ckpt_dir))
    diffusers = ["diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"]
    specs = [("unet", _find(sd_dir, "unet", diffusers), C.sd_key_map("unet", mods["unet"].cfg)),
             ("vae", _find(vae_dir or sd_dir, "" if vae_dir else "vae", diffusers),
              C.sd_key_map("vae", mods["vae"].cfg)),
             ("text", _find(sd_dir, "text_encoder", ["model.safetensors", "pytorch_model.bin"]),
              C.sd_key_map("text", mods["text"].cfg)),
             ("controlnet", _find(cn_dir, "", diffusers), C.sd_key_map("controlnet", mods["controlnet"].cfg))]
    if config.gmflow_path and os.path.exists(str(config.gmflow_path)):
        specs.append(("gmflow", str(config.gmflow_path), gmflow_map))
    out = {}
    for name, path, key_map in specs:
        if path:
            own = mods[name].state_dict().keys()
            out[name] = _read_checkpoint(path, lambda raw: C.convert(raw, key_map, own), times, name)
    return out


def _maybe_apply_lora(loaded: dict, mods: dict, config: FrescoConfig) -> dict:
    """Merge ``config.lora_path`` (kohya) into the UNet and text encoder
    (``fresco_tpu/pipeline/runner.py:316-336``): into their loaded state
    dicts, else into their random weights."""
    if not config.lora_path or not os.path.exists(str(config.lora_path)):
        return loaded
    from fresco_torch.models.lora import merge_lora

    lora_sd = load_torch_state_dict(str(config.lora_path))
    counts = {}
    for name, target in (("unet", "lora_unet_"), ("text", "lora_te_")):
        sd = loaded.get(name)
        if sd is None:
            sd = dict(mods[name].state_dict())
        loaded[name], counts[name] = merge_lora(sd, lora_sd, config.lora_scale, target=target)
    print(f"[fresco_torch] merged LoRA {config.lora_path} (scale={config.lora_scale}): "
          f"{counts['unet']} unet + {counts['text']} text modules")
    return loaded


def _random_module(cls, device, gen, dtype):
    with torch.device("meta"):
        m = cls()
    m = init_flax_default_(m.to_empty(device=device), gen)
    return m.to(dtype).eval().requires_grad_(False)


def _loaded_module(cls, path: str, convert_fn, device, dtype, times: dict, name: str):
    """``cls()`` on ``device`` with the weights of checkpoint ``path``, cast to ``dtype``."""
    sd = _read_checkpoint(path, convert_fn, times, name)
    t0 = time.perf_counter()
    with torch.device("meta"):
        m = cls()
    m = m.to_empty(device=device)
    load_into(m, sd)
    m = m.to(dtype).eval().requires_grad_(False)
    _loaded(name, times, device, t0)
    return m


def _build_detector(config: FrescoConfig, tiny: bool, device, gen, random_aux_weights: bool,
                    times: dict | None = None):
    """The control detector (fresco_tpu runner.py:170-227): HED, MiDaS
    depth, M-LSD or the OpenPose body model from its checkpoint beside
    ``gmflow_path`` (random weights with ``random_aux_weights``), in
    float32; else canny where ``cv2`` imports, else none."""
    from fresco_torch.models import hed, midas, mlsd, openpose

    ctype = config.controlnet_type
    ckpt_dir = os.path.dirname(str(config.gmflow_path)) or "."
    times = {} if times is None else times
    # controlnet_type -> (module, checkpoint, converter, the detector on the module, name)
    detectors = {"hed": (hed.HED, "ControlNetHED.pth", hed.convert_hed, hed.hed_detector, "HED"),
                 "depth": (midas.DPTHybridDepth, midas.CHECKPOINT, midas.convert_dpt_hybrid,
                           midas.depth_detector, "MiDaS"),
                 "mlsd": (mlsd.MLSDLarge, mlsd.CHECKPOINT, mlsd.convert_mlsd, mlsd.mlsd_detector, "MLSD"),
                 "openpose": (openpose.BodyPose, openpose.CHECKPOINT, openpose.convert_openpose,
                              openpose.openpose_detector, "OpenPose")}
    spec = detectors.get("openpose" if ctype == "pose" else ctype)
    if spec is not None and not tiny:
        cls, fname, convert_fn, detect, what = spec
        path = os.path.join(ckpt_dir, fname)
        if os.path.exists(path) or random_aux_weights:
            if cls is openpose.BodyPose and not _have_cv2():
                raise ImportError("the OpenPose detector's INTER_CUBIC resizes and drawing need OpenCV (cv2), "
                                  "which is not importable here")
            model = (_loaded_module(cls, path, convert_fn, device, torch.float32, times, what.lower())
                     if os.path.exists(path) else _random_module(cls, device, gen, torch.float32))
            return functools.partial(detect, model)
        print(f"[fresco_torch] {what} weights not found; falling back to canny")
    if _have_cv2():
        return functools.partial(_canny_detector, low=config.canny_low, high=config.canny_high)
    return _no_detector


def _build_saliency(config: FrescoConfig, device, gen, random_aux_weights: bool, times: dict | None = None):
    """The EGNet background-mask function: from ``sod_path`` where it
    exists, else random weights with ``random_aux_weights``, else None."""
    if not config.use_saliency:
        return None
    from fresco_torch.models.egnet import EGNet, convert_egnet, make_saliency_fn

    if config.sod_path and os.path.exists(str(config.sod_path)):
        eg = _loaded_module(EGNet, str(config.sod_path), convert_egnet, device, aux_dtype(config),
                            {} if times is None else times, "egnet")
    elif random_aux_weights:
        eg = _random_module(EGNet, device, gen, aux_dtype(config))
    else:
        return None
    return make_saliency_fn(eg)


def _make_mesh(config: FrescoConfig):
    """The mesh of ``config.mesh_shape`` (F23: raises without a process
    group of ``prod(mesh_shape)`` ranks)."""
    from fresco_torch.parallel.sharding import make_mesh

    shape = tuple(int(n) for n in config.mesh_shape)
    if len(shape) != 2:
        raise ValueError(f"mesh_shape {shape}: expected (data, model)")
    return make_mesh(*shape)


def _shard_bundle(bundle: ModelBundle, mesh) -> None:
    """Split the UNet, the ControlNet, the VAE, the text encoder and GMFlow
    over ``mesh.model`` (once a bundle), as the JAX runner splits its
    ``b.params``."""
    if bundle.tp_mesh is not None:
        if bundle.tp_mesh.shape != mesh.shape:
            raise ValueError(f"the bundle is split over mesh {bundle.tp_mesh.shape}, not {mesh.shape}")
        return
    if mesh.model == 1:
        return
    from fresco_torch.parallel.sharding import bundle_models, shard_model_params

    for name, mod in bundle_models(bundle).items():
        shard_model_params(mod, mesh, name)
    bundle.tp_mesh = mesh


class FrescoPipeline:
    """run_fresco-equivalent orchestration."""

    # synchronize the device at each phase boundary so phase times are
    # device times, not enqueue times (off by default)
    sync_phases = False

    def __init__(self, config: FrescoConfig, bundle: ModelBundle | None = None, *,
                 tiny: bool = False, device: torch.device | str | None = None):
        """``bundle``: the models (``build_models``; pass one built with
        ``random_aux_weights=True`` for random HED and EGNet weights), else
        a random-weight stack is built.  A ``mesh_shape`` of more than one
        rank needs this process's process group (F23)."""
        self.mesh = _make_mesh(config)
        self.bundle = bundle or build_models(config, tiny=tiny, seed=config.seed, device=device)
        _shard_bundle(self.bundle, self.mesh)
        self.device = self.bundle.device
        self.phases = PhaseTimes()
        self.set_config(config)

    def set_config(self, config: FrescoConfig) -> None:
        """Adopt ``config`` without rebuilding the models
        (``fresco_tpu/pipeline/runner.py:370-381``; the WebUI's
        ``GlobalState`` calls it where no rebuild is due).  Everything read
        per batch follows it: the sampler settings (steps, warmup, guidance
        and ControlNet scales, attention and optimization toggles), the
        prompts, the keyframe selection and batches, the file paths and the
        seed of the pipeline's generator.  What was built stays as built,
        in both packages: the models (``sd_path``, ``lora_*``,
        ``controlnet_type``, ``use_freeu`` and the FreeU factors,
        ``use_saliency``, ``dtype``, ``aux_dtype``), the canny detector's
        thresholds and the random weights drawn from the build's seed.

        The step count also follows: the sampler's scheduler is made here,
        and only here, at ``num_inference_steps``.  The JAX package keeps the
        scheduler of its build, so a changed step count makes its denoise
        scan raise (gates and per-step scales of different lengths); the port
        departs from it there on purpose.  ``mesh_shape`` is read at
        construction only, as in the JAX package."""
        self.config = config
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        b = self.bundle
        self.sampler = FrescoSampler(b.unet, b.vae, b.controlnet,
                                     DDPMScheduler(num_inference_steps=config.num_inference_steps), self.mesh)
        self._base_sampler_cfg = self.make_sampler_cfg(config)

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

    def gmflow_flow_fn(self, gm: GMFlow | None = None):
        """GMFlow (the bundle's unless ``gm`` is given) as a flow function:
        frames rounded to ``config.aux_dtype``, flows in float32 (float64 in
        the float64 mode, as ``fresco_tpu/pipeline/runner.py:424-431``)."""
        gm = self.bundle.gmflow if gm is None else gm
        if gm is None:
            raise RuntimeError("no flow source: the bundle has neither flow_fn nor gmflow")
        dt = aux_dtype(self.config)
        flow_t = frame_dtype(self.config)

        @torch.no_grad()
        def flow_fn(a, b):
            return gm(a.to(dt).float(), b.to(dt).float()).to(flow_t)

        return flow_fn

    def _interframe(self, frames_255):
        flow_fn = self.bundle.flow_fn or self.gmflow_flow_fn()
        return prepare.interframe_params(flow_fn, frames_255, photo_thresh=self.config.photo_occ_thresh,
                                         mesh=self._frame_mesh(frames_255.shape[0]))

    def _frame_mesh(self, n: int):
        """The mesh's frame axis for an ``n``-frame batch, None where it has one rank."""
        mesh = self.mesh.for_frames(n)
        return mesh if mesh.data > 1 else None

    def _intraframe(self, frames_unit, prompt_embeds, noise, enc_noise):
        if self.config.dtype == "float64":  # the sharding-validation mode (fresco_tpu runner.py:444-447)
            corr_dtype = torch.float64
        else:
            corr_dtype = torch.bfloat16 if self.config.gram_dtype == "bfloat16" else torch.float32
        b = self.bundle
        return prepare.intraframe_params(b.unet, b.vae, self.sampler.scheduler, frames_unit, prompt_embeds,
                                         noise=noise, enc_noise=enc_noise, corr_dtype=corr_dtype,
                                         mesh=self._frame_mesh(frames_unit.shape[0]))

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
        ftype = frame_dtype(cfg)
        with self._phase("upload_frames"):
            frames_u8 = torch.as_tensor(np.stack(imgs), device=dev)
        frames_255 = frames_u8.to(ftype)
        frames_unit = frames_255 / 255.0 * 2.0 - 1.0
        with self._phase("encode_prompts"):
            prompt_embeds = encode_prompts(b.text_encoder, b.tokenizer, prompts, n_prompts)
        with self._phase("control_detector"):
            edges_np = np.stack([b.detector(im) for im in imgs])
        if edges_np.ndim == 3:
            edges_np = edges_np[..., None]
        edges_u8 = torch.as_tensor(edges_np, device=dev)
        edges = (edges_u8.to(ftype) / 255.0).expand(*edges_u8.shape[:3], 3)

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
        translation.  The host work around the batches is timed as the phases
        read_video, select_keyframes, write_video_frames and write_keyframes.
        Over a mesh every rank decodes and translates, only rank 0 writes,
        and rank 0's files decide ``reuse`` for every rank (a rank that
        skipped alone would leave the others waiting in the batch's first
        gather).  Returns the key indices."""
        from fresco_torch.parallel.distributed import is_main_process, main_process_value
        from fresco_torch.propagate.video_blend import _codec

        Image = _codec()
        cfg = self.config
        writer = is_main_process()
        for sub in ("keys", "video"):
            os.makedirs(os.path.join(cfg.save_path, sub), exist_ok=True)
        with self._phase("read_video"):
            raw = read_video_rgb(cfg.file_path, int(cfg.frame_count) if cfg.frame_count else int(1e10))
        if not raw:
            raise RuntimeError(f"no frame could be decoded from {cfg.file_path!r}")
        with self._phase("select_keyframes"):
            keys = select_keyframes_from_frames(raw, cfg.mininterv, cfg.maxinterv)
        with self._phase("write_video_frames"):
            frames = [resize_image(f, cfg.resolution) for f in raw]
            del raw
            for i, f in enumerate(frames if writer else ()):
                Image.fromarray(f).save(os.path.join(cfg.save_path, "video", "%04d.png" % i))
        key_path = lambda k: os.path.join(cfg.save_path, "keys", "%04d.png" % k)  # noqa: E731
        if reuse and main_process_value(all(os.path.exists(key_path(k)) for k in keys)):
            if verbose:
                print("[fresco_torch] all keyframes present: skipping translation (resume)")
            return keys

        def save(batch: dict[int, np.ndarray]) -> None:
            with self._phase("write_keyframes"):
                for k, img in (batch.items() if writer else ()):
                    Image.fromarray(img).save(key_path(k))

        self.translate_keyframes(frames, keys, verbose=verbose, on_batch=save)
        return keys

    def whole_gmflow(self) -> GMFlow | None:
        """The bundle's GMFlow with whole parameters: itself where the mesh
        does not split it, else a copy put together from the model ranks'
        parts (``sharding.whole_state_dict``) and kept in the bundle.  The
        first call on a split bundle is a collective: every rank makes it
        together, before a rank goes on alone (``cli.run_config`` does)."""
        from fresco_torch.parallel.sharding import is_split, whole_state_dict

        b = self.bundle
        if b.gmflow is None or not is_split(b.gmflow):
            return b.gmflow
        if b.gmflow_whole is not None:
            return b.gmflow_whole
        sd = whole_state_dict(b.gmflow)
        with torch.device("meta"):
            gm = GMFlow(b.gmflow.cfg)
        gm = gm.to_empty(device=self.device)
        gm.load_state_dict(sd)
        b.gmflow_whole = gm.eval().requires_grad_(False)
        return b.gmflow_whole

    def _alone_gmflow_fn(self):
        """The flow function of a GMFlow that this rank can run alone."""
        from fresco_torch.parallel.sharding import is_split

        b = self.bundle
        if b.gmflow is None or not is_split(b.gmflow):
            return self.gmflow_flow_fn()
        if b.gmflow_whole is None:
            raise RuntimeError("GMFlow is split over the mesh's model axis, so one rank cannot run it alone: call "
                               "FrescoPipeline.whole_gmflow() on every rank first (cli.run_config does)")
        return self.gmflow_flow_fn(b.gmflow_whole)

    def consistency_flow_fn(self):
        """The flow source of the metrics and the CLI's propagation, in the
        JAX package's order (fresco_tpu/cli.py:50-60,
        fresco_tpu/pipeline/runner.py:621-634): the bundle's GMFlow when a
        checkpoint exists at ``config.gmflow_path``, else OpenCV's
        Farneback.  With neither (the card's machine has no OpenCV), the
        bundle's GMFlow all the same, whose random weights give flows that
        mean little; a line says so.  Rank 0 calls it alone: over a mesh that
        splits GMFlow, its GMFlow is the whole copy of ``whole_gmflow`` (it
        raises where none was made)."""
        gpath = str(self.config.gmflow_path or "")
        if gpath and os.path.exists(gpath):
            return self._alone_gmflow_fn()
        if _have_cv2():
            from fresco_torch.utils.classic_flow import pairwise_flow_fn

            return pairwise_flow_fn()
        print(f"[fresco_torch] no GMFlow checkpoint at {gpath!r} and no OpenCV for Farneback: "
              "flows from the bundle's GMFlow, whose weights are random")
        return self._alone_gmflow_fn()

    def evaluate_consistency(self, frame_dir: str, max_frames: int = 32) -> dict:
        """Warp error and frame similarity of a frame directory (a centred
        window of ``max_frames`` consecutive frames).  The similarity is
        CLIP's where ``clip_vision.safetensors``, ``clip_vision.bin`` or
        ``clip_model.safetensors`` sits beside ``gmflow_path``, as in the
        JAX package."""
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
        ckpt_dir = os.path.dirname(str(self.config.gmflow_path)) or "."
        clip_enc = None
        for name in ("clip_vision.safetensors", "clip_vision.bin", "clip_model.safetensors"):
            clip_enc = metrics.make_clip_image_encoder(os.path.join(ckpt_dir, name), self.device)
            if clip_enc:
                break
        return metrics.evaluate_translation(frames, self.consistency_flow_fn(), self.device, clip_encoder=clip_enc)
