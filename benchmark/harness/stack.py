"""The model stack of a configuration, built for the program or for the
reference from the same seeded weights.

``build(side, spec, seed, device)`` makes the configuration's UNet,
ControlNet, VAE, CLIP text encoder, GMFlow, control detector and EGNet at
the widths the configuration file gives, on ``device``, fills them from
``weights.fill_`` (the plan taken from the reference's modules, so both
sides get the same values by name) and casts them as that side's model
code does: the UNet, ControlNet and VAE in the configuration's dtype with
float32 norms, the text encoder, the detector and GMFlow's forward in
float32 (GMFlow's weights rounded to ``aux_dtype`` first), EGNet in
``aux_dtype``.  ``side`` is ``"program"`` (the port, ``fresco_torch``) or
``"reference"`` (the frozen copy under ``benchmark/reference``).
"""
from __future__ import annotations

import functools
import importlib

import torch

from benchmark.harness import weights

_DETECTORS = {  # controlnet_type -> (module path, class, detector function)
    "hed": ("models.hed", "HED", "hed_detector"),
    "depth": ("models.midas", "DPTHybridDepth", "depth_detector"),
}
PACKAGES = {"program": "fresco_torch", "reference": "benchmark.reference.fresco_ref"}


def _mod(side: str, path: str):
    return importlib.import_module(f"{PACKAGES[side]}.{path}")


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def fresco_config(side: str, spec: dict, **overrides):
    """The side's ``FrescoConfig`` of the configuration file's ``fresco`` block."""
    cls = _mod(side, "core.config").FrescoConfig
    return cls(**_tuples({**spec["fresco"], **overrides}))


def _meta_modules(side: str, spec: dict) -> dict[str, torch.nn.Module]:
    """Every model of the stack on the meta device."""
    w = spec["widths"]
    ucfg_cls = _mod(side, "models.unet").UNetConfig
    unet_cfg = ucfg_cls(**_tuples(w["unet"]))
    ctype = spec["fresco"]["controlnet_type"]
    dpath, dcls, _ = _DETECTORS[ctype]
    with torch.device("meta"):
        mods = {
            "unet": _mod(side, "models.unet").UNet2DCondition(unet_cfg),
            "controlnet": _mod(side, "models.controlnet").ControlNet(
                unet_cfg, tuple(w["controlnet"]["conditioning_embedding_out_channels"])),
            "vae": _mod(side, "models.vae").AutoencoderKL(_mod(side, "models.vae").VAEConfig(**_tuples(w["vae"]))),
            "text": _mod(side, "models.clip_text").CLIPTextEncoder(
                _mod(side, "models.clip_text").CLIPTextConfig(**_tuples(w["text_encoder"]))),
            "gmflow": _mod(side, "models.gmflow").GMFlow(_mod(side, "models.gmflow").GMFlowConfig(**_tuples(w["gmflow"]))),
            "detector": getattr(_mod(side, dpath), dcls)(),
        }
        if spec["fresco"].get("use_saliency", True):
            mods["egnet"] = _mod(side, "models.egnet").EGNet()
    return mods


def plans(spec: dict) -> dict:
    """Each model's weight plan, from the reference's modules."""
    return {name: weights.weight_plan(m) for name, m in _meta_modules("reference", spec).items()}


def build(side: str, spec: dict, seed: int, device, config=None):
    """(config, ModelBundle) of ``side`` with the seeded weights on ``device``."""
    config = config or fresco_config(side, spec)
    runner = _mod(side, "pipeline.runner")
    layers = _mod(side, "models.layers")
    text_mod = _mod(side, "pipeline.text")
    plan = plans(spec)
    mods = {n: weights.materialize(m, plan[n], seed, n, device) for n, m in _meta_modules(side, spec).items()}
    dt = runner.model_dtype(config)
    frozen = lambda m: m.eval().requires_grad_(False)  # noqa: E731
    unet, vae, controlnet = (frozen(layers.cast_model(mods[n], dt)) for n in ("unet", "vae", "controlnet"))
    text = frozen(mods["text"])
    gmflow = frozen(mods["gmflow"].to(runner.aux_dtype(config)).float())
    dpath, _, dfn = _DETECTORS[config.controlnet_type]
    detector = functools.partial(getattr(_mod(side, dpath), dfn), frozen(mods["detector"]))
    saliency_fn = None
    if "egnet" in mods:
        saliency_fn = _mod(side, "models.egnet").make_saliency_fn(frozen(mods["egnet"].to(runner.aux_dtype(config))))
    tokenizer = text_mod.HashTokenizer(spec["widths"]["text_encoder"]["vocab_size"])
    bundle = runner.ModelBundle(unet, vae, controlnet, text, tokenizer, detector, torch.device(device),
                                gmflow=gmflow, saliency_fn=saliency_fn)
    return config, bundle

