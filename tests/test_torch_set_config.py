"""``FrescoPipeline.set_config`` (the WebUI's hot swap) on the CPU.

For every ``FrescoConfig`` field that ``ui_to_config`` can set and that
``GlobalState`` does not rebuild for, two pipelines are held against each
other: one built with config A and then given B by ``set_config``, and one
built fresh with B.  Both draw their noise from the config's seed, so the
same seed gives the same noise; their keyframes must be equal bit for bit.
The batches run through ``translate_keyframes`` on 11 frames of
data/music.mp4 at 64 px (two keyframe batches), tiny models, 4 steps, and
through ``_translate_batch`` with the pipeline's own generator.  The fresh
pipeline's random weights are drawn with A's seed, as the set_config'd
pipeline's were: the weights are a product of the build, in both packages.

Fields read only where the video file is read (file_path, save_path,
frame_count, resolution) are held on ``translate_keyframe_files`` with the
translation itself stubbed out: the same frames, keyframes and files.

The FreeU factors and the canny thresholds are built into the models and
the detector, in the JAX package as here (``fresco_tpu/pipeline/runner.py:99,226``),
and ``GlobalState`` rebuilds for neither (ROADMAP F20): after
``set_config`` the pipeline keeps A's, so its batch equals a fresh A's and
differs from a fresh B's.  The tiny UNet has no FreeU of its own, so the
bundle here carries the config's factors as the full-width build does,
and its ControlNet's zero-initialized outputs get seeded weights.
The step count follows ``set_config`` in the port; in the JAX package it
does not (its scan raises), a deliberate departure (ROADMAP F21).

Held against the JAX package: a tiny fresco_tpu pipeline and the port's,
built from the same weights (``from_jax_params``) with the base config
``J``, are given ``J.replace(field=value)`` by their own ``set_config``.
- The batch fields (every FOLLOW field but the step count and those the
  keyframe stage reads, and the six BUILT fields) run one
  ``_translate_batch`` on the same frames, flows and noise, as
  ``tests/test_torch_slice.py`` does: the latents agree to 3e-4 absolute
  without the feature optimization and to 2e-2 relative Frobenius error
  with it (that file's bounds and reasons).  A FOLLOW field must move the
  JAX batch from the base config's by more than ten times that bound.  A
  BUILT field must leave the JAX batch bit-equal to the base config's,
  and a port pipeline built fresh with the field's value (what following
  it would give) must lie more than ten times the bound away from it.
- The keyframe-stage fields (seed, prompts, batch size, intervals) and the
  file fields run the whole file-level keyframe stage of both packages on
  data/music.mp4 with the batches' model work stubbed out: both must make
  the same batches from the same frames (bit for bit), with the same
  prompts, anchors, random key (the port's generator seed through
  ``jax.random.key``) and files, and the field must change the JAX
  package's batches or files.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch import webui
from fresco_torch.core.config import FrescoConfig
from fresco_torch.ops.image import resize_image
from fresco_torch.pipeline import runner
from fresco_torch.pipeline.text import HashTokenizer
from fresco_torch.utils import clips
from fresco_tpu.core.config import FrescoConfig as JConfig
from fresco_tpu.diffusion.scheduler import DDPMScheduler as JSched
from fresco_tpu.models import unet as junet
from fresco_tpu.pipeline import runner as jrunner
from test_torch_models import jax_tiny_models, torch_tiny_models
from test_torch_slice import _inputs, _jax_noise

A = FrescoConfig(
    resolution=64, num_inference_steps=4, num_warmup_steps=1, end_opt_step=3, opt_iters=1,
    dtype="float32", gram_dtype="float32", batch_size=4, mininterv=2, maxinterv=2,
    controlnet_type="canny", use_saliency=False, use_freeu=True, prompt="a woman",
    gmflow_path="missing/gmflow.pth", sod_path="missing/egnet.pth")

#: the fields the batch reads at run time, each with its value in B
FOLLOW = {
    "seed": 3, "prompt": "a cat", "a_prompt": ", oil painting", "n_prompt": "blurry",
    "cond_scale": 0.3, "guidance_scale": 3.0, "num_inference_steps": 6, "num_warmup_steps": 2,
    "batch_size": 8, "mininterv": 1, "maxinterv": 3, "use_controlnet": False,
    "use_fresco_attn": False, "use_cfattn": False, "num_intraattn_steps": 0,
    "step_interattn_end": 1001, "use_fresco_opt": False,
}
#: read where the video file is read (``translate_keyframe_files``)
FILE_LEVEL = {"file_path": clips.bundled_clip("dog.mp4"), "save_path": "other", "frame_count": 7,
              "resolution": 128}
#: built into the models or the detector; no rebuild for them (F20)
BUILT = {"canny_low": 150, "canny_high": 300, "freeu_b1": 1.5, "freeu_b2": 1.0, "freeu_s1": 0.3,
         "freeu_s2": 0.4}
#: read by the WebUI's process2 from its own argument, not by the pipeline
PROPAGATION = {"use_poisson", "max_process"}
#: GlobalState rebuilds the pipeline for these
REBUILD = {"sd_path", "controlnet_type", "lora_path", "lora_scale", "use_freeu", "use_saliency"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny models are many small ops: one intra-op thread runs them as fast
    as eight, and does not fight the suite's other worker processes for
    the cores (eight threads a worker slowed this file many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    got = clips.read_frames(clips.bundled_clip("music.mp4"), 11)
    assert got is not None and len(got) == 11
    return [resize_image(f, A.resolution) for f in got]


def _pipeline(cfg: FrescoConfig) -> runner.FrescoPipeline:
    """A pipeline built with ``cfg``; weights drawn with A's seed, FreeU
    from the config as the full-width build takes it.  The ControlNet's
    zero-initialized output convolutions get seeded weights, as trained
    ones have, so that the control map reaches the UNet."""
    bundle = runner.build_models(cfg, tiny=True, seed=A.seed, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in bundle.controlnet.parameters():
            if p.ndim > 1 and not p.any():
                p.normal_(0.0, 0.1, generator=gen)
    u = bundle.unet
    u.cfg = dataclasses.replace(u.cfg, use_freeu=cfg.use_freeu, freeu_b1=cfg.freeu_b1, freeu_b2=cfg.freeu_b2,
                                freeu_s1=cfg.freeu_s1, freeu_s2=cfg.freeu_s2)
    return runner.FrescoPipeline(cfg, bundle)


def _batch(pipe, frames):
    keys = pipe.translate_keyframes(frames)
    batches = pipe.keyframe_batches(frames)
    _, imgs, prompts, negs = batches[0]
    latents, _ = pipe._translate_batch(imgs, prompts, negs, None, False)
    return keys, latents


def _equal(a, b) -> bool:
    (ka, la), (kb, lb) = a, b
    return sorted(ka) == sorted(kb) and all(np.array_equal(ka[k], kb[k]) for k in ka) and torch.equal(la, lb)


def _swapped(b_cfg, frames):
    pipe = _pipeline(A)
    _batch(pipe, frames)  # A's batch first, so that nothing of B is left from a fresh start
    bundle = pipe.bundle
    pipe.set_config(b_cfg)
    assert pipe.bundle is bundle and pipe.config is b_cfg
    return _batch(pipe, frames)


def _b(field, value):
    kw = {field: value}
    if field == "mininterv":
        kw["maxinterv"] = 3  # selection by motion, not by a fixed stride
    return A.replace(**kw)


@pytest.mark.parametrize("field", sorted(FOLLOW))
def test_field_follows_set_config(field, frames):
    b_cfg = _b(field, FOLLOW[field])
    got = _swapped(b_cfg, frames)
    assert _equal(got, _batch(_pipeline(b_cfg), frames)), field
    assert not _equal(got, _batch(_pipeline(A), frames)), f"{field} changes nothing here: no test"


@pytest.mark.parametrize("field", sorted(BUILT))
def test_built_field_keeps_the_build(field, frames):
    """The JAX package's behaviour (F20), mirrored: the batch after
    set_config is A's, where a fresh B gives another."""
    b_cfg = _b(field, BUILT[field])
    got = _swapped(b_cfg, frames)
    assert _equal(got, _batch(_pipeline(A), frames)), field
    assert not _equal(got, _batch(_pipeline(b_cfg), frames)), f"{field} changes nothing here: no test"


@pytest.mark.parametrize("field", sorted(FILE_LEVEL))
def test_file_field_follows_set_config(field, tmp_path, monkeypatch):
    def run(pipe, cfg):
        pipe.set_config(cfg.replace(save_path=str(tmp_path / cfg.save_path) + "/",
                                    file_path=cfg.file_path or clips.bundled_clip("music.mp4"),
                                    frame_count=cfg.frame_count or 9))
        seen = {}

        def translate(frames, keys, verbose=False, on_batch=None):
            seen.update(frames=frames, keys=list(keys))
            on_batch({k: frames[k] for k in keys})

        monkeypatch.setattr(pipe, "translate_keyframes", translate)
        keys = pipe.translate_keyframe_files(verbose=False)
        return keys, seen, pipe.config.save_path

    a_cfg = A.replace(save_path="a")
    b_cfg = a_cfg.replace(**{field: FILE_LEVEL[field]})
    swapped = _pipeline(a_cfg)
    run(swapped, a_cfg)
    keys, seen, out = run(swapped, b_cfg)
    keys_f, seen_f, out_f = run(_pipeline(b_cfg), b_cfg)
    assert keys == keys_f == seen["keys"] and out == out_f
    assert len(seen["frames"]) == len(seen_f["frames"])
    assert all(np.array_equal(x, y) for x, y in zip(seen["frames"], seen_f["frames"]))
    assert seen["frames"][0].shape[0] == b_cfg.resolution or field != "resolution"


def test_every_ui_field_is_classified(monkeypatch):
    """Every field ui_to_config sets is in exactly one of the lists above,
    so a new WebUI control cannot escape this file."""
    seen = set()

    class Recorder(FrescoConfig):
        def __init__(self, **kw):
            seen.update(kw)
            super().__init__(**kw)

    monkeypatch.setattr(webui, "FrescoConfig", Recorder)
    webui.ui_to_config("v.mp4", "p", "sd", 0, 512, 0.7, "hed", 0.75, 20, 8, 5, 20,
                       True, True, True, True, True, True, False, "./out/",
                       freeu_b1=1.0, freeu_b2=1.0, freeu_s1=1.0, freeu_s2=1.0)
    groups = [set(FOLLOW), set(FILE_LEVEL), set(BUILT), PROPAGATION, REBUILD]
    assert sum(len(g) for g in groups) == len(set().union(*groups))
    assert seen == set().union(*groups)


def test_set_config_keeps_the_models_and_rebuilds_the_scheduler(frames):
    """The models stay; the sampler's scheduler, which only set_config makes,
    takes the new step count."""
    pipe = _pipeline(A)
    models = (pipe.bundle, pipe.sampler.unet, pipe.sampler.vae, pipe.sampler.controlnet)
    assert pipe.sampler.scheduler.num_inference_steps == 4
    pipe.set_config(A.replace(num_inference_steps=7))
    assert all(a is b for a, b in zip((pipe.bundle, pipe.sampler.unet, pipe.sampler.vae, pipe.sampler.controlnet),
                                      models))
    assert pipe.sampler.scheduler.num_inference_steps == 7


# ------------------------------------------------------------------ held against the JAX package
J = dict(resolution=64, batch_size=4, num_inference_steps=5, num_warmup_steps=1, end_opt_step=4,
         opt_iters=2, dtype="float32", gram_dtype="float32", use_saliency=False, use_fresco_opt=False,
         use_freeu=True, controlnet_type="canny", prompt="a woman", seed=1, frame_count=11,
         mininterv=2, maxinterv=2, gmflow_path="missing/gmflow.pth")
#: read by the keyframe stage around the batches, not by a batch
STAGE = {"seed", "prompt", "a_prompt", "n_prompt", "batch_size", "mininterv", "maxinterv"}
#: the step count departs on purpose (F21)
BATCH = sorted(set(FOLLOW) - STAGE - {"num_inference_steps"})
ABS_TOL, REL_TOL = 3e-4, 2e-2


def _j_value(field):
    """B's value: FOLLOW's, but the feature optimization is off in J, so B turns it on."""
    return True if field == "use_fresco_opt" else FOLLOW[field]


def _freeu(cfg) -> dict:
    return dict(use_freeu=cfg.use_freeu, freeu_b1=cfg.freeu_b1, freeu_b2=cfg.freeu_b2,
                freeu_s1=cfg.freeu_s1, freeu_s2=cfg.freeu_s2)


def _jax_pipeline(cfg, jm, params, flows):
    """fresco_tpu's pipeline on the tiny models: FreeU and the detector from
    ``cfg`` as its full-width build bakes them (runner.py:99,226)."""
    unet = junet.UNet2DCondition(dataclasses.replace(jm["unet"].cfg, **_freeu(cfg)), dtype=jnp.float32)
    bundle = jrunner.ModelBundle(
        unet, jm["vae"], jm["controlnet"], jm["text"], None, JSched(num_inference_steps=cfg.num_inference_steps),
        params, HashTokenizer(1000), jrunner._build_detector(cfg, tiny=True), None,
        flow_fn=lambda a, b: jnp.asarray(flows))
    return jrunner.FrescoPipeline(cfg, bundle)


def _torch_pipeline(cfg, params, flows):
    """The port's pipeline on the same weights, FreeU and detector from ``cfg``."""
    tm = torch_tiny_models(params)
    tm["unet"].cfg = dataclasses.replace(tm["unet"].cfg, **_freeu(cfg))
    cpu = torch.device("cpu")
    bundle = runner.ModelBundle(tm["unet"], tm["vae"], tm["controlnet"], tm["text"], HashTokenizer(1000),
                                runner._build_detector(cfg, True, cpu, None, False), cpu,
                                flow_fn=lambda a, b: torch.from_numpy(flows))
    return runner.FrescoPipeline(cfg, bundle)


class Held:
    """A JAX pipeline and the port's, both built with J, and J's JAX batch."""

    def __init__(self):
        self.jm, self.params = jax_tiny_models(seed=7)
        self.imgs, self.flows = _inputs()
        self.prompts, self.negs = ["a cat"] * len(self.imgs), ["blurry"] * len(self.imgs)
        self.jbase, self.tbase = JConfig(**J), FrescoConfig(**J)
        self.jpipe = _jax_pipeline(self.jbase, self.jm, self.params, self.flows)
        self.tpipe = _torch_pipeline(self.tbase, self.params, self.flows)
        self.base_out = self.jax(self.jbase)

    def jax(self, cfg) -> np.ndarray:
        self.jpipe.set_config(cfg)
        try:
            lat, _ = self.jpipe._translate_batch(self.imgs, self.prompts, self.negs, None, False,
                                                 jax.random.key(cfg.seed))
        finally:
            self.jpipe.set_config(self.jbase)
        return np.asarray(lat)

    def torch(self, cfg, pipe=None) -> np.ndarray:
        pipe = pipe or self.tpipe
        pipe.set_config(cfg)
        noise = _jax_noise(cfg.seed, cfg.num_inference_steps, cfg.num_warmup_steps)
        try:
            lat, _ = pipe._translate_batch(self.imgs, self.prompts, self.negs, None, False, noise)
        finally:
            pipe.set_config(self.tbase)
        return lat.numpy()


@pytest.fixture(scope="module")
def held():
    return Held()


def _err(got, want, opt: bool) -> float:
    """The distance the bounds read: relative Frobenius with the feature
    optimization, else max absolute."""
    if opt:
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("field", BATCH)
def test_batch_field_follows_set_config_as_in_jax(field, held):
    value = _j_value(field)
    jb, tb = held.jbase.replace(**{field: value}), held.tbase.replace(**{field: value})
    want, got = held.jax(jb), held.torch(tb)
    tol = REL_TOL if tb.use_fresco_opt else ABS_TOL
    assert np.isfinite(got).all()
    assert _err(got, want, tb.use_fresco_opt) <= tol, field
    assert _err(want, held.base_out, tb.use_fresco_opt) > 2 * tol, f"{field} moves the JAX batch too little"


@pytest.mark.parametrize("field", sorted(BUILT))
def test_built_field_keeps_the_build_as_in_jax(field, held):
    """F20 in both packages: after set_config the JAX batch is J's own, the
    port's agrees with it, and a build with the new value gives another."""
    jb, tb = held.jbase.replace(**{field: BUILT[field]}), held.tbase.replace(**{field: BUILT[field]})
    want, got = held.jax(jb), held.torch(tb)
    assert np.array_equal(want, held.base_out), field
    assert _err(got, want, False) <= ABS_TOL, field
    fresh = held.torch(tb, _torch_pipeline(tb, held.params, held.flows))
    assert _err(fresh, want, False) > 2 * ABS_TOL, f"{field} changes nothing here: no test"


def _stage_run(pipe, cfg, root, jax_side: bool) -> tuple:
    """The file-level keyframe stage of ``pipe`` after ``set_config(cfg)``,
    with each batch's model work stubbed out: (keys, one (frames, prompts,
    negative prompts, anchors, random key) per batch, the files written)."""
    cfg = cfg.replace(save_path=str(root / cfg.save_path) + "/")
    pipe.set_config(cfg)
    batches, flags = [], []

    def record(imgs, prompts, negs, key):
        batches.append((np.stack(imgs), list(prompts), list(negs), np.asarray(jax.random.key_data(key)).tolist()))
        return len(imgs)

    if jax_side:
        pipe._prepare_batch = lambda imgs, p, n, rng: record(imgs, p, n, rng)
        pipe._run_batch = lambda n, rec, prop, rng: (flags.append(prop), (jnp.zeros((n, 8, 8, 4)), None))[1]
        pipe._decode_jit = lambda params, lat: jnp.zeros((lat.shape[0], 8, 8, 3))
        keys = pipe.translate_keyframes(verbose=False)
    else:
        pipe._prepare_batch = lambda imgs, p, n, nz, generator: record(
            imgs, p, n, jax.random.key(generator.initial_seed()))
        pipe._run_batch = lambda n, rec, prop, nz, generator: (flags.append(prop), (torch.zeros(n, 8, 8, 4), None))[1]
        pipe.decode = lambda lat: np.zeros((lat.shape[0], 8, 8, 3), np.uint8)
        keys = pipe.translate_keyframe_files(verbose=False)
    files = sorted(str(f.relative_to(root)) for f in root.rglob("*.png"))
    return list(keys), batches, flags, files


def _same_stage(a, b) -> bool:
    (ka, ba, fa, wa), (kb, bb, fb, wb) = a, b
    return (ka == kb and fa == fb and wa == wb and len(ba) == len(bb)
            and all(np.array_equal(x[0], y[0]) and x[1:] == y[1:] for x, y in zip(ba, bb)))


@pytest.mark.parametrize("field", sorted(STAGE | set(FILE_LEVEL)))
def test_stage_field_follows_set_config_as_in_jax(field, held, tmp_path):
    value = FILE_LEVEL.get(field, FOLLOW.get(field))
    kw = {field: value, **({"maxinterv": 3} if field == "mininterv" else {})}
    jpipe = _jax_pipeline(held.jbase, held.jm, held.params, held.flows)
    tpipe = _torch_pipeline(held.tbase, held.params, held.flows)
    cfgs = {}
    for side, pipe, base in (("jax", jpipe, held.jbase), ("torch", tpipe, held.tbase)):
        base = base.replace(save_path="a", file_path=clips.bundled_clip("music.mp4"))
        root = tmp_path / side
        cfgs[side] = (_stage_run(pipe, base, root / "first", side == "jax"),
                      _stage_run(pipe, base.replace(**kw), root / "second", side == "jax"))
    (j_a, j_b), (t_a, t_b) = cfgs["jax"], cfgs["torch"]
    assert _same_stage(t_a, j_a)
    assert _same_stage(t_b, j_b), field
    assert not _same_stage(j_b, j_a), f"{field} changes nothing in the JAX stage: no test"
