"""F22: ``FrescoConfig(dtype="float64")`` computes in float64 in the port, as
in the JAX package (``fresco_tpu/pipeline/runner.py:84-90``), and the tiny
keyframe batch matches the JAX package's under ``jax.enable_x64(True)``.

The batch of ``tests/test_torch_slice.py`` (64 px, 4 keyframes, tiny
widths, fixed flows, the feature optimization on) through both packages'
``_prepare_batch`` -> ``_run_batch`` with the same weights (float32 values
held in float64 models; norms keep float32 parameters in both), JAX's own
float64 noise, re-drawn here, and two float32 inputs of JAX's handed to
the port: the prompt embeddings (the text encoder runs in float32 in every
mode, in both packages, and the two differ by ~1e-6) and the schedule's
``alphas_cumprod`` table (XLA's float32 cumprod and numpy's differ by
ulps, which six steps grow to ~1e-5 in the latents).  The JAX side runs
inside the ``jax.enable_x64`` context, never flipping the global flag.

Tolerances.  Latents (|x| up to ~12) and the record to 1e-5 absolute.
The port computes the whole path in float64; the JAX package's float64
mode keeps two float32 pieces: its spatial-loss gradient accumulates the
gram and its apply with ``preferred_element_type=float32`` into a float32
buffer (``fresco_tpu/diffusion/guidance.py:394-405``), and its dense
reference gram likewise (``:545-550``).  Those bound the agreement
(measured: 5.0e-7 with torch 2.13 on the CPU at 1, 6 and 8 threads).  The
port's float32 batch, on the same inputs, lies farther from the JAX float64
batch than ``ATOL`` and than 10x the float64 batch's own distance
(measured: 3.47e-5 at 1 thread, 2.86e-5 at 6, 5.56e-5 at 8; how far depends
on the build's float32 summation order, since a float32 run may or may not
flip a sign of the feature optimization's L1 losses): the float64 mode is
what agrees.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from fresco_torch.diffusion.scheduler import DDPMScheduler
from fresco_torch.models.layers import cast_model
from fresco_torch.pipeline import runner as trunner
from fresco_tpu.diffusion.scheduler import DDPMScheduler as JSched
from fresco_tpu.models import clip_text as jclip
from fresco_tpu.models import controlnet as jcn
from fresco_tpu.models import unet as junet
from fresco_tpu.models import vae as jvae
from fresco_tpu.pipeline import runner as jrunner
from fresco_tpu.pipeline.text import HashTokenizer
from test_torch_models import TINY_COND, jax_tiny_models, torch_tiny_models
from test_torch_slice import F, RES, _config, _edges, _inputs

ATOL = 1e-5


def _jax_noise64(seed: int, n_steps: int, warmup: int):
    """The JAX float64 pipeline's own draws (prepare.py:107,113, vae.py:174,
    sampler.py:122,133,268-275), in float64."""
    rng = jax.random.key(seed)
    lshape = (F, RES // 8, RES // 8, 4)
    rng_noise, rng_enc = jax.random.split(rng)
    rng_init, rng_enc2, rng_steps = jax.random.split(rng, 3)
    arr = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    f64 = jnp.float64
    return dict(
        intra_noise=arr(jax.random.normal(rng_noise, lshape, f64)),
        intra_enc_noise=arr(jax.random.normal(rng_enc, lshape, f64)),
        init_noise=arr(jnp.tile(jax.random.normal(rng_init, (1, *lshape[1:]), f64), (F, 1, 1, 1))),
        enc_noise=arr(jax.random.normal(rng_enc2, lshape, f64)),
        step_noise=torch.stack([arr(jax.random.normal(jax.random.fold_in(rng_steps, i), lshape, f64))
                                for i in range(warmup, n_steps)]),
    )


def test_float64_batch_matches_jax_x64(monkeypatch):
    _, params = jax_tiny_models(seed=7)
    imgs, flows = _inputs()
    prompts, negs = ["a cat"] * F, ["blurry"] * F
    jcfg, tcfg = _config(dtype="float64", aux_dtype="float32")
    with jax.enable_x64(True):
        ucfg, vcfg, ccfg = junet.UNetConfig.tiny(), jvae.VAEConfig.tiny(), jclip.CLIPTextConfig.tiny()
        f64 = jnp.float64
        jbundle = jrunner.ModelBundle(
            junet.UNet2DCondition(ucfg, dtype=f64), jvae.AutoencoderKL(vcfg, dtype=f64),
            jcn.ControlNet(ucfg, dtype=f64, cond_embed_channels=TINY_COND),
            jclip.CLIPTextEncoder(ccfg, dtype=jnp.float32), None, JSched(num_inference_steps=jcfg.num_inference_steps),
            params, HashTokenizer(1000), _edges, None, flow_fn=lambda a, b: jnp.asarray(flows, f64))
        jpipe = jrunner.FrescoPipeline(jcfg, jbundle)
        rng = jax.random.key(jcfg.seed)
        prepared = jpipe._prepare_batch(imgs, prompts, negs, rng)
        jlat, jrec = jpipe._run_batch(prepared, None, False, rng)
        assert jlat.dtype == jnp.float64
        embeds = torch.from_numpy(np.array(prepared["prompt_embeds"]))
        alphas = np.array(jbundle.scheduler.alphas_cumprod)
        jlat, jrec = np.asarray(jlat), np.asarray(jrec)
        noise = _jax_noise64(tcfg.seed, tcfg.num_inference_steps, tcfg.num_warmup_steps)

    out = {}
    # both packages' text encoders run in float32 in every mode and differ by
    # ~1e-6 (summation order); the port is handed the JAX embeddings
    monkeypatch.setattr(trunner, "encode_prompts", lambda *a: embeds)
    # the schedule's float32 table: XLA's cumprod and numpy's differ by ulps
    monkeypatch.setattr(DDPMScheduler, "alphas_cumprod", property(lambda self: alphas))
    for dtype in ("float64", "float32"):
        tm = torch_tiny_models(params)
        dt = trunner.model_dtype(tcfg.replace(dtype=dtype))
        for name in ("unet", "vae", "controlnet"):
            cast_model(tm[name], dt)
        ft = torch.float64 if dtype == "float64" else torch.float32
        tbundle = trunner.ModelBundle(
            tm["unet"], tm["vae"], tm["controlnet"], tm["text"], HashTokenizer(1000), _edges, torch.device("cpu"),
            flow_fn=lambda a, b, ft=ft: torch.from_numpy(flows).to(ft))
        tpipe = trunner.FrescoPipeline(tcfg.replace(dtype=dtype), tbundle)
        out[dtype] = tpipe._translate_batch(imgs, prompts, negs, None, False,
                                            {k: v.to(ft) for k, v in noise.items()})
    tlat, trec = out["float64"]
    assert tlat.dtype == torch.float64 and trec.dtype == torch.float64
    assert trunner.model_dtype(tcfg) == torch.float64
    np.testing.assert_allclose(tlat.numpy(), jlat, atol=ATOL, rtol=0)
    np.testing.assert_allclose(trec.numpy(), jrec, atol=ATOL, rtol=0)
    assert out["float32"][0].dtype == torch.float32
    d64 = np.abs(tlat.numpy() - jlat).max()
    d32 = np.abs(out["float32"][0].double().numpy() - jlat).max()
    assert d32 > ATOL and d32 > 10 * d64, (d32, d64)
