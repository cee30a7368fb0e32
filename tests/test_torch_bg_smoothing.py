"""Background smoothing, the port against fresco_tpu on the CPU.

``warp_and_fuse`` at chunk 1 (decoded images) and chunk 2 (CFG-doubled
decoder features) on the same flows, occlusions and background mask:
float32, 1e-5 absolute on values of O(1) (measured 0: the same bilinear
gathers and lerps in the same order, a serial chain of at most 4 links).

A tiny batch (64 px, 4 frames, float32) with a background mask, the
feature optimization (which fuses the optimized features) and the
decoded-image smoothing at steps 5 and 6 of 2..7, in VAE groups of 2:
JAX's noise is re-drawn by the test (the slice test's sequence plus
fold_in(fold_in(rng_steps, 7919), step) split per group) and handed to
the port.  Held to 1e-3 relative Frobenius error on the latents and
decoded images (measured 2.0e-6 and 3.3e-6; sign() in the feature
optimization can amplify rounding, as in the full slice test, but two
optimized steps here leave it small).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.ops.blend import warp_and_fuse as t_fuse
from fresco_tpu.ops.blend import warp_and_fuse as j_fuse
from test_torch_slice import F, RES, _config, _edges, _inputs, _jax_noise


@pytest.fixture(scope="module")
def weights():
    from test_torch_models import jax_tiny_models

    return jax_tiny_models(seed=7)


def _mask(f, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = ((xx - w * 0.4) ** 2 + (yy - h * 0.5) ** 2 > (0.25 * min(h, w)) ** 2).astype(np.float32)
    return np.clip(m[None, ..., None] + rng.uniform(-0.2, 0.2, (f, h, w, 1)), 0, 1).astype(np.float32)


def test_warp_and_fuse_matches_jax():
    _, flows = _inputs()
    rng = np.random.default_rng(1)
    fwd, bwd = flows[:F], flows[F:]
    occ = np.zeros((2, F, RES, RES), np.float32)
    occ[:, :, 40:52, 8:30] = 1.0  # one occluded block per frame
    sal = _mask(F, RES // 2, RES // 2)
    j_fuse_jit = jax.jit(j_fuse, static_argnames="chunk")
    for chunk, hw, c in ((1, RES, 3), (2, RES // 8, 6), (2, RES // 16, 5)):
        x = rng.standard_normal((chunk * F, hw, hw, c)).astype(np.float32)
        ref = j_fuse_jit(jnp.asarray(x), jnp.asarray(fwd), jnp.asarray(bwd), jnp.asarray(occ[0]),
                         jnp.asarray(occ[1]), jnp.asarray(sal), chunk=chunk)
        out = t_fuse(*(torch.from_numpy(a) for a in (x, fwd, bwd, occ[0], occ[1], sal)), chunk=chunk)
        assert out.shape == x.shape and out.dtype == torch.float32
        assert np.abs(out.numpy() - x).max() > 0.1  # something was fused
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _bg_noise(seed, steps, f, g):
    _, _, rng_steps = jax.random.split(jax.random.key(seed), 3)
    out = {}
    for idx in steps:
        rng_s = jax.random.fold_in(jax.random.fold_in(rng_steps, 7919), idx)
        out[idx] = [torch.from_numpy(np.array(jax.random.normal(k, (g, RES // 8, RES // 8, 4), jnp.float32)))
                    for k in jax.random.split(rng_s, f // g)]
    return out


def test_batch_with_background_smoothing(weights):
    from fresco_torch.pipeline import runner as trunner
    from fresco_tpu.diffusion.scheduler import DDPMScheduler as JSched
    from fresco_tpu.pipeline import runner as jrunner
    from fresco_tpu.pipeline.text import HashTokenizer
    from test_torch_models import torch_tiny_models

    jm, params = weights
    steps = (5, 6)
    jcfg, tcfg = _config(use_saliency=True, bg_smoothing_steps=steps, end_opt_step=4)
    imgs, flows = _inputs()
    sal = _mask(F, RES // 2, RES // 2, seed=2)
    prompts, negs = ["a cat"] * F, ["blurry"] * F

    jbundle = jrunner.ModelBundle(
        jm["unet"], jm["vae"], jm["controlnet"], jm["text"], None,
        JSched(num_inference_steps=jcfg.num_inference_steps), params, HashTokenizer(1000),
        _edges, lambda _: jnp.asarray(sal), flow_fn=lambda a, b: jnp.asarray(flows))
    jpipe = jrunner.FrescoPipeline(jcfg, jbundle)
    jpipe._base_sampler_cfg = dataclasses.replace(jpipe._base_sampler_cfg, bg_vae_chunk=2)
    rng = jax.random.key(jcfg.seed)
    jlat, _ = jpipe._run_batch(jpipe._prepare_batch(imgs, prompts, negs, rng), None, False, rng)
    jimg = np.asarray(jpipe._decode_jit(params, jlat))

    tm = torch_tiny_models(params)
    tbundle = trunner.ModelBundle(
        tm["unet"], tm["vae"], tm["controlnet"], tm["text"], HashTokenizer(1000), _edges, torch.device("cpu"),
        flow_fn=lambda a, b: torch.from_numpy(flows),
        saliency_fn=lambda _: torch.from_numpy(sal))
    tpipe = trunner.FrescoPipeline(tcfg, tbundle)
    tpipe._base_sampler_cfg = dataclasses.replace(tpipe._base_sampler_cfg, bg_vae_chunk=2)
    assert tpipe._base_sampler_cfg.bg_smoothing_steps == steps
    noise = _jax_noise(tcfg.seed, tcfg.num_inference_steps, tcfg.num_warmup_steps)
    noise["bg_enc_noise"] = _bg_noise(tcfg.seed, steps, F, 2)
    tlat, _ = tpipe._translate_batch(imgs, prompts, negs, None, False, noise)
    timg = tpipe.sampler.decode(tlat).numpy()
    assert "saliency" in tpipe.phases.times
    jlat = np.asarray(jlat)
    assert np.isfinite(tlat.numpy()).all()
    assert np.linalg.norm(tlat.numpy() - jlat) / np.linalg.norm(jlat) < 1e-3
    assert np.linalg.norm(timg - jimg) / np.linalg.norm(jimg) < 1e-3
