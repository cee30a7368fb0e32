"""The keyframe-batch slice end to end: fresco_tpu's and fresco_torch's
FrescoPipeline._prepare_batch -> _run_batch -> decode at a tiny config
(64 px, 4 keyframes, tiny widths, float32) with the same weights (through
``from_jax_params``), the same flows (through ``flow_fn``), the same
control edges and the same noise: the test re-draws JAX's noise with the
package's own split / fold_in sequence (sampler.py:122,133-137,268-275,
vae.py:174, prepare.py:107,113) and hands it to the port.

Tolerances.  Without the feature optimization the only discontinuities
are the occlusion / mask thresholds, computed from identical flows, so
the latents (|x| up to ~12 with these random weights) agree to 3e-4
absolute after 6 denoise steps of float32 math in two summation orders
(measured: 3e-5).  With it, sign() and |.| in the inner Adam loop
amplify rounding differences (the JAX package saw the same between its
own sharded and single runs), so the full slice is held to 2e-2 relative
Frobenius error (measured: 6e-3).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.core.config import FrescoConfig as TConfig
from fresco_torch.pipeline import runner as trunner
from fresco_tpu.core.config import FrescoConfig as JConfig
from fresco_tpu.diffusion.scheduler import DDPMScheduler as JSched
from fresco_tpu.ops.image import unit_range_to_uint8
from fresco_tpu.pipeline import runner as jrunner
from fresco_tpu.pipeline.text import HashTokenizer
from test_torch_models import jax_tiny_models, torch_tiny_models

F, RES = 4, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(**kw):
    base = dict(resolution=RES, batch_size=F, num_inference_steps=8, num_warmup_steps=2,
                end_opt_step=5, opt_iters=2, dtype="float32", gram_dtype="float32",
                use_saliency=False, prompt="a cat", seed=3)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _inputs():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:RES, 0:RES]
    imgs = []
    for i in range(F):
        base = 127 + 60 * np.sin((xx - 2.0 * i) / 5.0) * np.cos(yy / 7.0)
        disc = ((xx - 20 - 5 * i) ** 2 + (yy - 30) ** 2) < 100
        img = np.stack([base, np.where(disc, 230, base), 255 - base], -1)
        imgs.append(np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8))
    fwd = np.zeros((F, RES, RES, 2), np.float32)
    fwd[..., 0] = 2.0
    fwd[..., 1] = rng.normal(0, 0.3, (F, 1, 1))
    flows = np.concatenate([fwd, -fwd + rng.normal(0, 0.05, fwd.shape).astype(np.float32)])
    return imgs, flows


def _edges(img):
    g = img.astype(np.float32).mean(-1)
    e = np.abs(np.diff(g, axis=0, prepend=g[:1])) + np.abs(np.diff(g, axis=1, prepend=g[:, :1]))
    return np.clip(e * 8, 0, 255).astype(np.uint8)


def _jax_noise(seed: int, n_steps: int, warmup: int):
    rng = jax.random.key(seed)
    lshape = (F, RES // 8, RES // 8, 4)
    rng_noise, rng_enc = jax.random.split(rng)
    rng_init, rng_enc2, rng_steps = jax.random.split(rng, 3)
    arr = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return dict(
        intra_noise=arr(jax.random.normal(rng_noise, lshape, jnp.float32)),
        intra_enc_noise=arr(jax.random.normal(rng_enc, lshape, jnp.float32)),
        init_noise=arr(jnp.tile(jax.random.normal(rng_init, (1, *lshape[1:]), jnp.float32), (F, 1, 1, 1))),
        enc_noise=arr(jax.random.normal(rng_enc2, lshape, jnp.float32)),
        step_noise=torch.stack([
            arr(jax.random.normal(jax.random.fold_in(rng_steps, idx), lshape, jnp.float32))
            for idx in range(warmup, n_steps)]),
    )


@pytest.fixture(scope="module")
def weights():
    return jax_tiny_models(seed=7)


def _run_both(weights, jcfg, tcfg):
    jm, params = weights
    imgs, flows = _inputs()
    prompts, negs = ["a cat"] * F, ["blurry"] * F

    jbundle = jrunner.ModelBundle(
        jm["unet"], jm["vae"], jm["controlnet"], jm["text"], None,
        JSched(num_inference_steps=jcfg.num_inference_steps), params, HashTokenizer(1000),
        _edges, None, flow_fn=lambda a, b: jnp.asarray(flows))
    jpipe = jrunner.FrescoPipeline(jcfg, jbundle)
    rng = jax.random.key(jcfg.seed)
    jlat, jrec = jpipe._run_batch(jpipe._prepare_batch(imgs, prompts, negs, rng), None, False, rng)
    jimg = np.asarray(jpipe._decode_jit(params, jlat))

    tm = torch_tiny_models(params)
    tbundle = trunner.ModelBundle(
        tm["unet"], tm["vae"], tm["controlnet"], tm["text"],
        trunner.DDPMScheduler(num_inference_steps=tcfg.num_inference_steps), HashTokenizer(1000),
        _edges, torch.device("cpu"), flow_fn=lambda a, b: torch.from_numpy(flows))
    tpipe = trunner.FrescoPipeline(tcfg, tbundle)
    noise = _jax_noise(tcfg.seed, tcfg.num_inference_steps, tcfg.num_warmup_steps)
    tlat, trec = tpipe._translate_batch(imgs, prompts, negs, None, False, noise)
    timg = tpipe.sampler.decode(tlat).numpy()
    assert tpipe.decode(tlat).shape == (F, RES, RES, 3)
    return np.asarray(jlat), np.asarray(jrec), jimg, tlat.numpy(), trec.numpy(), timg


def test_slice_without_feature_opt(weights):
    jcfg, tcfg = _config(use_fresco_opt=False)
    jlat, jrec, jimg, tlat, trec, timg = _run_both(weights, jcfg, tcfg)
    assert np.isfinite(tlat).all() and tlat.shape == (F, RES // 8, RES // 8, 4)
    np.testing.assert_allclose(tlat, jlat, atol=3e-4, rtol=0)
    np.testing.assert_allclose(trec, jrec, atol=3e-4, rtol=0)
    np.testing.assert_allclose(timg, jimg, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(unit_range_to_uint8(jnp.asarray(jimg)).shape, (F, RES, RES, 3))


def test_slice_full(weights):
    jcfg, tcfg = _config()
    jlat, _, jimg, tlat, _, timg = _run_both(weights, jcfg, tcfg)
    assert np.isfinite(tlat).all()
    assert np.linalg.norm(tlat - jlat) / np.linalg.norm(jlat) < 2e-2
    assert np.linalg.norm(timg - jimg) / np.linalg.norm(jimg) < 2e-2


def test_port_imports_no_jax():
    """Importing every module of the port and running a tiny forward leaves
    jax (and flax / optax) out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib, torch, fresco_torch\n"
        "for m in pkgutil.walk_packages(fresco_torch.__path__, 'fresco_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from fresco_torch.core.config import FrescoConfig\n"
        "from fresco_torch.pipeline.runner import build_models\n"
        "b = build_models(FrescoConfig(dtype='float32'), tiny=True, device='cpu')\n"
        "with torch.no_grad():\n"
        "    b.unet(torch.zeros(2, 8, 8, 4), 10, torch.zeros(2, 77, 32))\n"
        "    b.vae.decode(torch.zeros(1, 8, 8, 4))\n"
        "bad = [m for m in ('jax', 'jaxlib', 'flax', 'optax', 'cv2') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
