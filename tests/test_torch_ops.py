"""fresco_torch ops and scheduler against their fresco_tpu twins on the CPU.

Inputs come from numpy with a fixed seed and go through both packages in
float32.  Tolerances: 1e-5 absolute for the resampling / warp / AdaIN /
scheduler math (the same float ops, possibly fused differently by XLA);
exact equality for the integer outputs (occlusion thresholds on the
same flows, trajectory permutations — ROADMAP C5: the stable-sort order
must reproduce the greedy loop's tie-break).
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fresco_torch.diffusion import scheduler as tsched
from fresco_torch.ops import adain as tadain
from fresco_torch.ops import blend as tblend
from fresco_torch.ops import image as timage
from fresco_torch.ops import mapping as tmapping
from fresco_torch.ops import resize as tresize
from fresco_torch.ops import warp as twarp
from fresco_tpu.diffusion import scheduler as jsched
from fresco_tpu.ops import blend as jblend
from fresco_tpu.ops import image as jimage
from fresco_tpu.ops import mapping as jmapping
from fresco_tpu.ops import resize as jresize
from fresco_tpu.ops import warp as jwarp

# the package's __init__ re-exports the function under the module's name
jadain = importlib.import_module("fresco_tpu.ops.adain")

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=1e-5)


def _smooth_flow(rng, n, h, w, amp=3.0):
    base = rng.standard_normal((n, h // 8, w // 8, 2)).astype(np.float32) * amp
    return np.asarray(jresize.resize_bilinear(jnp.asarray(base), (h, w)))


@pytest.mark.parametrize("out_hw,align", [((12, 20), False), ((40, 24), False), ((13, 7), True)])
def test_resize_bilinear(rng, out_hw, align):
    x = rng.standard_normal((2, 24, 16, 3)).astype(np.float32)
    _close(jresize.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align),
           tresize.resize_bilinear(_t(x), out_hw, align_corners=align))


def test_max_pool2d(rng):
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    _close(jresize.max_pool2d(jnp.asarray(x), 4), tresize.max_pool2d(_t(x), 4))


def test_unit_range_to_uint8(rng):
    x = rng.uniform(-1.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(jimage.unit_range_to_uint8(jnp.asarray(x)),
                                  timage.unit_range_to_uint8(_t(x)))


def test_flow_warp_and_sample(rng):
    img = rng.standard_normal((2, 20, 24, 5)).astype(np.float32)
    flow = _smooth_flow(rng, 2, 20, 24)
    _close(jwarp.flow_warp(jnp.asarray(img), jnp.asarray(flow)), twarp.flow_warp(_t(img), _t(flow)))
    coords = rng.uniform(-2, 26, (2, 7, 9, 2)).astype(np.float32)
    for mode in ("zeros", "border"):
        ja, jm = jwarp.bilinear_sample(jnp.asarray(img), jnp.asarray(coords), padding_mode=mode,
                                       return_mask=True)
        ta, tm = twarp.bilinear_sample(_t(img), _t(coords), padding_mode=mode, return_mask=True)
        _close(ja, ta)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


def test_forward_backward_consistency(rng):
    fwd = _smooth_flow(rng, 3, 32, 32)
    bwd = -fwd + rng.standard_normal(fwd.shape).astype(np.float32) * 0.3
    jf, jb = jwarp.forward_backward_consistency(jnp.asarray(fwd), jnp.asarray(bwd))
    tf, tb = twarp.forward_backward_consistency(_t(fwd), _t(bwd))
    assert 0 < float(tf.mean()) < 1
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


@pytest.mark.parametrize("scale", [4.0, 8.0])
def test_batch_mappings_exact(rng, scale):
    n, H, W = 4, 64, 64
    frames = rng.uniform(-1, 1, (n, H, W, 3)).astype(np.float32)
    # quantized colours make colour-error ties common: the tie-break is
    # what this test holds fixed
    frames = np.round(frames * 2) / 2
    flows = _smooth_flow(rng, n - 1, H, W, amp=6.0)
    occs = (rng.uniform(0, 1, (n - 1, H, W)) > 0.8).astype(np.float32)
    jf, jb, jm = jmapping.batch_mappings(jnp.asarray(flows), jnp.asarray(occs), jnp.asarray(frames), scale)
    tf, tb, tm = tmapping.batch_mappings(_t(flows), _t(occs), _t(frames), scale)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


@pytest.mark.parametrize("target,dilate", [((8, 8), False), ((16, 16), True), ((64, 64), True)])
def test_prepare_flow_for_scale(rng, target, dilate):
    flow = _smooth_flow(rng, 3, 64, 64)
    occ = (rng.uniform(0, 1, (3, 64, 64)) > 0.9).astype(np.float32)
    jfl, joc = jblend.prepare_flow_for_scale(jnp.asarray(flow), jnp.asarray(occ), target,
                                             dilate_full_res=dilate)
    tfl, toc = tblend.prepare_flow_for_scale(_t(flow), _t(occ), target, dilate_full_res=dilate)
    _close(jfl, tfl)
    _close(joc, toc)


@pytest.mark.parametrize("style_eps", [1e-5, 1.0])
def test_adain(rng, style_eps):
    content = rng.standard_normal((4, 6, 5, 7)).astype(np.float32) * 2 + 1
    style = rng.standard_normal((4, 6, 5, 7)).astype(np.float32)
    _close(jadain.adain(jnp.asarray(content), jnp.asarray(style), style_eps=style_eps),
           tadain.adain(_t(content), _t(style), style_eps=style_eps), atol=1e-4)
    jm, js = jadain.calc_mean_std(jnp.asarray(content), chunk=2)
    tm, ts = tadain.calc_mean_std(_t(content), chunk=2)
    _close(jm, tm)
    _close(js, ts)


def test_scheduler(rng):
    js, ts = jsched.DDPMScheduler(num_inference_steps=20), tsched.DDPMScheduler(num_inference_steps=20)
    np.testing.assert_array_equal(js.timesteps_np, ts.timesteps_np)
    _close(js.alphas_cumprod, ts.alphas_cumprod, atol=1e-6)
    x0 = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    eps = rng.standard_normal(x0.shape).astype(np.float32)
    for t in (950, 350, 0):
        xt_j = js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.int32(t))
        xt_t = ts.add_noise(_t(x0), _t(noise), t)
        _close(xt_j, xt_t)
        p_j = js.predict_x0(xt_j, jnp.asarray(eps), jnp.int32(t))
        p_t = ts.predict_x0(xt_t, _t(eps), t)
        _close(p_j, p_t, atol=1e-4)
        _close(js.step_from_x0(xt_j, p_j, jnp.int32(t), jnp.asarray(noise)),
               ts.step_from_x0(xt_t, p_t, t, _t(noise)), atol=1e-4)
