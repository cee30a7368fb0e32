"""The port's HED and EGNet against fresco_tpu's on the CPU, full width at
64x64 in float32, the same weights carried across by ``from_jax_params``.

Weights are drawn with numpy from the Flax parameter shapes: conv kernels
N(0, 1/fan_in) (so activations keep their scale through the ResNet), the
frozen BatchNorm statistics near their identity values.  Tolerances:

  * HED edge map (sigmoid, in [0, 1]): 1e-5 absolute (measured 2.6e-6);
  * EGNet every head, relative to the head's largest magnitude: 1e-4
    (measured 5.5e-6); the background mask (in [0, 1], its final score
    rescaled to spread 6): 1e-4 absolute (measured 2.3e-5); the port's
    ``final_score`` path equals its own ``forward(x)[2][-1]`` exactly;
  * ``_maxpool_ceil``: exactly torch's MaxPool2d(3, 2, 1, ceil_mode=True)
    and the JAX package's, at odd and even sizes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.models import egnet as te
from fresco_torch.models import hed as th
from fresco_torch.models.convert import from_jax_params
from fresco_tpu.models import egnet as je
from fresco_tpu.models import hed as jh


def _numpy_params(shapes, seed):
    """A numpy tree shaped like ``shapes`` (a Flax params tree of
    ShapeDtypeStructs)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, (1.0 / fan_in) ** 0.5, s.shape).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.5, 1.0, s.shape).astype(np.float32)
        return rng.normal(0, 0.05, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _image(seed, n=2, size=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = 127 + 90 * np.sin(xx / 5.0) * np.cos(yy / 3.0)
    img = np.stack([base, np.roll(base, 9, 1), 255 - base], -1)[None] + rng.normal(0, 10, (n, size, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_hed_matches_jax():
    jm = jh.HED()
    x = _image(0).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    params = _numpy_params(shapes, 1)
    tm = th.HED()
    from_jax_params(params, tm)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 64, 64)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(th.hed_detector(tm, x[0].astype(np.uint8)).shape, (64, 64))


@pytest.fixture(scope="module")
def egnet_pair():
    """Random EGNet weights whose final score is rescaled to mean -8, std
    6 on a sample batch, so that the background mask holds both values."""
    jm = je.EGNet()
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    params = _numpy_params(shapes, 2)
    score = np.asarray(jax.jit(jm.apply)(params, je.saliency_input(_image(4)))[2][-1])
    last = params["params"]["m2_final_1"]
    a = 6.0 / score.std()
    last["kernel"] = (last["kernel"] * a).astype(np.float32)
    last["bias"] = (a * (last["bias"] - score.mean()) - 8.0).astype(np.float32)
    tm = te.EGNet()
    from_jax_params(params, tm)
    return jm, params, tm.eval()


def test_egnet_heads_match_jax(egnet_pair):
    jm, params, tm = egnet_pair
    x = np.array(je.saliency_input(_image(3)))
    tx = te.saliency_input(_image(3))
    np.testing.assert_allclose(tx.numpy(), x, atol=1e-4, rtol=0)
    jheads = jax.jit(jm.apply)(params, jnp.asarray(x))
    theads = tm(torch.from_numpy(x))
    for jlist, tlist in zip(jheads, theads):
        assert len(jlist) == len(tlist)
        for a, b in zip(jlist, tlist):
            a = np.asarray(a)
            assert b.shape == a.shape == (2, 32, 32, 1)
            assert np.abs(b.numpy() - a).max() <= 1e-4 * np.abs(a).max()
    assert torch.equal(tm.final_score(torch.from_numpy(x)), theads[2][-1])


def test_egnet_background_mask_matches_jax(egnet_pair):
    jm, params, tm = egnet_pair
    imgs = _image(4)
    ref = np.asarray(je.make_saliency_fn(jm, params)(imgs))
    out = te.make_saliency_fn(tm)(imgs)
    assert out.shape == ref.shape == (2, 32, 32, 1) and out.dtype == torch.float32
    assert 0.1 < (ref > 0.5).mean() < 0.9
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hw", [(7, 9), (8, 8), (13, 6), (33, 31)])
def test_maxpool_ceil_exact(hw):
    x = np.random.default_rng(5).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = torch.nn.MaxPool2d(3, 2, 1, ceil_mode=True)(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    out = te._maxpool_ceil(torch.from_numpy(x))
    assert torch.equal(out, ref)
    np.testing.assert_array_equal(np.asarray(je._maxpool_ceil(jnp.asarray(x))), ref.numpy())
