"""The port's GMFlow against fresco_tpu's on the CPU.

Window split/merge, the shifted-window mask and the sine embedding are
pure index and float32 arithmetic and must agree exactly (the embedding
to 1 ulp: sin/cos of the same float32 arguments in two libraries).  The
tiny GMFlow (16 channels, 2 layers) at 64x64 carries the same weights
through ``from_jax_params``:

  * float32: flows (up to 45 px here) agree to 2e-3 px absolute
    (measured 4.8e-4: the global softmax turns summation-order noise in
    the correlation into small flow differences);
  * aux_dtype bfloat16 (weights and frames rounded to bfloat16, the
    arithmetic float32 in both packages): 2e-3 px as well (measured
    5.1e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.models.convert import from_jax_params
from fresco_torch.models.gmflow import model as tg
from fresco_tpu.models.gmflow import model as jg

FLOW_ATOL = 2e-3


def test_split_merge_windows_exact():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(np.float32)
    for k in (2, 4):
        js = np.asarray(jg.split_windows(jnp.asarray(x), k))
        ts = tg.split_windows(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tg.merge_windows(torch.from_numpy(ts), k).numpy(), x)
        np.testing.assert_array_equal(np.asarray(jg.merge_windows(jnp.asarray(js), k)), x)


@pytest.mark.parametrize("h,w", [(8, 8), (8, 12), (16, 20)])
def test_shifted_mask_and_embedding_exact(h, w):
    np.testing.assert_array_equal(tg.shifted_window_mask(h, w, 2).numpy(),
                                  np.asarray(jg.shifted_window_mask(h, w, 2)))
    np.testing.assert_allclose(tg.sine_position_embedding(h // 2, w // 2, 8).numpy(),
                               np.asarray(jg.sine_position_embedding(h // 2, w // 2, 8)),
                               rtol=0, atol=5e-7)


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = jg.GMFlowConfig.tiny()
    jm = jg.GMFlow(cfg)
    img = jnp.zeros((1, 64, 64, 3))
    params = jax.jit(jm.init)(jax.random.key(0), img, img)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: (np.asarray(x) + rng.normal(0, 0.02, x.shape)).astype(np.float32), params)
    tm = tg.GMFlow(tg.GMFlowConfig.tiny())
    from_jax_params(params, tm)
    return jm, params, tm.eval()


def _frames():
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:64, 0:64]
    base = 127 + 80 * np.sin(xx / 4.0) * np.cos(yy / 5.0)
    a = np.stack([base, 255 - base, np.roll(base, 7, 0)], -1)[None].repeat(2, 0)
    a[1] = np.roll(a[1], 3, 1)
    b = np.roll(a, (2, 1), (1, 2)) + rng.normal(0, 2, a.shape)
    return np.clip(a, 0, 255).astype(np.float32), np.clip(b, 0, 255).astype(np.float32)


@pytest.mark.parametrize("aux", ["float32", "bfloat16"])
def test_tiny_gmflow_matches_jax(tiny_pair, aux):
    jm, params, tm = tiny_pair
    a, b = _frames()
    if aux == "bfloat16":
        jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
        ref = jm.apply(jp, jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)).astype(jnp.float32)
        tmod = tg.GMFlow(tg.GMFlowConfig.tiny())
        tmod.load_state_dict(tm.state_dict())
        tmod = tmod.to(torch.bfloat16).float()  # weights rounded, as build_models does
        out = tmod(*(torch.from_numpy(t).to(torch.bfloat16).float() for t in (a, b)))
    else:
        ref = jm.apply(params, jnp.asarray(a), jnp.asarray(b))
        out = tm(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and out.shape == (4, 64, 64, 2)
    err = np.abs(out.numpy() - ref).max()
    assert err < FLOW_ATOL, err
