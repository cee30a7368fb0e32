"""FreeU against fresco_tpu's: the two functions, and the tiny UNet with
``use_freeu`` on the same weights.

float32 throughout.  The functions: 1e-5 absolute on O(1) values (two
FFTs in float32, pocketfft against XLA's).  The UNet: 1e-4 absolute (1e-3
relative), ``tests/test_torch_models.py``'s tolerance for the UNet, which
the FFTs inside it fit well within.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.models import unet as tunet
from fresco_torch.models.convert import from_jax_params
from fresco_torch.ops import freeu as tf
from fresco_tpu.models import unet as junet
from fresco_tpu.ops import freeu as jf


@pytest.mark.parametrize("shape,threshold,scale", [((2, 8, 8, 6), 1, 0.9), ((1, 7, 10, 3), 2, 1.3)],
                         ids=["even", "odd"])
def test_fourier_filter_matches_jax(shape, threshold, scale):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = tf.fourier_filter(torch.from_numpy(x), threshold, scale).numpy()
    want = np.asarray(jf.fourier_filter(jnp.asarray(x), threshold, scale))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got - x).max() > 1e-3  # the filter did something


def test_apply_freeu_to_skip_matches_jax():
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    s = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    gh, gs = tf.apply_freeu_to_skip(torch.from_numpy(h), torch.from_numpy(s), 1.4, 0.8, 8)
    wh, ws = jf.apply_freeu_to_skip(jnp.asarray(h), jnp.asarray(s), 1.4, 0.8, 8)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5, rtol=0)


def _count_freeu_calls(monkeypatch, model, *args):
    widths = []
    real = tf.apply_freeu_to_skip

    def spy(h, skip, b, s, c):
        widths.append(h.shape[-1])
        return real(h, skip, b, s, c)

    monkeypatch.setattr(tunet, "apply_freeu_to_skip", spy)
    out = model(*args)
    return out, widths


def test_tiny_unet_with_freeu_matches_jax(monkeypatch):
    freeu = dict(use_freeu=True, freeu_b1=1.3, freeu_b2=1.4, freeu_s1=0.9, freeu_s2=0.8)
    jcfg = dataclasses.replace(junet.UNetConfig.tiny(), cross_attention_dim=32, **freeu)
    tcfg = tunet.UNetConfig(**dataclasses.asdict(jcfg))
    jm = junet.UNet2DCondition(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), x, jnp.int32(0), ctx)
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.int32(311), jnp.asarray(ctx)))
    tm = tunet.UNet2DCondition(tcfg)
    from_jax_params(params, tm)
    with torch.no_grad():
        got, widths = _count_freeu_calls(monkeypatch, tm.eval(), torch.from_numpy(x), 311, torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)
    # once per up-block resnet whose input is 16 (b1) or 8 (b2) wide: the
    # 2 + 2 resnets of the tiny UNet's two up blocks
    assert widths == [16, 16, 16, 8]
    off = tunet.UNet2DCondition(dataclasses.replace(tcfg, use_freeu=False))
    off.load_state_dict(tm.state_dict())
    with torch.no_grad():
        assert (off.eval()(torch.from_numpy(x), 311, torch.from_numpy(ctx)) - got).abs().max() > 1e-3
