"""Masked flash attention: the port's wrapper, its plain version and the
cross-frame attention against fresco_tpu on the CPU.  The CUDA kernel is
held against the plain version in test_torch_cuda_kernels.py.

CPU tolerance 2e-5 absolute in float32: the JAX side runs the Pallas
kernel in interpret mode (or its naive reference), the port the plain
float32 math, so only the summation order differs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fresco_torch.attention import fresco_attention as tfa
from fresco_torch.attention.flash import flash_attention, naive_attention
from fresco_tpu.attention import flash as jflash
from fresco_tpu.attention import fresco_attention as jfa

ATOL = 2e-5


def _qkv(rng, b, h, sq, sk, d):
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


@pytest.mark.parametrize("d", [40, 80, 160, 512])
def test_plain_matches_pallas_interpret(rng, d):
    """Ragged lengths, a masked key set and one fully masked batch row."""
    b, h, sq, sk = 2, 2, 40, 72
    q, k, v = _qkv(rng, b, h, sq, sk, d)
    mask = rng.uniform(0, 1, (b, sk)) > 0.4
    mask[1] = False  # no valid key at all -> exact zeros
    ref = np.asarray(jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(mask), interpret=True))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)
    assert np.all(out[1] == 0.0)


def test_plain_matches_naive_reference(rng):
    q, k, v = _qkv(rng, 1, 3, 33, 50, 8)
    mask = rng.uniform(0, 1, (1, 50)) > 0.5
    for m in (None, mask):
        ref = np.asarray(jflash.naive_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if m is None else jnp.asarray(m)))
        out = naive_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("with_perm", [False, True])
def test_cross_frame_attention(rng, with_perm):
    chunk, f, hw, c, heads = 2, 3, 16, 8, 2
    q, k, v = (rng.standard_normal((chunk * f, hw, c)).astype(np.float32) for _ in range(3))
    mask = np.concatenate([np.ones((1, hw), bool), rng.uniform(0, 1, (f - 1, hw)) > 0.6])
    jperm = tperm = None
    if with_perm:
        flat = mask.reshape(-1)
        perm = np.argsort(~flat, kind="stable")[: 2 * hw]
        jperm = (jnp.asarray(perm.astype(np.int32)), jnp.asarray(flat[perm]))
        tperm = (torch.from_numpy(perm), torch.from_numpy(flat[perm]))
    ref = jfa.cross_frame_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                                    chunk, heads, key_perm=jperm)
    out = tfa.cross_frame_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(mask), chunk, heads, key_perm=tperm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-4)
    # maskless mode: frame 0's keys only
    ref0 = jfa.cross_frame_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, chunk, heads)
    out0 = tfa.cross_frame_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                     None, chunk, heads)
    np.testing.assert_allclose(out0.numpy(), np.asarray(ref0), atol=ATOL, rtol=1e-4)


def test_spatial_and_trajectory_attention(rng):
    chunk, f, h, w, c, heads = 2, 3, 4, 4, 8, 2
    hw = h * w
    x = [rng.standard_normal((chunk * f, hw, c)).astype(np.float32) for _ in range(5)]
    ref = jfa.spatial_guided_query(*(jnp.asarray(a) for a in x[:3]), heads, 0.2)
    out = tfa.spatial_guided_query(*(torch.from_numpy(a) for a in x[:3]), heads, 0.2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-4)
    fwd = np.stack([rng.permutation(hw) for _ in range(f)])
    bwd = np.argsort(fwd, axis=1)
    tmask = rng.uniform(0, 1, (hw, f, f)) > 0.3
    tmask[:, np.arange(f), np.arange(f)] = True
    ref = jfa.trajectory_attention(*(jnp.asarray(a) for a in x[2:5]), jnp.asarray(fwd.astype(np.int32)),
                                   jnp.asarray(bwd.astype(np.int32)), jnp.asarray(tmask), chunk, heads, 0.2)
    out = tfa.trajectory_attention(*(torch.from_numpy(a) for a in x[2:5]), torch.from_numpy(fwd),
                                   torch.from_numpy(bwd), torch.from_numpy(tmask), chunk, heads, 0.2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-4)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 1, 5, 16), torch.zeros(1, 1, 5, 16))
    with pytest.raises(ValueError):
        flash_attention(q, q, q, torch.ones(1, 3, dtype=torch.bool))
