"""Sign-gram (spatial-gradient) kernel: the port's wrapper / plain version
against fresco_tpu's Pallas kernel (interpret mode) and its chunked XLA
path on the CPU.  The CUDA kernels are held against the plain version in
test_torch_cuda_kernels.py.

C is built as v·vᵀ − M for a random ±1 matrix M, so every sign has a
margin of ~1 and both summation orders give the same S: the outputs then
agree to float32 rounding (tolerance 1e-4 relative to |S·v| ~ sqrt(hw)).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fresco_torch.ops.gram_kernel import sign_gram_apply, sign_gram_plain
from fresco_tpu.diffusion import guidance as jguid
from fresco_tpu.ops import gram_kernel as jgram


def _case(rng, b, hw, c):
    v = rng.standard_normal((b, hw, c)).astype(np.float32)
    m = np.where(rng.uniform(0, 1, (b, hw, hw)) > 0.5, 1.0, -1.0).astype(np.float32)
    m = np.triu(m) + np.swapaxes(np.triu(m, 1), 1, 2)  # symmetric, as in the pipeline
    corr = np.einsum("bic,bjc->bij", v, v) - m
    return v, corr.astype(np.float32), np.einsum("bij,bjc->bic", m, v)


def test_matches_pallas_interpret(rng):
    v, corr, expected = _case(rng, 2, 256, 16)
    ref = np.asarray(jgram.sign_gram_apply(jnp.asarray(v), jnp.asarray(corr), interpret=True))
    out = sign_gram_apply(torch.from_numpy(v), torch.from_numpy(corr)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(out, expected, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("hw,chunk", [(200, 64), (130, 1024)])
def test_ragged_hw_matches_chunked_path(rng, hw, chunk):
    """hw that no tile divides (ROADMAP C3); the port's chunks cover every
    row whatever chunk_rows is."""
    v, corr, expected = _case(rng, 2, hw, 24)
    ref = np.asarray(jguid._gram_l1_grad(jnp.asarray(v), jnp.asarray(corr), jnp.float32,
                                         hw, is_dense=True)) * (2 * hw * hw) / 2.0
    out = sign_gram_plain(torch.from_numpy(v), torch.from_numpy(corr), chunk_rows=chunk).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(out, expected, atol=1e-3, rtol=1e-4)


def test_wrapper_checks_shapes():
    with pytest.raises(ValueError):
        sign_gram_apply(torch.zeros(1, 8, 4), torch.zeros(1, 8, 7))
