"""Sign-gram (spatial-gradient) kernel: the port's wrapper / plain version
against fresco_tpu's Pallas kernel (interpret mode) and its chunked XLA
path on the CPU.  The CUDA kernels are held against the plain version in
test_torch_cuda_kernels.py.

C is built as v·vᵀ − M for a random ±1 matrix M, so every sign has a
margin of ~1 and both summation orders give the same S: the outputs then
agree to float32 rounding (tolerance 1e-4 relative to |S·v| ~ sqrt(hw)).

The factored form, C = r·rᵀ: its plain version is the chunked branch that
``guidance._gram_l1_grad`` ran inline before it moved, bit for bit in
every dtype; its wrapper (the plain version on the CPU) against the JAX
package's chunked bf16 path on values on a 1/16 grid, where every sum is
exact in float32, so any summation order gives the same bits; and the
wrapper's checks.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fresco_torch.diffusion import guidance as tguid
from fresco_torch.ops.gram_kernel import (factored_sign_gram_apply, factored_sign_gram_plain, sign_gram_apply,
                                          sign_gram_plain)
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


def test_bf16_matches_pallas_interpret(rng):
    """The main path's gram dtype: bf16 v and C through the port's wrapper
    (its plain version on the CPU, no launch counted) and the Pallas
    kernel in interpret mode."""
    v, corr, _ = _case(rng, 2, 128, 32)
    vt = torch.from_numpy(v).to(torch.bfloat16)
    ct = torch.from_numpy(corr).to(torch.bfloat16)
    ref = np.asarray(jgram.sign_gram_apply(jnp.asarray(vt.float().numpy(), jnp.bfloat16),
                                           jnp.asarray(ct.float().numpy(), jnp.bfloat16), interpret=True))
    before, by_shape = sign_gram_apply.launches, dict(sign_gram_apply.launches_by_shape)
    out = sign_gram_apply(vt, ct)
    assert sign_gram_apply.launches == before and sign_gram_apply.launches_by_shape == by_shape
    assert out.dtype == torch.float32 and out.shape == (2, 128, 32)
    np.testing.assert_allclose(out.numpy(), ref.astype(np.float32), atol=1e-3, rtol=1e-4)


def _chunked_branch(v_hat, correlation, gram_dtype, chunk_rows):
    """``_gram_l1_grad``'s factored branch as it stood before the plain
    version moved to ``gram_kernel`` (the yardstick of the move)."""
    b, hw, c = v_hat.shape
    n = b * hw * hw
    vg = v_hat.to(gram_dtype)
    work = torch.promote_types(gram_dtype, torch.float32)
    vf = vg.to(work)
    vr = correlation.to(gram_dtype).to(work)
    grad = torch.empty((b, hw, c), dtype=work, device=v_hat.device)
    for row0 in range(0, hw, chunk_rows):
        rows = slice(row0, row0 + chunk_rows)
        g = torch.matmul(vf[:, rows], vf.transpose(1, 2))
        s = torch.sign(g - torch.matmul(vr[:, rows], vr.transpose(1, 2)))
        grad[:, rows] = 2.0 * torch.matmul(s, vf)
    return grad / n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("hw,chunk", [(200, 64), (96, 1024)])
def test_factored_plain_is_the_chunked_branch(rng, dtype, hw, chunk):
    """``_gram_l1_grad`` with C factored gives the old inline branch's bits:
    float32 and float64 through ``factored_sign_gram_plain`` at the
    caller's chunk, bf16 through the wrapper (its plain version here, at
    1024-row chunks, which covers hw in one); and the plain version alone,
    scaled as the caller scales it, equals the branch too."""
    v = torch.from_numpy(rng.standard_normal((2, hw, 24))).to(dtype)
    r = torch.from_numpy(rng.standard_normal((2, hw, 24))).to(dtype)
    v = v / v.float().norm(dim=-1, keepdim=True).to(dtype)
    r = r / r.float().norm(dim=-1, keepdim=True).to(dtype)
    chunk = hw if dtype == torch.bfloat16 else chunk
    old = _chunked_branch(v, r, dtype, chunk)
    new = tguid._gram_l1_grad(v, r, dtype, chunk, is_dense=False)
    assert new.dtype == old.dtype and torch.equal(new, old)
    assert torch.equal(2.0 * factored_sign_gram_plain(v.to(dtype), r.to(dtype), chunk) / (2 * hw * hw), old)


def _grid(rng, shape):
    """Values k/16, |k| <= 16: bf16-exact, and every product sum of up to
    a few thousand terms is exact in float32."""
    return np.clip(np.round(rng.standard_normal(shape) * 4), -16, 16).astype(np.float32) / 16


@pytest.mark.parametrize("b,hw,c,chunk", [(2, 128, 32, 64), (1, 200, 16, 200)])
def test_factored_wrapper_matches_jax_chunked(rng, b, hw, c, chunk):
    """bf16 through the port's factored wrapper (no launch counted on the
    CPU) against the JAX package's chunked bf16 einsums (hw a multiple of
    its chunk: it drops the remainder rows, F1), on grid values where both
    are exact, ties (D = 0, sign 0) included: equal bits."""
    v, r = _grid(rng, (b, hw, c)), _grid(rng, (b, hw, c))
    ref = np.asarray(jguid._gram_l1_grad(jnp.asarray(v), jnp.asarray(r), jnp.bfloat16, chunk, is_dense=False))
    before = factored_sign_gram_apply.launches
    out = factored_sign_gram_apply(torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(r).to(torch.bfloat16))
    assert factored_sign_gram_apply.launches == before
    assert out.dtype == torch.float32 and out.shape == (b, hw, c)
    d = v.astype(np.float64) @ np.swapaxes(v, 1, 2) - r.astype(np.float64) @ np.swapaxes(r, 1, 2)
    assert (d == 0).any()  # the grid gives exact ties
    np.testing.assert_array_equal(2.0 * out.numpy() / (b * hw * hw), ref)
    np.testing.assert_array_equal(out.numpy(), (np.sign(d) @ v).astype(np.float32))


def _misaligned(shape):
    buf = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16)
    return buf[1:].view(shape)


@pytest.mark.parametrize("make,err", [
    (lambda: (torch.zeros(1, 8, 16), torch.zeros(1, 8, 16)), TypeError),                       # float32
    (lambda: (torch.zeros(1, 8, 16, dtype=torch.bfloat16), torch.zeros(1, 8, 16)), TypeError),  # mixed
    (lambda: (torch.zeros(1, 8, 16, dtype=torch.bfloat16), torch.zeros(1, 8, 24, dtype=torch.bfloat16)),
     ValueError),
    (lambda: (torch.zeros(8, 16, dtype=torch.bfloat16),) * 2, ValueError),                      # not [B, hw, c]
    (lambda: (torch.zeros(1, 8, 12, dtype=torch.bfloat16),) * 2, ValueError),                   # c % 8 != 0
    (lambda: (torch.zeros(1, 16, 8, dtype=torch.bfloat16).transpose(1, 2),) * 2, ValueError),   # not contiguous
    (lambda: (_misaligned((1, 8, 16)), torch.zeros(1, 8, 16, dtype=torch.bfloat16)), ValueError),  # 2 bytes off
], ids=["float32", "mixed-dtype", "shapes-differ", "two-dims", "c-not-8", "strided", "misaligned"])
def test_factored_wrapper_raises(make, err):
    """The kernel's contract, checked on every device before any launch."""
    v, r = make()
    with pytest.raises(err):
        factored_sign_gram_apply(v, r)
