"""Masked flash attention: the port's wrapper, its plain version and the
cross-frame attention against fresco_tpu on the CPU.  The CUDA kernel is
held against the plain version in test_torch_cuda_kernels.py.

CPU tolerance 2e-5 absolute in float32: the JAX side runs the Pallas
kernel in interpret mode (or its naive reference), the port the plain
float32 math, so only the summation order differs.  The gradients (the
port's autograd against ``jax.vjp`` of the JAX ``flash_attention``, whose
custom VJP is the naive attention's) are held to 2e-5 absolute and 1e-4
relative as well, and the rows with no valid key to exact zeros.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.attention import fresco_attention as tfa
from fresco_torch.attention import flash as tflash
from fresco_torch.attention.flash import flash_attention, naive_attention
from fresco_tpu.attention import flash as jflash
from fresco_tpu.attention import fresco_attention as jfa

ATOL = 2e-5


def _qkv(rng, b, h, sq, sk, d):
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


@pytest.mark.parametrize("d,sk,hole", [
    pytest.param(40, 72, None, id="40"), pytest.param(80, 72, None, id="80"),
    pytest.param(160, 72, None, id="160"), pytest.param(512, 72, None, id="512"),
    # what the CUDA kernel's dispatch and key-tile list tell apart: the
    # two-column-group width, a masked first 64-key tile, two masked tiles in
    # a row
    pytest.param(256, 72, None, id="256"),
    pytest.param(40, 200, (0, 64), id="40-first-tile-masked"),
    pytest.param(40, 200, (64, 192), id="40-two-tiles-masked"),
])
def test_plain_matches_pallas_interpret(rng, d, sk, hole):
    """Ragged lengths, a masked key set and one fully masked batch row."""
    b, h, sq = 2, 2, 40
    q, k, v = _qkv(rng, b, h, sq, sk, d)
    mask = rng.uniform(0, 1, (b, sk)) > 0.4
    if hole is not None:
        mask[:, hole[0]:hole[1]] = False
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
    with pytest.raises(ValueError):
        flash_attention(q, q, q, scale=-1.0)  # the kernel keeps the maximum of the unscaled logits


def _grad_case(rng, d):
    b, h, sq, sk = 2, 2, 24, 40
    q, k, v = _qkv(rng, b, h, sq, sk, d)
    mask = rng.uniform(0, 1, (b, sk)) > 0.4
    mask[1] = False  # a batch row with no valid key: zero output, zero gradients
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, mask, g


def _torch_grads(fn, q, k, v, mask, g):
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*qkv, torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in qkv]


@pytest.mark.parametrize("d", [40, 80])
def test_gradients_match_jax_vjp(rng, d):
    """F18: the port's attention gradients against jax.vjp of the JAX
    flash_attention (on the CPU its naive path, which the custom VJP
    differentiates on the TPU)."""
    q, k, v, mask, g = _grad_case(rng, d)
    ref_out, vjp = jax.vjp(lambda q_, k_, v_: jflash.flash_attention(q_, k_, v_, jnp.asarray(mask)),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    out, grads = _torch_grads(flash_attention, q, k, v, mask, g)
    np.testing.assert_allclose(out, np.asarray(ref_out), atol=ATOL, rtol=1e-4)
    for name, a, b in zip("qkv", grads, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=1e-4, err_msg=f"d{name}")
        assert np.all(a[1] == 0.0), f"d{name} of the batch row with no valid key"


def test_autograd_function_wiring(rng, monkeypatch):
    """The card's path without the card: ``_run`` (what the wrapper calls on
    checked CUDA inputs) with the kernel launch stood in by the naive
    attention, returned as the kernel's [B,Sq,H,D]-buffer view.  Where a
    gradient is needed it goes through ``_FlashAttention``, whose gradients
    equal autograd through the naive attention (zeros on the empty row);
    the mask gets none; under no_grad, or for inputs that need none, the
    launch is called bare and the output has no grad_fn."""
    calls = []

    def stand_in(q, k, v, key_mask, scale):
        calls.append(torch.is_grad_enabled())
        out = naive_attention(q, k, v, key_mask, scale=scale)
        return out.transpose(1, 2).contiguous().transpose(1, 2)

    monkeypatch.setattr(tflash, "_launch", stand_in)
    q, k, v, mask, g = _grad_case(rng, 40)
    scale = 40 ** -0.5
    out, grads = _torch_grads(lambda *a: tflash._run(*a, scale), q, k, v, mask, g)
    assert calls == [False]  # one launch, inside the Function's forward (grad mode off there)
    ref_out, ref = _torch_grads(lambda *a: naive_attention(*a, scale=scale), q, k, v, mask, g)
    np.testing.assert_array_equal(out, ref_out)
    for a, b in zip(grads, ref):
        np.testing.assert_array_equal(a, b)
        assert np.all(a[1] == 0.0)

    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tmask = torch.from_numpy(mask)
    with torch.no_grad():
        assert tflash._run(*qkv, tmask, scale).grad_fn is None
    assert tflash._run(*(t.detach() for t in qkv), tmask, scale).grad_fn is None
    assert calls == [False, False, True]
    assert type(tflash._run(*qkv, tmask, scale).grad_fn).__name__ == "_FlashAttentionBackward"
    # the backward's mask and scale slots are None: neither is differentiated
    node = tflash._run(*qkv, tmask, scale).grad_fn
    res = node.apply(torch.from_numpy(g))
    assert len(res) == 5 and res[3] is None and res[4] is None
