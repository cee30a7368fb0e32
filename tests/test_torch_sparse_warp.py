"""The sparse warp mode of ``optimize_feature`` against fresco_tpu's.

``make_sparse_warp``'s sorted transpose equals the JAX structure (both
sort stably); ``apply_sparse_warp``'s forward and gradient match the JAX
``apply_sparse_warp`` and ``jax.grad`` to 1e-5 absolute (float32 sums of
four taps and of each source pixel's run, in orders that may differ);
``optimize_feature(warp_mode="sparse")`` matches the JAX package at the
tiny shape of ``tests/test_torch_guidance.py`` to 1e-4 (its tolerance).
The sparse temporal loss equals the dense one at float32 to 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.diffusion import guidance as tg
from fresco_tpu.diffusion import guidance as jg
from test_torch_guidance import _inputs


def _flow(seed, f=3, h=6, w=7, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((f, h, w, 2)) * scale).astype(np.float32)


def test_make_sparse_warp_matches_jax():
    flow = _flow(0)
    t = tg.make_sparse_warp(torch.from_numpy(flow))
    src, wt, src_s, out_s, wt_s = (np.asarray(a) for a in jg.make_sparse_warp(jnp.asarray(flow)))
    np.testing.assert_array_equal(t.src.numpy(), src)
    np.testing.assert_array_equal(t.wt.numpy(), wt)
    np.testing.assert_array_equal(t.out_sorted.numpy(), out_s)
    np.testing.assert_array_equal(t.wt_sorted.numpy(), wt_s)
    f, hw = src.shape[:2]
    runs = (src_s + np.arange(f)[:, None] * hw).reshape(-1)
    np.testing.assert_array_equal(t.offsets.numpy(), np.searchsorted(runs, np.arange(f * hw + 1)))


@pytest.mark.parametrize("scale", [0.7, 5.0], ids=["small-flow", "large-flow"])
def test_apply_sparse_warp_forward_and_grad_match_jax(scale):
    """Large flows send many taps out of the frame (zero weight, clamped
    to the border): long runs at the border pixels."""
    flow = _flow(1, scale=scale)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 42, 5)).astype(np.float32)
    ct = rng.standard_normal((3, 42, 5)).astype(np.float32)
    jw = jg.make_sparse_warp(jnp.asarray(flow))
    jy = jg.apply_sparse_warp(jnp.asarray(x), *jw)
    jgrad = jax.grad(lambda a: jnp.sum(jg.apply_sparse_warp(a, *jw) * ct))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tg.apply_sparse_warp(tx, tg.make_sparse_warp(torch.from_numpy(flow)))
    (tgrad,) = torch.autograd.grad(ty, tx, torch.from_numpy(ct))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-5, rtol=0)
    dense = tg.warp_matrix(torch.from_numpy(flow))
    np.testing.assert_allclose(ty.detach().numpy(), (dense @ torch.from_numpy(x)).numpy(), atol=1e-5, rtol=0)


def test_temporal_loss_sparse_equals_dense():
    sample, flows, occs, _ = _inputs()
    chunk, h, w = 2, sample.shape[1], sample.shape[2]
    small = tg.prepare_flow_for_scale(torch.from_numpy(flows[0]), torch.from_numpy(occs[0]), (h, w),
                                      dilate_full_res=False)
    back = tg.prepare_flow_for_scale(torch.from_numpy(flows[1]), torch.from_numpy(occs[1]), (h, w),
                                     dilate_full_res=False)
    grads = []
    for make in (lambda fl: tg.warp_matrix(fl, torch.float32), tg.make_sparse_warp):
        x = torch.from_numpy(sample).requires_grad_(True)
        loss = tg.temporal_loss(x, make(small[0]), make(back[0]), small[1], back[1], chunk)
        grads.append((loss.detach(), torch.autograd.grad(loss, x)[0]))
    torch.testing.assert_close(grads[1][0], grads[0][0], atol=1e-5, rtol=0)
    torch.testing.assert_close(grads[1][1], grads[0][1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("gram_dtype", ["float32", "bfloat16"])
def test_optimize_feature_sparse_matches_jax(gram_dtype):
    """The sparse temporal term is float32 in both packages at either gram
    dtype; bf16 grams are held as in test_torch_guidance (2e-2 relative)."""
    sample, flows, occs, ref = _inputs()
    kw = dict(iters=5, gram_dtype=gram_dtype, warp_mode="sparse")
    jout = np.asarray(jg.optimize_feature(
        jnp.asarray(sample), jnp.asarray(flows[0]), jnp.asarray(flows[1]), jnp.asarray(occs[0]),
        jnp.asarray(occs[1]), jnp.asarray(ref), jg.GuidanceConfig(**kw), corr_is_dense=False))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tout = tg.optimize_feature(t(sample), t(flows[0]), t(flows[1]), t(occs[0]), t(occs[1]), t(ref),
                               tg.GuidanceConfig(**kw), corr_is_dense=False).numpy()
    assert np.abs(tout - sample).max() > 1e-2
    if gram_dtype == "float32":
        np.testing.assert_allclose(tout, jout, atol=1e-4, rtol=1e-4)
    else:
        assert np.linalg.norm(tout - jout) / np.linalg.norm(jout) < 2e-2


def test_unsupported_warp_modes_raise():
    sample, flows, occs, ref = _inputs()
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    for mode in ("banded", "nearest"):
        with pytest.raises(ValueError, match="warp_mode"):
            tg.optimize_feature(t(sample), t(flows[0]), t(flows[1]), t(occs[0]), t(occs[1]), t(ref),
                                tg.GuidanceConfig(iters=1, warp_mode=mode), corr_is_dense=False)
    with pytest.raises(ValueError, match="banded"):
        jg.optimize_feature(jnp.asarray(sample), jnp.asarray(flows[0]), jnp.asarray(flows[1]),
                            jnp.asarray(occs[0]), jnp.asarray(occs[1]), jnp.asarray(ref),
                            jg.GuidanceConfig(iters=1, warp_mode="banded"), corr_is_dense=False)
