"""optimize_feature (the inner-Adam feature optimization) against
fresco_tpu's on the CPU: same feature, flows, occlusions and factored
reference gram from numpy.

float32 grams: tolerance 1e-4 absolute on the AdaIN-renormalized output
(O(1)).  The loss has sign() and |.| kinks, but at a fixed input both
packages take the same branch unless a residual lands within float32
rounding of 0, which these seeded inputs do not.  bfloat16 grams route
the port's spatial gradient through the sign-gram wrapper, or with the
reference gram factored through the factored wrapper (their plain
versions on the CPU), and JAX's through its chunked path; bf16 rounding
flips near-tie signs, so those cases are held to 2e-2 relative Frobenius.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fresco_torch.diffusion import guidance as tg
from fresco_tpu.diffusion import guidance as jg


def _inputs(seed=0, chunk=2, f=3, h=8, w=8, c=16, H=64):
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((chunk * f, h, w, c)).astype(np.float32)
    base = rng.standard_normal((2, f, H // 16, H // 16, 2)).astype(np.float32) * 4
    flows = np.repeat(np.repeat(base, 16, axis=2), 16, axis=3)
    occs = (rng.uniform(0, 1, (2, f, H, H)) > 0.85).astype(np.float32)
    ref = rng.standard_normal((chunk * f, h * w, c)).astype(np.float32)
    ref /= np.linalg.norm(ref, axis=-1, keepdims=True)
    return sample, flows, occs, ref


@pytest.mark.parametrize("gram_dtype,max_mb", [("float32", 600.0), ("bfloat16", 600.0), ("float32", 0.0),
                                                ("bfloat16", 0.0)],
                         ids=["f32-dense", "bf16-dense", "f32-factored", "bf16-factored"])
def test_optimize_feature(gram_dtype, max_mb):
    """max_mb = 0 keeps the reference gram factored (rebuilt per row chunk)."""
    sample, flows, occs, ref = _inputs()
    jcfg = jg.GuidanceConfig(iters=5, gram_dtype=gram_dtype, dense_corr_max_mb=max_mb)
    tcfg = tg.GuidanceConfig(iters=5, gram_dtype=gram_dtype, dense_corr_max_mb=max_mb)
    jout = np.asarray(jg.optimize_feature(
        jnp.asarray(sample), jnp.asarray(flows[0]), jnp.asarray(flows[1]), jnp.asarray(occs[0]),
        jnp.asarray(occs[1]), jnp.asarray(ref), jcfg, corr_is_dense=False))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tout = tg.optimize_feature(t(sample), t(flows[0]), t(flows[1]), t(occs[0]), t(occs[1]), t(ref),
                               tcfg, corr_is_dense=False).numpy()
    assert np.abs(tout - sample).max() > 1e-2  # the loop moved the feature
    if gram_dtype == "float32":
        np.testing.assert_allclose(tout, jout, atol=1e-4, rtol=1e-4)
    else:
        assert np.linalg.norm(tout - jout) / np.linalg.norm(jout) < 2e-2


@pytest.mark.parametrize("temporal,spatial", [(True, False), (False, True)])
def test_each_loss_alone(temporal, spatial):
    sample, flows, occs, ref = _inputs(seed=1)
    kw = dict(iters=3, gram_dtype="float32", optimize_temporal=temporal)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    jout = jg.optimize_feature(jnp.asarray(sample), jnp.asarray(flows[0]), jnp.asarray(flows[1]),
                               jnp.asarray(occs[0]), jnp.asarray(occs[1]),
                               jnp.asarray(ref) if spatial else None, jg.GuidanceConfig(**kw),
                               corr_is_dense=False)
    tout = tg.optimize_feature(t(sample), t(flows[0]), t(flows[1]), t(occs[0]), t(occs[1]),
                               t(ref) if spatial else None, tg.GuidanceConfig(**kw), corr_is_dense=False)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)


def test_warp_matrix_matches(rng):
    flow = (rng.standard_normal((2, 6, 7, 2)) * 3).astype(np.float32)
    np.testing.assert_allclose(tg.warp_matrix(torch.from_numpy(flow)).numpy(),
                               np.asarray(jg.warp_matrix(jnp.asarray(flow))), atol=1e-6)
