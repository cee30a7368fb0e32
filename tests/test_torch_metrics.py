"""The port's consistency metrics against fresco_tpu's on the CPU: the same
frames and flows, float32 sums over 64x64x3 values, held to 1e-5
relative (measured 0); ``avg_pool2d`` to 1e-6 relative."""
import numpy as np
import torch

import jax.numpy as jnp

from fresco_torch import metrics as tm
from fresco_torch.ops.resize import avg_pool2d as t_pool
from fresco_tpu import metrics as jmetrics
from fresco_tpu.ops.resize import avg_pool2d as j_pool
from test_torch_slice import _inputs


def test_avg_pool2d_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 16, 24, 3)).astype(np.float32)
    for k in (2, 8):
        np.testing.assert_allclose(t_pool(torch.from_numpy(x), k).numpy(), np.asarray(j_pool(jnp.asarray(x), k)),
                                   rtol=1e-6, atol=1e-7)


def test_metrics_match_jax():
    imgs, flows = _inputs()
    frames = np.stack(imgs)
    ref = jmetrics.evaluate_translation(frames, lambda a, b: jnp.asarray(flows))
    out = tm.evaluate_translation(frames, lambda a, b: torch.from_numpy(flows))
    assert out["frame_similarity_is_clip"] is False and ref["frame_similarity_is_clip"] is False
    for k in ("warp_error", "frame_similarity"):
        assert np.isfinite(out[k])
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5)
    # a clip that does not move under zero flow scores zero warp error
    still = np.repeat(frames[:1], 3, axis=0)
    zero = lambda a, b: torch.zeros((2 * a.shape[0], *a.shape[1:3], 2))  # noqa: E731
    assert tm.warp_error(torch.from_numpy(still).float(), zero) == 0.0
