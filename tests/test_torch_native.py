"""The port's native C++ serpentine backend against fresco_tpu's, on the CPU.

Both packages compile the same patchmatch.cpp (the port's copy differs
only in its header comment).  Tolerances:
- one level fed the same arrays: bit for bit (the serpentine runs
  serially; OpenMP covers only the data-parallel loops);
- the whole pyramid through ``synthesize(backend="native")``: the two
  ``resize_bilinear`` implementations may differ by an ulp between levels,
  and a changed input may send the serpentine down another path, so the
  style is held to a mean |d| of 0.5 levels and 99 % of NNF entries equal
  (measured here: bit-equal);
- identity reconstruction as ``tests/test_native_patchmatch.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fresco_torch.propagate import patchmatch as T
from fresco_tpu.propagate import patchmatch as J

PYRAMID_MEAN_ABS = 0.5
PYRAMID_NNF_AGREE = 0.99


@pytest.fixture(scope="module")
def native_available():
    from fresco_torch.propagate.native import is_available as port_ok
    from fresco_tpu.propagate.native import is_available as jax_ok

    if not (port_ok() and jax_ok()):
        pytest.skip("g++/OpenMP unavailable")
    return True


def _inputs(seed=0, h=40, w=48):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    g = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w, 6)), (2, 2, 0)).astype(np.float32)
    style = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w, 3)), (1, 1, 0)).astype(np.float32)
    tgt = np.clip(np.roll(g, (2, -3), (0, 1)) + rng.normal(0, 4, g.shape), 0, 255).astype(np.float32)
    gw = np.repeat(np.array([3.0, 1.0], np.float32) / 3, 3)
    return style, g, tgt, gw


def test_level_bit_equal_to_jax(native_available):
    from fresco_torch.propagate.native import synthesize_level_native as port_level
    from fresco_tpu.propagate.native import synthesize_level_native as jax_level

    style, g, tgt, gw = _inputs()
    rng = np.random.default_rng(1)
    h, w = style.shape[:2]
    nnf0 = np.stack([rng.integers(2, h - 2, (h, w)), rng.integers(2, w - 2, (h, w))], -1).astype(np.int32)
    ws = np.full(3, 1 / 3, np.float32)
    kw = dict(patch=5, pm_iters=3, sv_iters=2, uniformity=3500.0, seed=3)
    po, pe, pn = port_level(style, g, tgt, ws, gw, nnf0.copy(), **kw)
    jo, je, jn = jax_level(style, g, tgt, ws, gw, nnf0.copy(), **kw)
    np.testing.assert_array_equal(pn, jn)
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(pe, je)


@pytest.mark.parametrize("extra_pass", [False, True])
def test_pyramid_matches_jax(native_available, extra_pass):
    style, g, tgt, gw = _inputs(2)
    cfg_kw = dict(pm_iters=3, sv_iters=2, extra_pass_3x3=extra_pass)
    to, te, tn = T.synthesize(*(torch.from_numpy(a) for a in (style, g, tgt, gw)),
                              T.PatchMatchConfig(**cfg_kw), backend="native")
    jo, je, jn = (np.asarray(a) for a in J.synthesize(*(jnp.asarray(a) for a in (style, g, tgt, gw)),
                                                       J.PatchMatchConfig(**cfg_kw), backend="native"))
    assert to.dtype == torch.float32 and tn.dtype == torch.int32 and to.device.type == "cpu"
    assert np.abs(to.numpy() - jo).mean() <= PYRAMID_MEAN_ABS
    assert (tn.numpy() == jn).all(-1).mean() >= PYRAMID_NNF_AGREE
    assert np.isfinite(te.numpy()).all() and te.shape == je.shape


def test_native_identity_reconstruction(native_available):
    rng = np.random.default_rng(0)
    h = w = 48
    checker = ((np.add.outer(np.arange(h) // 8, np.arange(w) // 8) % 2) * 200 + 30)[:, :, None]
    guides = (0.8 * np.tile(checker, (1, 1, 3)) + 0.2 * rng.uniform(0, 255, (h, w, 3))).astype(np.float32)
    style = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    cfg = T.PatchMatchConfig(patch_size=5, pm_iters=3, sv_iters=3, uniformity=0.0, num_pyramid_levels=2)
    out, err, _ = T.synthesize(torch.from_numpy(style), torch.from_numpy(guides), torch.from_numpy(guides),
                               torch.full((3,), 2.0), cfg, backend="native")
    m = 6
    assert np.abs(out.numpy()[m:-m, m:-m] - style[m:-m, m:-m]).mean() < 10.0
    assert (err.numpy() >= 0).all()


def test_failed_build_raises(monkeypatch, tmp_path):
    """A g++ failure raises with its output; there is no fallback."""
    from fresco_torch.propagate.native import binding

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(binding, "SRC", str(bad))
    monkeypatch.setattr(binding, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(binding, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        binding.build_library()
