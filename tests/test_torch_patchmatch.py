"""fresco_torch.propagate.patchmatch and its kernels' plain versions against
fresco_tpu on the CPU.

Inputs come from numpy with a seed, at 48x64 (three pyramid levels).
Tolerances:
- pyramid sizes, patch layouts, omega and the row gather: exact (the same
  integer counts and copies);
- the plain patch evaluation against JAX's ``eval_cand``: 1e-6 relative
  (float32 sums of 375 terms in another order);
- a whole level, and ``synthesize`` with JAX's own random draws fed to the
  port: at most 0.5 % of NNF entries may differ, each a near tie (the two
  final errors within 1e-4 relative); elsewhere the errors agree to 1e-5
  relative and the voted style to 1e-3 absolute (the vote's sum order);
- the port's full and compacted paths: exactly equal (same draws, same
  arithmetic, frozen pixels keep their match either way);
- a whole level on an 8-px periodic source of small integers, where
  candidates tie bit for bit and the earlier one is kept: the NNF and the
  (exact) errors equal to the JAX level's, the voted style to 1e-3;
- the tile list of the compacted path: exactly a direct reckoning.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from fresco_torch.propagate import patchmatch as T
from fresco_torch.propagate.gather import gather_rows
from fresco_torch.propagate.patch_eval import TILE, active_set, patch_eval_plain
from fresco_tpu.propagate import patchmatch as J

SH, SW = 48, 64
NEAR_TIE = 1e-4
MAX_DIFF_FRAC = 5e-3


def _img(rng, h, w, c):
    x = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w, c)), (2, 2, 0))
    return ((x - x.min()) / (x.max() - x.min()) * 255).astype(np.float32)


@pytest.fixture(scope="module")
def level_inputs():
    rng = np.random.default_rng(0)
    style = _img(rng, SH, SW, 3)
    sg = _img(rng, SH, SW, 12)
    tg = np.clip(np.roll(sg, (2, -3), (0, 1)) + rng.normal(0, 6, sg.shape), 0, 255).astype(np.float32)
    gw = np.repeat(np.array([6.0, 0.5, 0.5, 2.0], np.float32) / 3, 3)
    ws = np.full(3, 1 / 3, np.float32)
    nnf0 = np.stack([rng.integers(-4, SH + 4, (SH, SW)), rng.integers(-4, SW + 4, (SH, SW))], -1).astype(np.int32)
    return dict(src_all=np.concatenate([style, sg], -1), tg=tg, style=style, gw=gw, ws=ws, nnf0=nnf0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _run_level(inp, port: bool, *, compact=False, **kw):
    args = (inp["src_all"], inp["tg"], inp["style"], inp["gw"], inp["ws"], inp["nnf0"])
    if port:
        out = T._synthesize_level(*map(_t, args), T.TorchDraws(0), 0, compact=compact, **kw)
    else:
        out = J._synthesize_level(*map(jnp.asarray, args), jax.random.key(0),
                                  compact_tiers=(2, 4, 16) if compact else (), **kw)
    return [np.asarray(x) for x in out]


def _assert_near_tie_match(port, ref):
    """(out, err, nnf) of the port against the JAX package's."""
    (to, te, tn), (jo, je, jn) = port, ref
    diff = (tn != jn).any(-1)
    assert diff.mean() <= MAX_DIFF_FRAC, diff.mean()
    np.testing.assert_array_less(np.abs(te - je)[diff], NEAR_TIE * np.abs(je[diff]) + 1e-30)
    # pixels whose whole patch neighbourhood kept the same matches
    calm = ~ndimage.binary_dilation(diff, np.ones((5, 5), bool))
    np.testing.assert_allclose(te[calm], je[calm], rtol=1e-5, atol=0)
    np.testing.assert_allclose(to[calm], jo[calm], rtol=0, atol=1e-3)


def test_pyramid_sizes_match():
    for shape in [(48, 64, 48, 64), (512, 640, 512, 640), (37, 90, 41, 88), (11, 11, 11, 11), (600, 23, 600, 23)]:
        for patch, levels in [(5, -1), (3, -1), (5, 2)]:
            assert T._pyramid_sizes(*shape, patch, levels) == J._pyramid_sizes(*shape, patch, levels)


def test_patch_layouts_and_omega_match(level_inputs):
    x = level_inputs["src_all"][:21, :17]
    for patch in (3, 5):
        np.testing.assert_array_equal(T._target_patches(_t(x), patch).numpy(),
                                      np.asarray(J._target_patches(jnp.asarray(x), patch)))
        np.testing.assert_array_equal(T._flat_patches(_t(x), patch).float().numpy(),
                                      np.asarray(J._flat_patches(jnp.asarray(x), patch)).astype(np.float32))
        nnf = level_inputs["nnf0"]
        np.testing.assert_array_equal(
            T._omega(_t(nnf[..., 0]), _t(nnf[..., 1]), SH, SW, patch).numpy(),
            np.asarray(J._omega(jnp.asarray(nnf[..., 0]), jnp.asarray(nnf[..., 1]), SH, SW, patch)))
    with pytest.raises(NotImplementedError):
        T._flat_patches(_t(x), 5, torch.uint8)


@pytest.mark.parametrize("dtype,w,k", [
    pytest.param(np.float32, 75, 517, id="float32"),
    pytest.param(jnp.bfloat16, 75, 517, id="bfloat16"),
    # the widths and counts the card kernel splits on: one-word and
    # 76-word rows, no row and a single row
    pytest.param(np.float32, 1, 517, id="float32-w1"),
    pytest.param(np.float32, 76, 517, id="float32-w76"),
    pytest.param(jnp.bfloat16, 76, 517, id="bfloat16-w76"),
    pytest.param(np.float32, 75, 0, id="float32-k0"),
    pytest.param(np.float32, 75, 1, id="float32-k1")])
def test_gather_rows_equals_take(dtype, w, k):
    rng = np.random.default_rng(1)
    table = jnp.asarray(rng.uniform(0, 255, (300, w)).astype(np.float32)).astype(dtype)
    idx = rng.integers(0, 300, k).astype(np.int32)
    ref = np.asarray(jnp.take(table, jnp.asarray(idx), axis=0).astype(jnp.float32))
    tt = _t(table.astype(jnp.float32))
    if dtype == jnp.bfloat16:
        tt = tt.to(torch.bfloat16)
    out = gather_rows(tt, _t(idx))
    assert out.shape == (k, w)
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_plain_patch_eval_equals_eval_cand(level_inputs):
    """pm_iters=0: JAX's level clamps the (out-of-range) initial NNF and
    returns eval_cand there against the voted style; the port's plain
    evaluation of the same NNF must agree to 1e-6 relative."""
    kw = dict(patch=5, pm_iters=0, sv_iters=1, uniformity=3500.0, rand_candidates=0)
    jn, jo, je = _run_level(level_inputs, False, **kw)
    inp = level_inputs
    src = _t(inp["src_all"]).to(torch.bfloat16)
    tgt = torch.cat([_t(jo), _t(inp["tg"])], -1).to(torch.bfloat16)
    w = torch.cat([_t(inp["ws"]), _t(inp["gw"])])
    nnf = _t(jn)
    omega_best = 25.0
    om = ((3500.0 / omega_best) * T._omega(nnf[..., 0], nnf[..., 1], SH, SW, 5)).to(torch.bfloat16)
    _, e = patch_eval_plain(src, tgt, w, om, nnf, None, patch=5)
    np.testing.assert_allclose(e.numpy(), je, rtol=1e-6, atol=0)
    tn, to, te = _run_level(level_inputs, True, **kw)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-3)
    np.testing.assert_allclose(te, je, rtol=1e-6, atol=0)


@pytest.mark.parametrize("compact", [False, True])
def test_whole_level_matches_jax(level_inputs, compact):
    """rand_candidates=0 at an unseeded level: deterministic given the
    initial NNF; the stop threshold freezes pixels from the 3rd iteration."""
    kw = dict(patch=5, pm_iters=2, sv_iters=4, uniformity=3500.0, rand_candidates=0,
              stop_threshold=5.0, seeded=0)
    jn, jo, je = _run_level(level_inputs, False, compact=compact, **kw)
    tn, to, te, counts = _run_level(level_inputs, True, compact=compact, debug_counts=True, **kw)
    assert min(c for c in counts if c >= 0) < SH * SW  # the freeze took effect
    _assert_near_tie_match((to, te, tn), (jo, je, jn))


@pytest.fixture(scope="module")
def periodic_inputs():
    """A source whose style and guides repeat every 8 pixels, so many
    candidate patches are bit-identical, and a target whose guides are the
    source's shifted by (3, 5).  Values are integers in [0, 64) and the
    guide weights powers of two, the style weighted 0: every error is then
    exact in float32 whatever the summation order, so a tie is a tie in
    both packages (XLA sums the current match's error and the candidates'
    in separately fused reductions)."""
    rng = np.random.default_rng(4)
    period = rng.integers(0, 64, (8, 8, 15)).astype(np.float32)
    src_all = np.tile(period, (SH // 8, SW // 8, 1))
    tg = np.roll(src_all[..., 3:], (3, 5), (0, 1)).copy()
    gw = np.repeat(np.array([1.0, 0.5, 0.25, 0.125], np.float32), 3)
    ws = np.zeros(3, np.float32)
    nnf0 = np.stack([rng.integers(-4, SH + 4, (SH, SW)), rng.integers(-4, SW + 4, (SH, SW))], -1).astype(np.int32)
    return dict(src_all=src_all, tg=tg, style=src_all[..., :3].copy(), gw=gw, ws=ws, nnf0=nnf0)


@pytest.mark.parametrize("compact", [False, True])
def test_exact_ties_keep_the_earlier_candidate(periodic_inputs, compact):
    """rand_candidates=0, no uniformity term and no freeze: every tie
    between two candidates is exact (identical patches) and both packages
    keep the earlier candidate, so the NNF is bit-equal to the JAX
    level's."""
    kw = dict(patch=5, pm_iters=2, sv_iters=3, uniformity=0.0, rand_candidates=0, stop_threshold=0.0, seeded=0)
    jn, jo, je = _run_level(periodic_inputs, False, compact=compact, **kw)
    tn, to, te = _run_level(periodic_inputs, True, compact=compact, **kw)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-3)


def test_active_set_tiles_match_a_direct_reckoning():
    """The compacted path's tile list on a mask whose edges no tile
    divides: row-major indices of the TILE x TILE tiles holding an active
    pixel, the ragged last row and column included."""
    rng = np.random.default_rng(3)
    h, w = 37, 45
    mask = rng.random((h, w)) > 0.97
    mask[h - 1, w - 1] = True
    ny, nx = -(-h // TILE), -(-w // TILE)
    want = [ty * nx + tx for ty in range(ny) for tx in range(nx)
            if mask[ty * TILE:(ty + 1) * TILE, tx * TILE:(tx + 1) * TILE].any()]
    act = active_set(_t(mask))
    assert act.tiles.dtype == torch.int32 and act.tiles.tolist() == want
    assert torch.equal(act.mask, _t(mask))
    assert active_set(_t(mask), compact=False).tiles is None


class JaxDraws:
    """The JAX package's random draws (patchmatch.py:376-389, 609-618,
    643) in the port's draws interface."""

    def __init__(self, n_levels: int, extra_pass: bool, seed: int = 0):
        rng = jax.random.key(seed)
        self.k_init, self.k_run = [], []
        for _ in range(n_levels):
            rng, k_init, k_run = jax.random.split(rng, 3)
            self.k_init.append(k_init)
            self.k_run.append(k_run)
        if extra_pass:
            rng, k_extra = jax.random.split(rng)
            self.k_run.append(k_extra)

    def init_nnf(self, level, th, tw, sh, sw, r):
        k = self.k_init[level]
        y = jax.random.randint(k, (th, tw), r, sh - r)
        x = jax.random.randint(jax.random.fold_in(k, 1), (th, tw), r, sw - r)
        return torch.from_numpy(np.stack([np.asarray(y), np.asarray(x)], -1).astype(np.int32))

    def deltas(self, level, it, it2, radii, th, tw):
        rng2 = jax.random.fold_in(self.k_run[level], it)
        keys = jax.random.split(jax.random.fold_in(rng2, it2), len(radii))
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.randint(keys[j], (th, tw, 2), -rad, rad + 1))
            for j, rad in enumerate(radii)]).astype(np.int32))


def _synth_inputs():
    rng = np.random.default_rng(2)
    style = _img(rng, SH, SW, 3)
    sg = _img(rng, SH, SW, 12)
    tg = np.clip(np.roll(sg, (1, 2), (0, 1)) + rng.normal(0, 4, sg.shape), 0, 255).astype(np.float32)
    gw = np.repeat(np.array([6.0, 0.5, 0.5, 2.0], np.float32) / 3, 3)
    return style, sg, tg, gw


def test_synthesize_matches_jax_with_its_draws():
    cfg_kw = dict(pm_iters=2, sv_iters=3, extra_pass_3x3=True)
    args = _synth_inputs()
    jo, je, jn = (np.asarray(x) for x in J.synthesize(*map(jnp.asarray, args), J.PatchMatchConfig(**cfg_kw),
                                                       rng=jax.random.key(0)))
    n_levels = len(T._pyramid_sizes(SH, SW, SH, SW, 5, -1))
    to, te, tn = (x.numpy() for x in T.synthesize(*map(_t, args), T.PatchMatchConfig(**cfg_kw),
                                                   draws=JaxDraws(n_levels, True)))
    assert to.shape == (SH, SW, 3) and te.shape == (SH, SW) and tn.shape == (SH, SW, 2)
    _assert_near_tie_match((to, te, tn), (jo, je, jn))


def test_full_and_compacted_paths_agree_exactly():
    args = [_t(a) for a in _synth_inputs()]
    outs = [T.synthesize(*args, T.PatchMatchConfig(pm_iters=2, sv_iters=4, compact_tiers=tiers),
                         draws=T.TorchDraws(5))
            for tiers in ((), (2, 4, 16))]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_unported_options_raise():
    args = [_t(a) for a in _synth_inputs()]
    with pytest.raises(NotImplementedError, match="uint8"):
        T.synthesize(*args, T.PatchMatchConfig(table_dtype="uint8"))
