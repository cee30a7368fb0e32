"""fresco_torch.propagate guides, colour, blending and the in-memory
propagation stage against fresco_tpu (which uses OpenCV) on the CPU.

Tolerances:
- edge guide, positional guide, nearest warp (half-integer flows pin
  OpenCV's round-half-to-even), push-pull inpainting at odd sizes, the
  guide chains and the error mask: exact uint8 / bool equality;
- BGR->Lab: OpenCV's fixed point, exact but for ~1e-4 of colours (table
  rounding); Lab->BGR is the float formula: both within 1 level of
  ``cv2.cvtColor`` on >= 99 % of pixels and 2 at most;
- histogram blend and Poisson fusion: within 2 levels of the JAX package
  (the Lab conversions above, and float64 / float32 sums in another
  order before rounding);
- ``screened_poisson``: 1e-4 relative (float32 FFT against XLA's DCT);
- a tiny propagation (6 frames at 48x64, keys at both ends, analytic
  integer flows, keys a fixed colour transform of the frames): its
  reconstruction PSNR against the known truth within 1 dB of the JAX
  package's ``blend_video`` (the random search draws differ).
"""
import os

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from fresco_torch.propagate import color as tcolor
from fresco_torch.propagate import guides as tguides
from fresco_torch.propagate import histogram as thist
from fresco_torch.propagate import poisson as tpoisson
from fresco_torch.propagate import video_blend as tvb
from fresco_torch.propagate.patchmatch import PatchMatchConfig as TConfig
from fresco_tpu.propagate import guides as jguides
from fresco_tpu.propagate import histogram as jhist
from fresco_tpu.propagate import poisson as jpoisson
from fresco_tpu.propagate import video_blend as jvb
from fresco_tpu.propagate.patchmatch import PatchMatchConfig as JConfig

cv2 = pytest.importorskip("cv2")

LAB_MAX = 2
BLEND_MAX = 2
PSNR_DB = 1.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _smooth_u8(rng, h, w, c=3):
    x = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w, c)), (2, 2, 0))
    return ((x - x.min()) / (x.max() - x.min()) * 255).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53), (25, 31)])
def test_guides_match_opencv(h, w):
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tguides.edge_guide(_t(img)).numpy(), jguides.edge_guide(img))
    np.testing.assert_array_equal(tguides.positional_first(h, w).numpy(), jguides.positional_first(h, w))
    flow = rng.uniform(-6, 6, (h, w, 2)).astype(np.float32)
    flow[: h // 2] = np.round(flow[: h // 2] * 2) / 2  # half-integer displacements
    np.testing.assert_array_equal(tguides.warp_nearest(_t(img), _t(flow)).numpy(), jguides.warp_nearest(img, flow))
    m = rng.uniform(size=(h, w)) > 0.5
    np.testing.assert_array_equal(tguides.warp_nearest(_t(m), _t(flow)).numpy(), jguides.warp_nearest(m, flow))
    occ = (ndimage.gaussian_filter(rng.uniform(size=(h, w)), 3) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(tguides.inpaint_occluded(_t(img), _t(occ)).numpy(),
                                  jguides.inpaint_occluded(img, occ))
    flows = [rng.uniform(-3, 3, (h, w, 2)).astype(np.float32) for _ in range(3)]
    occs = [(rng.uniform(size=(h, w)) > 0.9).astype(np.float32) for _ in range(3)]
    for a, b in zip(tguides.positional_chain(h, w, [_t(f) for f in flows], [_t(o) for o in occs]),
                    jguides.positional_chain(h, w, flows, occs)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tguides.temporal_guide(_t(img), _t(flows[0]), _t(occs[0])).numpy(),
                                  jguides.temporal_guide(img, flows[0], occs[0]))
    with pytest.raises(NotImplementedError, match="telea"):
        tguides.inpaint_occluded(_t(img), _t(occ), method="telea")


def _assert_within_levels(a, b, max_diff, min_frac_le1=0.99):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    assert d.max() <= max_diff, d.max()
    assert (d <= 1).mean() >= min_frac_le1, (d <= 1).mean()


def test_lab_conversions_match_opencv():
    rng = np.random.default_rng(3)
    cube = np.stack(np.meshgrid(*[np.arange(0, 256, 3)] * 3, indexing="ij"), -1).reshape(-1, 1, 3).astype(np.uint8)
    for img in (rng.integers(0, 256, (64, 64, 3)).astype(np.uint8), cube, _smooth_u8(rng, 48, 64)):
        lab = cv2.cvtColor(img, cv2.COLOR_BGR2Lab)
        _assert_within_levels(tcolor.bgr2lab(_t(img)).numpy(), lab, LAB_MAX)
        _assert_within_levels(tcolor.lab2bgr(_t(lab)).numpy(), cv2.cvtColor(lab, cv2.COLOR_Lab2BGR), LAB_MAX)


def test_histogram_blend_and_poisson_fusion_match():
    rng = np.random.default_rng(4)
    a, b = _smooth_u8(rng, 48, 64), _smooth_u8(rng, 48, 64)
    mask = (ndimage.gaussian_filter(rng.uniform(size=(48, 64)), 2) > 0.5).astype(np.uint8)
    me = np.where(mask[..., None] == 0, a, b)
    jh = jhist.histogram_blend(a, b, me, 0.3, 0.7)
    th = thist.histogram_blend(_t(a), _t(b), _t(me), 0.3, 0.7).numpy()
    _assert_within_levels(th, jh, BLEND_MAX)
    jp = jpoisson.poisson_fusion(jh, a, b, mask)
    tp = tpoisson.poisson_fusion(_t(jh), _t(a), _t(b), _t(mask)).numpy()
    _assert_within_levels(tp, jp, BLEND_MAX)


def test_screened_poisson_matches():
    rng = np.random.default_rng(5)
    h, w = 37, 64
    bl = (rng.normal(size=(h, w, 3)) * 30).astype(np.float32)
    gx = (rng.normal(size=(h - 1, w, 3)) * 5).astype(np.float32)
    gy = (rng.normal(size=(h, w - 1, 3)) * 5).astype(np.float32)
    wt = np.array([2.5, 0.5, 0.5], np.float32)
    ref = np.asarray(jpoisson.screened_poisson(jnp.asarray(bl), jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(wt)))
    out = tpoisson.screened_poisson(_t(bl), _t(gx), _t(gy), _t(wt)).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_error_mask_matches():
    rng = np.random.default_rng(6)
    d1, d2 = rng.uniform(0, 10, (2, 20, 30)).astype(np.float32)
    d2[0, :5] = d1[0, :5]  # ties select the backward candidate
    for w1 in (0.0, 0.25, 0.5, 1.0):
        np.testing.assert_array_equal(tvb.error_mask(_t(d1), _t(d2), w1, 1 - w1).numpy(),
                                      jvb.error_mask(d1, d2, w1, 1 - w1))


N_FRAMES, H, W = 6, 48, 64
PM_KW = dict(pm_iters=3, sv_iters=4)


@pytest.fixture(scope="module")
def clip():
    """Frames: a smooth texture under integer translations (so the flows
    are exact); keys and truth: a fixed colour transform of each frame."""
    rng = np.random.default_rng(7)
    pad = 16
    tex = _smooth_u8(rng, H + 2 * pad, W + 2 * pad)
    shifts = np.cumsum(rng.integers(-2, 3, (N_FRAMES, 2)), 0)
    shifts -= shifts[0]
    frames = [np.ascontiguousarray(tex[pad - s[1]: pad - s[1] + H, pad - s[0]: pad - s[0] + W]) for s in shifts]
    truth = [np.ascontiguousarray(255 - f[..., ::-1]) for f in frames]
    index = {int(f.astype(np.int64).sum()): i for i, f in enumerate(frames)}
    assert len(index) == N_FRAMES

    def pair_flows(a, b):
        ia = [index[int(round(float(np.asarray(x, np.float64).sum())))] for x in a]
        ib = [index[int(round(float(np.asarray(x, np.float64).sum())))] for x in b]
        # frame k is frame i moved by shifts[k] - shifts[i]
        fwd = [np.broadcast_to((shifts[k] - shifts[i]).astype(np.float32), (H, W, 2)) for i, k in zip(ia, ib)]
        bwd = [np.broadcast_to((shifts[i] - shifts[k]).astype(np.float32), (H, W, 2)) for i, k in zip(ia, ib)]
        return np.stack(fwd + bwd)

    return frames, truth, pair_flows


def _psnr(out, truth, idx):
    mse = np.mean([np.mean((out[i].astype(np.float64) - truth[i]) ** 2) for i in idx])
    return 10 * np.log10(255.0 ** 2 / mse)


def test_tiny_blend_video_matches_jax_quality(clip, tmp_path):
    frames, truth, pair_flows = clip
    last = N_FRAMES - 1
    out = tvb.blend_video_frames(
        dict(enumerate(frames)), {0: truth[0], last: truth[last]}, [0, last],
        flow_fn=lambda a, b: torch.from_numpy(pair_flows(a.cpu().numpy(), b.cpu().numpy())),
        patch_cfg=TConfig(**PM_KW), device="cpu")
    assert sorted(out) == list(range(N_FRAMES))
    for i in range(N_FRAMES):
        assert out[i].shape == (H, W, 3) and out[i].dtype == np.uint8
    np.testing.assert_array_equal(out[0], truth[0])
    np.testing.assert_array_equal(out[last], truth[last])

    os.makedirs(tmp_path / "video")
    os.makedirs(tmp_path / "keys")
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / "video" / ("%04d.png" % i)), f)
    for i in (0, last):
        cv2.imwrite(str(tmp_path / "keys" / ("%04d.png" % i)), truth[i])
    blend_dir = jvb.blend_video(str(tmp_path), [0, last], flow_fn=lambda a, b: jnp.asarray(pair_flows(a, b)),
                                patch_cfg=JConfig(**PM_KW))
    ref = {i: cv2.imread(os.path.join(blend_dir, "%04d.png" % i)) for i in range(N_FRAMES)}
    inner = range(1, last)
    p_port, p_jax = _psnr(out, truth, inner), _psnr(ref, truth, inner)
    assert p_port > 20.0, p_port
    assert abs(p_port - p_jax) <= PSNR_DB, (p_port, p_jax)


def test_blend_video_file_wrapper(clip, tmp_path):
    pytest.importorskip("PIL")
    frames, truth, pair_flows = clip
    os.makedirs(tmp_path / "video")
    os.makedirs(tmp_path / "keys")
    for i in range(3):
        tvb.write_bgr(str(tmp_path / "video" / ("%04d.png" % i)), frames[i])
    for i in (0, 2):
        tvb.write_bgr(str(tmp_path / "keys" / ("%04d.png" % i)), truth[i])
    blend_dir = tvb.blend_video(
        str(tmp_path), [0, 2], flow_fn=lambda a, b: torch.from_numpy(pair_flows(a.numpy(), b.numpy())),
        patch_cfg=TConfig(pm_iters=1, sv_iters=1), device="cpu")
    got = [tvb.read_bgr(os.path.join(blend_dir, "%04d.png" % i)) for i in range(3)]
    np.testing.assert_array_equal(got[0], truth[0])
    assert got[1].shape == (H, W, 3) and got[1].dtype == np.uint8
    assert os.path.exists(tmp_path / "tmp" / "flow_f0_0.npz")


def test_entry_points_default_to_the_card():
    """Without a device argument the port runs on CUDA, or raises when no
    card is present; it never falls back to the CPU quietly."""
    from fresco_torch.core.config import FrescoConfig
    from fresco_torch.pipeline.runner import build_models, resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_models(FrescoConfig(dtype="float32"), tiny=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvb.blend_video_frames({0: np.zeros((8, 8, 3), np.uint8)}, {0: np.zeros((8, 8, 3), np.uint8)}, [0],
                               flow_fn=lambda a, b: None)
    assert resolve_device("cpu").type == "cpu"
