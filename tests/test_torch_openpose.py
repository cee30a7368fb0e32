"""The port's OpenPose body and hand networks against fresco_tpu's on the
CPU, float32, full width.

Synthetic checkpoints from a seeded generator (kernels N(0, 2 / fan_in),
small biases), written in the layout the JAX package's ``convert_openpose``
reads (``model0.conv1_1.weight``) and in the released files' flat one
(``conv1_1.weight``).  Tolerances:

  * the networks at 64x64, relative to each output's largest magnitude:
    3e-5 (measured 3.3e-6); ``from_jax_params`` of the JAX trees equals
    the port's conversion, bit for bit, and both layouts convert alike;
  * the host side, bit for bit: ``_find_peaks`` and ``body_decode`` on the
    same maps (a synthetic skeleton of two people, and noise), and
    ``draw_bodypose``; ``openpose_detector`` on one network output handed
    to both packages by a stub (its resizes and drawing are OpenCV's in
    both).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.models import openpose as tm
from fresco_torch.models.convert import from_jax_params, load_into
from fresco_torch.pipeline import runner
from fresco_tpu.models import openpose as jm
from test_torch_convert import assert_same_state_dict


def pose_checkpoint(cls, seed: int, flat: bool = False) -> dict:
    """Every convolution of ``cls`` (BodyPose / HandPose) with seeded
    weights, keyed by stack and layer, or (``flat``) by layer alone."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in cls().state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        std = (2.0 / np.prod(shape[1:])) ** 0.5 if len(shape) == 4 else 0.05
        sd[k.split(".", 1)[1] if flat else k] = torch.from_numpy(
            (rng.standard_normal(shape) * std).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def body():
    sd = pose_checkpoint(tm.BodyPose, 0)
    params = {"params": jm.convert_openpose({k: v.numpy() for k, v in sd.items()})}
    model = tm.BodyPose().eval()
    load_into(model, tm.convert_openpose(sd, strict=True))
    return sd, params, model


def _close(out, ref):
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 3e-5 * np.abs(ref).max()


def test_body_forward_matches_jax(body):
    sd, params, model = body
    x = np.random.default_rng(1).uniform(-0.5, 0.5, (1, 64, 64, 3)).astype(np.float32)
    jpaf, jheat = jax.jit(jm.BodyPose().apply)(params, jnp.asarray(x))
    paf, heat = model(torch.from_numpy(x))
    _close(paf.numpy(), np.asarray(jpaf))
    _close(heat.numpy(), np.asarray(jheat))
    assert paf.shape == (1, 8, 8, 38) and heat.shape == (1, 8, 8, 19)
    assert_same_state_dict(from_jax_params(params), dict(model.state_dict()))
    flat = pose_checkpoint(tm.BodyPose, 0, flat=True)
    assert "conv1_1.weight" in flat and "Mconv7_stage6_L2.bias" in flat
    assert_same_state_dict(tm.convert_openpose(flat, strict=True), dict(model.state_dict()))


def test_hand_forward_matches_jax():
    sd = pose_checkpoint(tm.HandPose, 1)
    params = {"params": jm.convert_openpose({k: v.numpy() for k, v in sd.items()}, hand=True)}
    model = tm.HandPose().eval()
    load_into(model, tm.convert_openpose(sd, hand=True, strict=True))
    x = np.random.default_rng(2).uniform(-0.5, 0.5, (1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.HandPose().apply)(params, jnp.asarray(x)))
    _close(model(torch.from_numpy(x)).numpy(), ref)
    assert_same_state_dict(from_jax_params(params), dict(model.state_dict()))


def skeleton_maps(h: int = 96, w: int = 112, seed: int = 3):
    """Heatmaps and PAFs of two people (every part a Gaussian blob, every
    limb's PAF along its direction near the limb) plus noise."""
    rng = np.random.default_rng(seed)
    heat = rng.uniform(0, 0.05, (h, w, 19)).astype(np.float32)
    paf = rng.normal(0, 0.02, (h, w, 38)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for ox in (8, 60):
        parts = {p: np.array([ox + 2 * (p % 6) + (p // 6) * 3, 8 + 4.5 * p]) for p in range(18)}
        for p, (x, y) in parts.items():
            heat[:, :, p] += np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 6.0)
        for k, (a, b) in enumerate(jm._LIMB_SEQ):
            v = parts[b] - parts[a]
            u = v / max(np.linalg.norm(v), 1e-3)
            t = np.clip(((xx - parts[a][0]) * v[0] + (yy - parts[a][1]) * v[1]) / max(v @ v, 1e-3), 0, 1)
            near = np.hypot(xx - parts[a][0] - t * v[0], yy - parts[a][1] - t * v[1]) < 3
            paf[near, jm._PAF_IDX[k][0]] = u[0]
            paf[near, jm._PAF_IDX[k][1]] = u[1]
    return heat, paf


@pytest.mark.parametrize("case", ["skeletons", "noise"])
def test_body_decode_and_drawing_bit_for_bit(case):
    pytest.importorskip("scipy")
    if case == "skeletons":
        heat, paf = skeleton_maps()
    else:
        rng = np.random.default_rng(4)
        heat, paf = rng.uniform(0, 0.6, (64, 80, 19)), rng.normal(0, 0.5, (64, 80, 38))
    for a, b in zip(tm._find_peaks(heat, 0.1), jm._find_peaks(heat, 0.1)):
        np.testing.assert_array_equal(a, b)
    tc, ts = tm.body_decode(heat, paf, heat.shape[0])
    jc, js = jm.body_decode(heat, paf, heat.shape[0])
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    if case == "skeletons":
        assert len(ts) == 2 and (ts[:, -1] == 18).all()
    cv2 = pytest.importorskip("cv2")  # noqa: F841
    canvas = np.zeros((*heat.shape[:2], 3), np.uint8)
    got = tm.draw_bodypose(canvas.copy(), tc, ts)
    np.testing.assert_array_equal(got, jm.draw_bodypose(canvas.copy(), jc, js))
    assert (got.any() if len(ts) else not got.any())


class _FixedOut(torch.nn.Module):
    """A stub network: records its input and returns (paf, heat)."""

    def __init__(self, paf, heat):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
        self.maps, self.seen = (paf, heat), None

    def forward(self, x):
        self.seen = x
        return tuple(torch.from_numpy(m) for m in self.maps)

    def apply(self, params, x):
        self.seen = x
        return tuple(jnp.asarray(m) for m in self.maps)


def test_openpose_detector_matches_jax_bit_for_bit(body):
    """A 64x80 frame runs at 184x230, edge-padded to 184x232: maps 23x29."""
    pytest.importorskip("cv2")
    _, params, model = body
    heat, paf = skeleton_maps(23, 29, seed=5)
    heat, paf = heat[None], paf[None]
    img = np.random.default_rng(6).integers(0, 256, (64, 80, 3)).astype(np.uint8)
    j, t = _FixedOut(paf, heat), _FixedOut(paf, heat)
    want = jm.openpose_detector(j, None, img)
    got = tm.openpose_detector(t, img)
    np.testing.assert_array_equal(t.seen.numpy(), np.asarray(j.seen))
    assert got.shape == img.shape and got.any()
    np.testing.assert_array_equal(got, want)
    # the real network: the maps within rounding of the JAX detector's network
    jitted = types.SimpleNamespace(apply=jax.jit(jm.BodyPose().apply))
    x = np.array(j.seen)
    jpaf, jheat = jitted.apply(params, jnp.asarray(x))
    paf_t, heat_t = model(torch.from_numpy(x))
    _close(paf_t.numpy(), np.asarray(jpaf))
    _close(heat_t.numpy(), np.asarray(jheat))


def test_build_detector_needs_cv2_and_loads_the_checkpoint(tmp_path, body, monkeypatch, capsys):
    from fresco_torch.core.config import FrescoConfig

    sd, _, model = body
    cfg = FrescoConfig(controlnet_type="openpose", gmflow_path=str(tmp_path / "gmflow_sintel-0c07dcb3.pth"))
    gen = torch.Generator().manual_seed(0)
    det = runner._build_detector(cfg, False, torch.device("cpu"), gen, False)
    assert getattr(det, "func", det) is not tm.openpose_detector
    assert "OpenPose weights not found" in capsys.readouterr().out
    torch.save(sd, str(tmp_path / tm.CHECKPOINT))
    with monkeypatch.context() as m:
        m.setattr(runner, "_have_cv2", lambda: False)
        with pytest.raises(ImportError, match="cv2"):  # at build time, not at the first frame
            runner._build_detector(cfg, False, torch.device("cpu"), gen, False)
    if not runner._have_cv2():
        return
    det = runner._build_detector(cfg.replace(controlnet_type="pose"), False, torch.device("cpu"), gen, False)
    assert det.func is tm.openpose_detector
    assert_same_state_dict(dict(det.args[0].state_dict()), dict(model.state_dict()))
