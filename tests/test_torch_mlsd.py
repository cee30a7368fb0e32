"""The port's M-LSD against fresco_tpu's on the CPU, float32.

A synthetic ``mlsd_large_512_fp32.pth`` in the reference's torch layout
(Conv + BatchNorm pairs, their ``num_batches_tracked``, the expand-1
block's own indices; its own generator here) goes through the JAX
converter and through the port's.  Tolerances:

  * the folded weights: bit for bit (both fold in float64), and
    ``from_jax_params`` of the JAX tree equals the port's conversion;
  * the network at 64x64, relative to the output's largest magnitude:
    1e-5 (measured 2.1e-7);
  * the host side, bit for bit on the same network output (a stub model
    hands both packages one array): ``decode_center_displacement`` (a tie
    case included), ``pred_lines`` and ``mlsd_detector``'s line map;
    ``draw_line`` against ``cv2.line`` over 3,000 seeded segments, some
    leaving the image and some of zero length; the INTER_AREA resize
    against ``cv2.resize`` at the scales MLSD meets (same size,
    512x640 -> 512x512, upscales by an integer and a fractional factor).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.models import mlsd as tm
from fresco_torch.models.convert import from_jax_params, load_into
from fresco_torch.ops.image import _resize_area
from fresco_torch.pipeline import runner
from fresco_tpu.models import mlsd as jm
from test_torch_convert import assert_same_state_dict

_IR = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1))


def mlsd_checkpoint(seed: int) -> dict:
    """MobileV2_MLSD_Large's state dict: the backbone's convolutions
    without bias, the FPN blocks' with, every BatchNorm with running
    statistics near identity."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    def conv(name, o, i, k, bias):
        sd[f"{name}.weight"] = t((o, i, k, k), (2.0 / (i * k * k)) ** 0.5)
        if bias:
            sd[f"{name}.bias"] = t((o,), 0.05)

    def bn(name, c):
        sd[f"{name}.weight"] = torch.from_numpy(rng.uniform(0.5, 1.0, c).astype(np.float32))
        sd[f"{name}.bias"] = t((c,), 0.1)
        sd[f"{name}.running_mean"] = t((c,), 0.1)
        sd[f"{name}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    bb = "backbone.features"
    conv(f"{bb}.0.0", 32, 4, 3, False)
    bn(f"{bb}.0.1", 32)
    idx, cin = 1, 32
    for e, c, n, _ in _IR:
        for _ in range(n):
            base, hid = f"{bb}.{idx}.conv", cin * e
            if e == 1:  # dw (conv, bn), then pw conv and its bn
                conv(f"{base}.0.0", hid, 1, 3, False)
                bn(f"{base}.0.1", hid)
                conv(f"{base}.1", c, hid, 1, False)
                bn(f"{base}.2", c)
            else:  # expand, dw, pw, bn
                conv(f"{base}.0.0", hid, cin, 1, False)
                bn(f"{base}.0.1", hid)
                conv(f"{base}.1.0", hid, 1, 3, False)
                bn(f"{base}.1.1", hid)
                conv(f"{base}.2", c, hid, 1, False)
                bn(f"{base}.3", c)
            idx, cin = idx + 1, c
    for blk, (in_a, in_b) in zip((15, 17, 19, 21), ((64, 96), (32, 64), (24, 64), (16, 64))):
        for cv, cin_, k in (("conv1", in_b, 1), ("conv2", in_a, 1)):
            conv(f"block{blk}.{cv}.0", 64, cin_, k, True)
            bn(f"block{blk}.{cv}.1", 64)
    for blk in (16, 18, 20, 22):
        for cv, o in (("conv1", 128), ("conv2", 64)):
            conv(f"block{blk}.{cv}.0", o, 128, 3, True)
            bn(f"block{blk}.{cv}.1", o)
    for cv in ("conv1", "conv2"):
        conv(f"block23.{cv}.0", 64, 64, 3, True)
        bn(f"block23.{cv}.1", 64)
    conv("block23.conv3", 16, 64, 1, True)
    # centre logits near 0 and displacements of ~15 decode cells, so that lines pass both thresholds
    sd["block23.conv3.bias"][7:12] = torch.tensor([0.0, -8.0, -8.0, 8.0, 8.0])
    return sd


@pytest.fixture(scope="module")
def pair():
    sd = mlsd_checkpoint(0)
    params = {"params": jm.convert_mlsd({k: v.numpy() for k, v in sd.items()})}
    model = tm.MLSDLarge().eval()
    load_into(model, tm.convert_mlsd(sd, strict=True))
    return sd, params, model


def test_fold_and_from_jax_params_are_bit_equal(pair):
    sd, params, model = pair
    assert_same_state_dict(from_jax_params(params), dict(model.state_dict()))
    w, b = tm.fold_bn(sd["block16.conv1.0.weight"], sd, "block16.conv1.1", sd["block16.conv1.0.bias"])
    assert w.dtype == torch.float32 and torch.equal(w, model.block16.conv1.conv.weight)
    with pytest.raises(ValueError, match="stray"):
        tm.convert_mlsd({**sd, "stray.weight": torch.zeros(1)}, strict=True)


def test_mlsd_forward_matches_jax(pair):
    _, params, model = pair
    x = np.random.default_rng(1).uniform(-1, 1, (1, 64, 64, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.MLSDLarge().apply)(params, jnp.asarray(x)))
    out = model(torch.from_numpy(x)).numpy()
    assert out.shape == (1, 32, 32, 9)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_decode_matches_jax_with_ties():
    rng = np.random.default_rng(2)
    out = rng.normal(0, 2, (1, 24, 20, 9)).astype(np.float32)
    out[0, 4:10, 3:9, 0] = 1.5  # a plateau: every cell its own NMS maximum, all tied
    out[0, 15, 5, 0] = out[0, 15, 12, 0] = out[0, 2, 17, 0] = 3.0  # tied isolated peaks
    js, jyx, jd = (np.asarray(a) for a in jm.decode_center_displacement(jnp.asarray(out), 200, 3))
    ts, tyx, td = (a.numpy() for a in tm.decode_center_displacement(torch.from_numpy(out), 200, 3))
    np.testing.assert_array_equal(tyx, jyx)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)


class _FixedOut(torch.nn.Module):
    """A stub network: records its input and returns ``out``."""

    def __init__(self, out):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
        self.out, self.seen = out, None

    def forward(self, x):
        self.seen = x
        return torch.from_numpy(self.out)

    def apply(self, params, x):
        self.seen = x
        return jnp.asarray(self.out)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)], ids=["same", "up_and_down"])
def test_pred_lines_and_detector_match_jax_bit_for_bit(pair, hw):
    pytest.importorskip("cv2")
    _, params, model = pair
    img = np.random.default_rng(3).integers(0, 256, (*hw, 3)).astype(np.uint8)
    x = np.random.default_rng(4).uniform(-1, 1, (1, 64, 64, 4)).astype(np.float32)
    out = model(torch.from_numpy(x)).numpy()  # a network output with lines in it
    j, t = _FixedOut(out), _FixedOut(out)
    jl = jm.pred_lines(img, j, None, input_shape=(64, 64))
    tl = tm.pred_lines(img, t, input_shape=(64, 64))
    np.testing.assert_array_equal(t.seen.numpy(), np.asarray(j.seen))  # the resized, scaled input
    assert len(jl) > 20
    np.testing.assert_array_equal(tl, jl)
    jmap = jm.mlsd_detector(j, None, img, input_shape=(64, 64))
    tmap = tm.mlsd_detector(t, img, input_shape=(64, 64))
    assert tmap.dtype == np.uint8 and tmap.shape == hw and tmap.any()
    np.testing.assert_array_equal(tmap, jmap)
    # and the real network end to end: lines within rounding of the JAX detector's
    jitted = types.SimpleNamespace(apply=jax.jit(jm.MLSDLarge().apply))  # eager Flax is slow
    jl = jm.pred_lines(img, jitted, params, input_shape=(64, 64))
    tl = tm.pred_lines(img, model, input_shape=(64, 64))
    assert len(tl) == len(jl) > 0
    np.testing.assert_allclose(tl, jl, atol=1e-3)


def test_draw_line_equals_cv2_line():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    h, w = 48, 64
    for n in range(3000):
        kind = n % 4
        if kind == 0:  # inside
            p = rng.integers(0, [w, h, w, h])
        elif kind == 1:  # end points up to 80 px outside
            p = rng.integers(-80, [w + 80, h + 80, w + 80, h + 80])
        elif kind == 2:  # zero length
            p = np.tile(rng.integers(-3, [w + 3, h + 3]), 2)
        else:  # short, near the border
            a = rng.integers(-20, [w + 20, h + 20])
            p = np.r_[a, a + rng.integers(-3, 4, 2)]
        p0, p1 = (int(p[0]), int(p[1])), (int(p[2]), int(p[3]))
        want, got = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        cv2.line(want, p0, p1, 255, 1)
        tm.draw_line(got, p0, p1)
        assert np.array_equal(got, want), (p0, p1)


@pytest.mark.parametrize("src,dst", [((512, 512), (512, 512)), ((512, 640), (512, 512)),
                                     ((64, 64), (512, 512)), ((320, 448), (512, 512)), ((48, 80), (64, 64))])
def test_resize_area_equals_opencv(src, dst):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(6).integers(0, 256, (*src, 3)).astype(np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(_resize_area(img, *dst), want)


def test_build_detector_loads_the_checkpoint(tmp_path, pair, capsys):
    from fresco_torch.core.config import FrescoConfig

    sd, _, model = pair
    cfg = FrescoConfig(controlnet_type="mlsd", gmflow_path=str(tmp_path / "gmflow_sintel-0c07dcb3.pth"))
    gen = torch.Generator().manual_seed(0)
    det = runner._build_detector(cfg, False, torch.device("cpu"), gen, False)
    assert getattr(det, "func", det) is not tm.mlsd_detector
    assert "MLSD weights not found" in capsys.readouterr().out
    assert runner._build_detector(cfg, False, torch.device("cpu"), gen, True).func is tm.mlsd_detector
    torch.save(sd, str(tmp_path / tm.CHECKPOINT))
    det = runner._build_detector(cfg, False, torch.device("cpu"), gen, False)
    assert det.func is tm.mlsd_detector
    assert_same_state_dict(dict(det.args[0].state_dict()), dict(model.state_dict()))
