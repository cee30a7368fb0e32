"""The port's MiDaS DPT-hybrid against fresco_tpu's on the CPU, float32.

A synthetic checkpoint in the timm layout of ``dpt_hybrid-midas-501f0c75.pt``
(its own generator here, parametrised by a tiny config's widths and depths,
refinenet4's unused ``resConfUnit1`` included) goes through the JAX
converter and forward and through the port's.  Tolerances:

  * the depth map, relative to its largest value: 5e-5 (measured 6.7e-6);
  * ``from_jax_params`` of the JAX tree equals the port's own conversion,
    bit for bit;
  * ``midas_detector``: the uint8 depth and normal images within 1 level of
    the JAX detector's (which resizes with OpenCV), with at most 1 % of
    the pixels 1 level apart (measured: 1 depth pixel of 6,300 at 70x90,
    the normal image equal); the linear resize it uses equals
    ``cv2.resize(INTER_LINEAR)`` bit for bit on the padded depth map with
    OpenCV's Intel IPP path off (IPP weighs a float32 resize its own way:
    up to 1.7e-4 apart on values up to 40, which the detector's
    comparison above absorbs).
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.models import midas as tm
from fresco_torch.models.convert import from_jax_params, load_into
from fresco_torch.pipeline import runner
from fresco_tpu.models import midas as jm
from test_torch_convert import assert_same_state_dict

TINY = dict(vit_dim=32, vit_depth=3, hooks=(1, 2), features=16, grid_size_train=4,
            stem_widths=(32, 64, 128), stem_depths=(1, 2, 1))


def timm_checkpoint(seed: int, vit_dim=32, vit_depth=3, features=16, grid=4, widths=(32, 64, 128),
                    depths=(1, 2, 1)) -> dict:
    """A timm-layout DPT-hybrid state dict: convolution kernels N(0, 1 /
    fan_in), norm scales in [0.5, 1], small biases."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    def conv(name, o, i, k, bias=True):
        sd[f"{name}.weight"] = t((o, i, k, k), (1.0 / (i * k * k)) ** 0.5)
        if bias:
            sd[f"{name}.bias"] = t((o,), 0.05)

    def norm(name, c):
        sd[f"{name}.weight"] = torch.from_numpy(rng.uniform(0.5, 1.0, c).astype(np.float32))
        sd[f"{name}.bias"] = t((c,), 0.05)

    def dense(name, o, i):
        sd[f"{name}.weight"] = t((o, i), (1.0 / i) ** 0.5)
        sd[f"{name}.bias"] = t((o,), 0.05)

    p = "pretrained.model."
    bb = f"{p}patch_embed.backbone."
    conv(f"{bb}stem.conv", 64, 3, 7, bias=False)
    norm(f"{bb}stem.norm", 64)
    cin = 64
    for si, (w, dep) in enumerate(zip(widths, depths)):
        for bi in range(dep):
            s = f"{bb}stages.{si}.blocks.{bi}"
            norm(f"{s}.norm1", cin)
            conv(f"{s}.conv1", w // 4, cin, 1, bias=False)
            norm(f"{s}.norm2", w // 4)
            conv(f"{s}.conv2", w // 4, w // 4, 3, bias=False)
            norm(f"{s}.norm3", w // 4)
            conv(f"{s}.conv3", w, w // 4, 1, bias=False)
            if bi == 0:
                conv(f"{s}.downsample.conv", w, cin, 1, bias=False)
            cin = w
    conv(f"{p}patch_embed.proj", vit_dim, widths[-1], 1)
    sd[f"{p}cls_token"] = t((1, 1, vit_dim), 0.5)
    sd[f"{p}pos_embed"] = t((1, grid * grid + 1, vit_dim), 0.5)
    for i in range(vit_depth):
        s = f"{p}blocks.{i}"
        norm(f"{s}.norm1", vit_dim)
        dense(f"{s}.attn.qkv", 3 * vit_dim, vit_dim)
        dense(f"{s}.attn.proj", vit_dim, vit_dim)
        norm(f"{s}.norm2", vit_dim)
        dense(f"{s}.mlp.fc1", 4 * vit_dim, vit_dim)
        dense(f"{s}.mlp.fc2", vit_dim, 4 * vit_dim)
    norm(f"{p}norm", vit_dim)
    for a in ("3", "4"):
        dense(f"pretrained.act_postprocess{a}.0.project.0", vit_dim, 2 * vit_dim)
        conv(f"pretrained.act_postprocess{a}.3", vit_dim, vit_dim, 1)
    conv("pretrained.act_postprocess4.4", vit_dim, vit_dim, 3)
    for i, c in zip(range(1, 5), (widths[0], widths[1], vit_dim, vit_dim)):
        conv(f"scratch.layer{i}_rn", features, c, 3, bias=False)
    for i in range(1, 5):
        s = f"scratch.refinenet{i}"
        for unit in ("resConfUnit1", "resConfUnit2"):  # refinenet4's resConfUnit1 is in the file, unused
            conv(f"{s}.{unit}.conv1", features, features, 3)
            conv(f"{s}.{unit}.conv2", features, features, 3)
        conv(f"{s}.out_conv", features, features, 1)
    conv("scratch.output_conv.0", features // 2, features, 3)
    conv("scratch.output_conv.2", 32, features // 2, 3)
    conv("scratch.output_conv.4", 1, 32, 1)
    # the head's last bias lifts the output above the final ReLU
    sd["scratch.output_conv.4.bias"] = torch.full((1,), 0.5)
    return sd


@pytest.fixture(scope="module")
def pair():
    """(checkpoint, JAX model, JAX params, port model) at the tiny config."""
    sd = timm_checkpoint(0)
    jmodel = jm.DPTHybridDepth(**TINY)
    params = {"params": jm.convert_dpt_hybrid({k: v.numpy() for k, v in sd.items()},
                                              stem_depths=TINY["stem_depths"], vit_depth=TINY["vit_depth"])}
    model = tm.DPTHybridDepth(**TINY).eval()
    load_into(model, tm.convert_dpt_hybrid(sd, strict=True, model=model))
    return sd, jmodel, params, model


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 90 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    img = np.stack([base, np.roll(base, 5, 1), 255 - base], -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_dpt_forward_matches_jax(pair):
    """At 64x96 the 4x4 training grid of positions is resized to 4x6."""
    _, jmodel, params, model = pair
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    out = model(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 64, 96) and out.min() >= 0.0
    assert np.abs(out - ref).max() <= 5e-5 * np.abs(ref).max()
    assert ref.max() > 0  # the ReLU'd head is not all zero


def test_from_jax_params_equals_the_checkpoint_conversion(pair):
    _, _, params, model = pair
    got = from_jax_params(params)
    assert_same_state_dict(got, dict(model.state_dict()))


def test_strict_conversion_names_a_stray_key(pair):
    sd, _, _, model = pair
    with pytest.raises(ValueError, match="stray"):
        tm.convert_dpt_hybrid({**sd, "pretrained.model.stray.weight": torch.zeros(1)}, strict=True, model=model)
    with pytest.raises(KeyError):
        tm.convert_dpt_hybrid({k: v for k, v in sd.items() if "blocks.1.attn" not in k}, model=model)


@pytest.mark.parametrize("hw", [(64, 96), (70, 90)], ids=["aligned", "padded"])
def test_midas_detector_matches_jax(pair, hw):
    """(70, 90) pads to 96x96, whose whole depth map is resized to 70x90."""
    cv2 = pytest.importorskip("cv2")
    _, jmodel, params, model = pair
    img = _image(2, *hw)
    # the JAX detector calls model.apply; hand it the jitted one (eager Flax is slow)
    jd, jn = jm.midas_detector(types.SimpleNamespace(apply=jax.jit(jmodel.apply)), params, img)
    td, tn = tm.midas_detector(model, img)
    for got, want in ((td, jd), (tn, jn)):
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    assert 0 < (td == 0).mean() < 1 and td.max() == 255
    np.testing.assert_array_equal(tm.depth_detector(model, img), td)
    # the resize alone, on the padded depth map, bit for bit
    H, W = -(-hw[0] // 32) * 32, -(-hw[1] // 32) * 32
    depth = np.random.default_rng(3).uniform(0, 40, (H, W)).astype(np.float32)
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        want = cv2.resize(depth, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
    finally:
        cv2.ipp.setUseIPP(ipp)
    got = tm._resize_linear(torch.from_numpy(depth)[..., None], *hw)[..., 0].numpy()
    np.testing.assert_array_equal(got, want)


def test_build_detector_loads_the_checkpoint(tmp_path, pair, monkeypatch, capsys):
    from fresco_torch.core.config import FrescoConfig

    sd, _, _, model = pair
    monkeypatch.setattr(tm, "DPTHybridDepth", functools.partial(tm.DPTHybridDepth, **TINY))
    cfg = FrescoConfig(controlnet_type="depth", gmflow_path=str(tmp_path / "gmflow_sintel-0c07dcb3.pth"))
    gen = torch.Generator().manual_seed(0)
    det = runner._build_detector(cfg, False, torch.device("cpu"), gen, False)
    assert getattr(det, "func", det) is not tm.depth_detector  # absent: canny, or none
    assert "MiDaS weights not found" in capsys.readouterr().out
    rand = runner._build_detector(cfg, False, torch.device("cpu"), gen, True)
    assert rand.func is tm.depth_detector and torch.isfinite(rand.args[0].pos_embed).all()
    torch.save(sd, str(tmp_path / tm.CHECKPOINT))
    times = {}
    det = runner._build_detector(cfg, False, torch.device("cpu"), gen, False, times)
    assert det.func is tm.depth_detector and "midas" in times
    assert_same_state_dict(dict(det.args[0].state_dict()), dict(model.state_dict()))
    img = _image(4, 64, 64)
    np.testing.assert_array_equal(det(img), tm.depth_detector(model, img))
