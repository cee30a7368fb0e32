"""The model FLOP counts of ``denoise_mfu`` against a count of the frozen
reference's own convolutions and products (torch's FlopCounterMode on the
meta device) and against a hand count of one SD 1.5 UNet pass."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import flops, stack

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "sd15_hed_music.json")
# One SD 1.5 UNet pass of one 64x64 latent (512 px), 2 x multiply-adds of
# its convolutions, dense layers and attention products: 803.27 GFLOP.
UNET_64_GFLOP = 803.27344128


@pytest.fixture(scope="module")
def spec():
    with open(CONFIG) as f:
        return json.load(f)


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return float(fc.get_total_flops())


def test_unet_hand_count(spec):
    assert flops.unet_flops(64, 64, spec["widths"]["unet"]) / 1e9 == pytest.approx(UNET_64_GFLOP, rel=1e-9)


@pytest.mark.parametrize("h, w", [(64, 64), (64, 80)])
def test_counts_match_the_reference_modules(spec, h, w):
    mods = stack._meta_modules("reference", spec)
    u, v = spec["widths"]["unet"], spec["widths"]["vae"]
    cond = spec["widths"]["controlnet"]["conditioning_embedding_out_channels"]
    lat = torch.zeros(1, h, w, 4, device="meta")
    img = torch.zeros(1, 8 * h, 8 * w, 3, device="meta")
    ctx = torch.zeros(1, 77, u["cross_attention_dim"], device="meta")
    assert _counted(lambda: mods["unet"](lat, 500, ctx)) == pytest.approx(flops.unet_flops(h, w, u), rel=1e-12)
    assert _counted(lambda: mods["controlnet"](lat, 500, ctx, img, 1.0)) == pytest.approx(
        flops.controlnet_flops(h, w, u, cond), rel=1e-12)
    assert _counted(lambda: mods["vae"].encode(img, lat)) == pytest.approx(
        flops.vae_encode_flops(8 * h, 8 * w, v), rel=1e-12)
    assert _counted(lambda: mods["vae"].decode(lat)) == pytest.approx(flops.vae_decode_flops(h, w, v), rel=1e-12)


def test_batch_count(spec):
    fr = spec["fresco"]
    steps = fr["num_inference_steps"] - fr["num_warmup_steps"]
    u, v = spec["widths"]["unet"], spec["widths"]["vae"]
    cond = spec["widths"]["controlnet"]["conditioning_embedding_out_channels"]
    per = flops.unet_flops(64, 80, u) + flops.controlnet_flops(64, 80, u, cond)
    want = steps * 2 * 8 * per + 8 * (flops.vae_encode_flops(512, 640, v) + flops.vae_decode_flops(64, 80, v))
    assert flops.denoise_batch_flops(spec, 8, 512, 640) == pytest.approx(want, rel=1e-12)
