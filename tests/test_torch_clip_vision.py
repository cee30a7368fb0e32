"""The port's CLIP vision tower and CLIP frame-similarity metric against
fresco_tpu's, on the CPU at the tiny config (hidden 32, 2 layers, image 32,
patch 8), float32.

- the key map: the state dict from a checkpoint bit-equal to JAX
  ``convert_clip_vision``'s tree (mapped by ``from_jax_params``), for a bare
  vision tower and a full CLIPModel file with ``visual_projection``;
- the encoder, pooled and projected: within 1e-5 of JAX;
- ``make_clip_image_encoder`` + ``evaluate_translation`` on a checkpoint
  file: the report within 1e-5 of JAX's, ``frame_similarity_is_clip`` true;
  the runner finds the file beside ``gmflow_path``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fresco_torch import metrics as TM
from fresco_torch.models import convert as TC
from fresco_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder, infer_vision_config
from fresco_torch.models.layers import init_flax_default_
from fresco_tpu import metrics as JM
from fresco_tpu.models import clip_vision as JV
from fresco_tpu.models.convert import convert_clip_vision as jax_convert

CFG = CLIPVisionConfig.tiny()
ATOL = 1e-5


def _checkpoint(projection: bool, prefix: bool = True) -> dict:
    """A seeded port module written in the transformers layout."""
    gen = torch.Generator().manual_seed(3)
    m = init_flax_default_(CLIPVisionEncoder(CFG, projection=projection), gen)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    ck = TC.to_checkpoint(m.state_dict(), lambda b: TC.clip_vision_map(b, CFG))
    if not prefix:
        ck = {k.removeprefix("vision_model."): v for k, v in ck.items()}
    if projection:  # the text half of a full CLIPModel file, unused here
        ck["text_model.final_layer_norm.weight"] = torch.ones(8)
        ck["logit_scale"] = torch.tensor(2.0)
    return ck


@pytest.mark.parametrize("projection,prefix", [(False, False), (False, True), (True, True)])
def test_key_map_matches_jax(projection, prefix):
    ck = _checkpoint(projection, prefix)
    port = TC.convert_clip_vision(ck, CFG)
    ref = TC.from_jax_params({"params": jax_convert({k: v.numpy() for k, v in ck.items()}, JV.CLIPVisionConfig.tiny())})
    assert sorted(port) == sorted(ref)
    for k in port:
        assert torch.equal(port[k], ref[k]), k
    assert vars(infer_vision_config(ck)) == vars(JV.infer_vision_config({k: v.numpy() for k, v in ck.items()}))


def test_encoder_matches_jax():
    ck = _checkpoint(True)
    m = CLIPVisionEncoder(CFG, projection=True)
    TC.load_into(m, TC.convert_clip_vision(ck, CFG))
    params = {"params": jax_convert({k: v.numpy() for k, v in ck.items()}, JV.CLIPVisionConfig.tiny())}
    jm = JV.CLIPVisionEncoder(JV.CLIPVisionConfig.tiny())
    pixels = np.random.default_rng(0).standard_normal((3, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    for project in (False, True):
        with torch.no_grad():
            out = m(torch.from_numpy(pixels), project=project).numpy()
        np.testing.assert_allclose(out, np.asarray(jm.apply(params, jnp.asarray(pixels), project=project)), atol=ATOL)
    frames = np.random.default_rng(1).uniform(-1, 1, (2, 40, 48, 3)).astype(np.float32)
    from fresco_torch.models.clip_vision import image_embeddings

    np.testing.assert_allclose(image_embeddings(m, torch.from_numpy(frames)).numpy(),
                               np.asarray(JV.image_embeddings(jm, params, jnp.asarray(frames))), atol=ATOL)


def test_metric_from_checkpoint_matches_jax(tmp_path):
    path = str(tmp_path / "clip_vision.bin")
    torch.save(_checkpoint(True), path)
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (4, 40, 48, 3)).astype(np.uint8)
    t_enc = TM.make_clip_image_encoder(path, "cpu")
    j_enc = JM.make_clip_image_encoder(path)
    assert TM.make_clip_image_encoder(str(tmp_path / "absent.bin"), "cpu") is None
    t = TM.evaluate_translation(frames, lambda a, b: torch.zeros(2 * a.shape[0], *a.shape[1:3], 2), "cpu",
                                clip_encoder=t_enc)
    j = JM.evaluate_translation(frames, lambda a, b: jnp.zeros((2 * a.shape[0], *a.shape[1:3], 2)), j_enc)
    assert t["frame_similarity_is_clip"] is True and j["frame_similarity_is_clip"] is True
    for k in ("warp_error", "frame_similarity"):
        assert abs(t[k] - j[k]) <= ATOL, (k, t[k], j[k])


def test_runner_finds_clip_beside_gmflow(tmp_path, monkeypatch):
    from fresco_torch.core.config import FrescoConfig
    from fresco_torch.pipeline import runner

    torch.save(_checkpoint(True), str(tmp_path / "clip_vision.bin"))
    frame_dir = tmp_path / "frames"
    frame_dir.mkdir()
    from PIL import Image

    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)).save(frame_dir / f"{i:04d}.png")
    pipe = runner.FrescoPipeline.__new__(runner.FrescoPipeline)
    pipe.config = FrescoConfig(gmflow_path=str(tmp_path / "gmflow.pth"))
    pipe.device = torch.device("cpu")
    monkeypatch.setattr(runner.FrescoPipeline, "consistency_flow_fn",
                        lambda self: lambda a, b: torch.zeros(2 * a.shape[0], *a.shape[1:3], 2))
    assert pipe.evaluate_consistency(str(frame_dir))["frame_similarity_is_clip"] is True
    pipe.config = FrescoConfig(gmflow_path=str(tmp_path / "elsewhere" / "gmflow.pth"))
    assert pipe.evaluate_consistency(str(frame_dir))["frame_similarity_is_clip"] is False
