"""Temporal-consistency metrics of a translated clip.

Counterpart of ``fresco_tpu/metrics.py``: the flow-warp error under a
flow function, and the frame-to-frame similarity: CLIP image embeddings
where a CLIP vision checkpoint is given (``make_clip_image_encoder``),
else the pixel-cosine proxy (``frame_similarity_is_clip`` says which).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from fresco_torch.ops.resize import avg_pool2d
from fresco_torch.ops.warp import flow_warp, forward_backward_consistency
from fresco_torch.pipeline.runner import resolve_device


@torch.no_grad()
def warp_error(frames: torch.Tensor, flow_fn) -> float:
    """Mean |frame i+1 - frame i warped onto it| over non-occluded pixels
    and channels; frames float [F, H, W, 3] in [0, 255], ``flow_fn`` as in
    ``pipeline.prepare.interframe_params``.  The wrap-around pair (last ->
    first) is left out of both sums."""
    f = frames.shape[0]
    rolled = torch.roll(frames, -1, dims=0)
    flow = flow_fn(frames, rolled).to(frames.dtype)
    fwd, bwd = flow[:f], flow[f:]
    _, bwd_occ = forward_backward_consistency(fwd, bwd)
    warped = flow_warp(frames, bwd)
    valid = (1.0 - bwd_occ)[..., None]
    err = torch.abs(rolled - warped) * valid
    denom = torch.clamp(torch.sum(valid[: f - 1]) * 3, min=1.0)
    return float(torch.sum(err[: f - 1]) / denom)


@torch.no_grad()
def clip_frame_similarity(frames: torch.Tensor, image_encoder=None) -> float:
    """Mean cosine similarity of consecutive frames' embeddings:
    ``image_encoder(frames)`` where given, else the 8x8 average-pooled
    pixels, mean-centred per frame."""
    if image_encoder is not None:
        emb = image_encoder(frames)
    else:
        x = avg_pool2d(frames.to(torch.float32), 8)
        emb = x.reshape(x.shape[0], -1)
        emb = emb - emb.mean(dim=1, keepdim=True)
    emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
    return float(torch.mean(torch.sum(emb[:-1] * emb[1:], dim=-1)))


def make_clip_image_encoder(ckpt_path: str | None, device: torch.device | str | None = None):
    """An encoder for ``clip_frame_similarity`` from a transformers
    CLIPVisionModel / CLIPModel checkpoint, on ``device`` (default the
    card), or None where the file is absent.  encoder(frames_255) ->
    L2-normalized [F, D], projected where the file has
    ``visual_projection``."""
    if not ckpt_path or not os.path.exists(ckpt_path):
        return None
    from fresco_torch.models.clip_vision import CLIPVisionEncoder, image_embeddings, infer_vision_config
    from fresco_torch.models.convert import convert_clip_vision, load_into, load_torch_state_dict

    sd = load_torch_state_dict(ckpt_path)
    cfg = infer_vision_config(sd)
    project = "visual_projection.weight" in sd
    with torch.device("meta"):
        model = CLIPVisionEncoder(cfg, projection=project)
    model = model.to_empty(device=resolve_device(device))
    load_into(model, convert_clip_vision(sd, cfg))
    model = model.float().eval().requires_grad_(False)

    def encode(frames_255: torch.Tensor) -> torch.Tensor:
        return image_embeddings(model, frames_255.float() / 127.5 - 1.0, project=project)

    encode.model = model
    return encode


def evaluate_translation(out_frames: np.ndarray, flow_fn, device: torch.device | str | None = None,
                         clip_encoder=None) -> dict:
    """The report for a translated clip, uint8 [F, H, W, 3], on ``device``
    (default the card; raises where there is none).  ``clip_encoder``: from
    ``make_clip_image_encoder``, for the real CLIP frame similarity; the
    pixel-cosine proxy without it."""
    x = torch.as_tensor(np.asarray(out_frames), device=resolve_device(device)).to(torch.float32)
    return {
        "warp_error": warp_error(x, flow_fn),
        "frame_similarity": clip_frame_similarity(x, clip_encoder),
        "frame_similarity_is_clip": clip_encoder is not None,
    }
