"""Temporal-consistency metrics of a translated clip.

Counterpart of ``fresco_tpu/metrics.py``: the flow-warp error under a
flow function, and the frame-to-frame similarity.  The similarity here is
the pixel-cosine proxy (CLIP vision is ROADMAP Slice 7), so
``frame_similarity_is_clip`` is always False.
"""
from __future__ import annotations

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
def clip_frame_similarity(frames: torch.Tensor) -> float:
    """Mean cosine similarity of consecutive frames' embeddings: the 8x8
    average-pooled pixels, mean-centred per frame."""
    x = avg_pool2d(frames.to(torch.float32), 8)
    emb = x.reshape(x.shape[0], -1)
    emb = emb - emb.mean(dim=1, keepdim=True)
    emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
    return float(torch.mean(torch.sum(emb[:-1] * emb[1:], dim=-1)))


def evaluate_translation(out_frames: np.ndarray, flow_fn, device: torch.device | str | None = None) -> dict:
    """The report for a translated clip, uint8 [F, H, W, 3], on ``device``
    (default the card; raises where there is none)."""
    x = torch.as_tensor(np.asarray(out_frames), device=resolve_device(device)).to(torch.float32)
    return {
        "warp_error": warp_error(x, flow_fn),
        "frame_similarity": clip_frame_similarity(x),
        "frame_similarity_is_clip": False,
    }
