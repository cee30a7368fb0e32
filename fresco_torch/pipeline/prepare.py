"""FRESCO parameter preparation for one keyframe batch.

Counterpart of ``fresco_tpu/pipeline/prepare.py`` (reference
src/diffusion_hacked.py PART III):

  * ``interframe_params``: bidirectional flow (through a flow function),
    forward-backward + photo-consistency occlusion, cross-frame key masks
    at 1/8, 1/16, 1/32 and FLATTEN trajectories at 1/8, 1/16;
  * ``intraframe_params``: one UNet pass at the last timestep over the
    VAE-encoded noisy inputs, capturing the decoder self-attention inputs
    (spatial-guided attention) and the per-stage normalized features
    (the spatial loss's reference gram, stored factored);
  * ``build_attn_params``: the attention inputs, with the cross-frame keys
    compacted valid-first.

Over a mesh (frames over ``data``; every rank holds every input frame)
each rank computes the flows of its own pairs (frame i and i+1 mod F) and
gathers them, then the occlusions, key masks and trajectories of the whole
batch; the intra-frame pass runs on its own frames only.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from fresco_torch.attention.fresco_attention import FrescoAttnParams
from fresco_torch.core.comm import gather_frames, local_frames
from fresco_torch.diffusion.scheduler import DDPMScheduler
from fresco_torch.ops.mapping import batch_mappings
from fresco_torch.ops.resize import resize_bilinear
from fresco_torch.ops.warp import flow_warp, forward_backward_consistency


@torch.no_grad()
def interframe_params(flow_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      frames_255: torch.Tensor, *, photo_thresh: float = 0.25,
                      mask_scales: tuple[int, ...] = (8, 16, 32),
                      traj_scales: tuple[int, ...] = (8, 16), mesh=None):
    """frames_255 [F,H,W,3] in [0,255]; flow_fn(frames, rolled) ->
    [2F,H,W,2] (forward flows, then backward).  Returns ((fwd, bwd) flows,
    (fwd, bwd) occlusions, cf_masks {hw: bool [F,hw]}, trajectories), all
    of the whole batch; with a ``mesh`` each rank runs ``flow_fn`` on its
    own pairs."""
    f, H, W, _ = frames_255.shape
    rolled = torch.roll(frames_255, -1, dims=0)
    if mesh is not None and mesh.data > 1:
        flow_bidir = gather_frames(flow_fn(local_frames(frames_255, mesh), local_frames(rolled, mesh)), mesh, 2)
    else:
        flow_bidir = flow_fn(frames_255, rolled)
    fwd_flows, bwd_flows = flow_bidir[:f], flow_bidir[f:]
    fwd_occs, bwd_occs = forward_backward_consistency(fwd_flows, bwd_flows)

    # photo-consistency (diffusion_hacked.py:922-926)
    warped1 = flow_warp(frames_255, bwd_flows)
    bad1 = (torch.mean(torch.abs(rolled - warped1), dim=-1) > 255.0 * photo_thresh).to(bwd_occs.dtype)
    bwd_occs = torch.clamp(bwd_occs + bad1, 0.0, 1.0)
    warped2 = flow_warp(rolled, fwd_flows)
    bad2 = (torch.mean(torch.abs(frames_255 - warped2), dim=-1) > 255.0 * photo_thresh).to(fwd_occs.dtype)
    fwd_occs = torch.clamp(fwd_occs + bad2, 0.0, 1.0)

    # frame 0's keys always valid; frame i>0 where the bwd occlusion of
    # pair i-1 is high (diffusion_hacked.py:935-938)
    cf_masks = {}
    for scale in mask_scales:
        h, w = H // scale, W // scale
        occ_s = resize_bilinear(bwd_occs[: f - 1, :, :, None], (h, w))[..., 0]
        cf_masks[h * w] = torch.cat(
            [torch.ones((1, h * w), dtype=torch.bool, device=frames_255.device),
             occ_s.reshape(f - 1, -1) > 0.5], dim=0)

    frames_unit = frames_255 / 255.0 * 2.0 - 1.0
    trajectories = {}
    for scale in traj_scales:
        h, w = H // scale, W // scale
        trajectories[h * w] = batch_mappings(bwd_flows, bwd_occs, frames_unit, float(scale))
    return (fwd_flows, bwd_flows), (fwd_occs, bwd_occs), cf_masks, trajectories


@torch.no_grad()
def intraframe_params(unet, vae, scheduler: DDPMScheduler, frames: torch.Tensor,
                      prompt_embeds: torch.Tensor, *, noise: torch.Tensor,
                      enc_noise: torch.Tensor, corr_dtype=torch.bfloat16, mesh=None):
    """Reference pass: decoder attention inputs + per-stage features.

    frames [F,H,W,3] in [-1,1]; prompt_embeds [2F,77,C]; ``noise`` (the
    forward-diffusion noise) and ``enc_noise`` (the VAE posterior noise)
    standard normal [F,H/8,W/8,4].  Returns (ref_features tuple in FRESCO-
    layer order, {stage: normalized features [2F,hw,C] in corr_dtype}); with
    a ``mesh`` the pass runs on this rank's frames and returns theirs."""
    if mesh is not None and mesh.data > 1:
        frames, noise, enc_noise = (local_frames(x, mesh) for x in (frames, noise, enc_noise))
        prompt_embeds = local_frames(prompt_embeds, mesh, chunk=2)
    t_last = int(scheduler.timesteps_np[-1])
    lat_t = torch.promote_types(frames.dtype, torch.float32)
    latent_x0 = vae.encode(frames, enc_noise).to(lat_t)
    latents = scheduler.add_noise(latent_x0, noise.to(lat_t), t_last)
    lmi = torch.cat([latents] * 2, dim=0)
    refs: list = []
    _, up_features = unet(lmi, t_last, prompt_embeds, return_up_features=True, capture_refs=refs)
    correlations = {}
    for stage, feat in enumerate(up_features):
        b, h, w, c = feat.shape
        v = feat.to(torch.promote_types(feat.dtype, torch.float32)).reshape(b, h * w, c)
        v = v / torch.sqrt(torch.sum(v * v, dim=2, keepdim=True))
        correlations[stage] = v.to(corr_dtype)
    return tuple(refs), correlations


def auto_cf_key_cap(n_valid: int, hw: int, f: int) -> int:
    """Compaction cap: the next multiple of max(hw/2, 128) >= n_valid,
    bounded by F*hw — never truncates."""
    g = max(hw // 2, 128)
    return int(min(max(-(-n_valid // g), 1) * g, f * hw))


def build_attn_params(cf_masks, ref_features, trajectories, *, chunk: int = 2,
                      intra_scale: float = 0.2, inter_scale: float = 0.2,
                      cf_key_cap: float | str = "auto") -> FrescoAttnParams:
    """Assemble the attention inputs.  ``cf_key_cap``: "auto" sizes the
    compacted key count per batch from the valid count (exact); a number
    fixes K = cap*hw (the least recent frames' keys drop beyond it); 0
    keeps the dense masked path."""
    cf_perms = None
    auto = cf_key_cap == "auto"
    if cf_masks is not None and (auto or (cf_key_cap and cf_key_cap > 0)):
        cf_perms = {}
        for hw, mask in cf_masks.items():
            f = mask.shape[0]
            flat = mask.reshape(-1).cpu().numpy()
            n_valid = int(flat.sum())
            k_cap = auto_cf_key_cap(n_valid, hw, f) if auto else int(min(cf_key_cap * hw, f * hw))
            if not auto and n_valid > k_cap:
                print(f"[fresco_torch] cf compaction at hw={hw}: {n_valid} valid keys > cap "
                      f"{k_cap}; the least recent frames' keys are dropped")
            # stable argsort of ~valid: valid keys first, frame-major order kept
            perm = np.argsort(~flat, kind="stable")[:k_cap]
            cf_perms[hw] = (torch.as_tensor(perm, device=mask.device),
                            torch.as_tensor(flat[perm], device=mask.device))
    return FrescoAttnParams(cf_masks=cf_masks, cf_perms=cf_perms, ref_features=ref_features,
                            trajectories=trajectories, intra_scale=intra_scale,
                            inter_scale=inter_scale, chunk=chunk)
