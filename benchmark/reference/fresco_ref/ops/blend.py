"""Background smoothing: flow-warp fusion of the non-salient region.

Counterpart of ``fresco_tpu/ops/blend.py`` (reference
src/flow_utils.py:18-53 ``warp_tensor``): ``warp_and_fuse`` chain-warps
each frame into the next and blends it in where the background mask of
both frames is set and the pair is not occluded; ``prepare_flow_for_scale``
rescales a full-resolution flow and occlusion to a feature resolution
(the feature optimization uses it too).

The chain is serial by construction: frame i+1 takes the already fused
frame i.  The wrap-around pair fuses frame 0 of each chunk into its last
frame through the last frame's forward flow.  Layouts: sample
[chunk*N, h, w, C]; flows [N, H, W, 2] (entry i joins frame i and frame
(i+1) % N); occlusions [N, H, W]; saliency [N, hs, ws, 1] background mask
(1 = background) at any resolution.
"""
from __future__ import annotations

import torch

from benchmark.reference.fresco_ref.ops.morphology import dilate
from benchmark.reference.fresco_ref.ops.resize import max_pool2d, resize_bilinear
from benchmark.reference.fresco_ref.ops.warp import flow_warp

# Reference flow_utils.py:28-33: Dilate(kernel_size=13) on the
# full-resolution occlusion.
FULL_RES_OCC_DILATE = 13


def prepare_flow_for_scale(flow, occ, target_hw, *, dilate_full_res: bool = True,
                           dilate_kernel: int = FULL_RES_OCC_DILATE):
    """flow [N,H,W,2] -> [N,h,w,2] (values scaled); occ [N,H,W] -> [N,h,w,1]
    by max-pool (occlusion is sticky); at scale 1 the occlusion is
    dilated instead."""
    H = flow.shape[1]
    h, w = target_hw
    scale = h / H
    if scale == 1.0:
        occ_s = occ[..., None]
        if dilate_full_res:
            occ_s = dilate(occ_s, dilate_kernel)
        return flow, occ_s
    kernel = int(round(1.0 / scale))
    return resize_bilinear(flow * scale, (h, w)), max_pool2d(occ[..., None], kernel)


def warp_and_fuse(sample: torch.Tensor, fwd_flow: torch.Tensor, bwd_flow: torch.Tensor,
                  fwd_occ: torch.Tensor, bwd_occ: torch.Tensor, saliency: torch.Tensor,
                  chunk: int = 2) -> torch.Tensor:
    """Fuse the background of consecutive frames by flow warping
    (flow_utils.py:18-53); returns ``sample``'s shape and dtype."""
    n = sample.shape[0] // chunk
    h, w = sample.shape[1:3]
    bwd_flow_s, bwd_occ_s = prepare_flow_for_scale(bwd_flow, bwd_occ, (h, w))
    fwd_flow_s, fwd_occ_s = prepare_flow_for_scale(fwd_flow, fwd_occ, (h, w))
    wd = torch.promote_types(sample.dtype, torch.float32)
    sal = resize_bilinear(saliency, (h, w)).to(wd)
    warp_sal = flow_warp(sal, bwd_flow_s)
    warp_sal_wrap = flow_warp(sal[0:1], fwd_flow_s[n - 1 : n])

    frames = list(sample.to(wd).unbind(0))
    for j in range(chunk):
        for ii in range(n - 1):
            i = n * j + ii
            warped = flow_warp(frames[i][None], bwd_flow_s[ii : ii + 1])[0]
            m = (1.0 - bwd_occ_s[ii]) * sal[ii + 1] * warp_sal[ii]
            frames[i + 1] = frames[i + 1] * (1.0 - m) + warped * m
        i0 = n * j
        warped = flow_warp(frames[i0][None], fwd_flow_s[n - 1 : n])[0]
        m = (1.0 - fwd_occ_s[n - 1]) * sal[n - 1] * warp_sal_wrap[0]
        frames[i0 + n - 1] = frames[i0 + n - 1] * (1.0 - m) + warped * m
    return torch.stack(frames).to(sample.dtype)
