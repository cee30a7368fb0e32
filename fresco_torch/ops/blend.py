"""Flow/occlusion rescaling for feature resolutions.

Counterpart of ``fresco_tpu/ops/blend.py:prepare_flow_for_scale``
(reference src/flow_utils.py:26-33), which the feature optimization
needs (``guidance.py``).  ``warp_and_fuse`` (background smoothing) is
not ported yet: it runs only with EGNet saliency weights.
"""
from __future__ import annotations

from fresco_torch.ops.morphology import dilate
from fresco_torch.ops.resize import max_pool2d, resize_bilinear

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
