"""Mask dilation (NHWC).  Counterpart of ``fresco_tpu/ops/morphology.py``
(reference src/utils.py:81-93): a k x k box sum over a replicate-padded
mask, clamped to [0, 1]."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate(x: torch.Tensor, kernel_size: int = 7) -> torch.Tensor:
    pad = (kernel_size - 1) // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="replicate")
    s = F.avg_pool2d(xp, kernel_size, stride=1) * (kernel_size * kernel_size)
    return torch.clamp(s, 0.0, 1.0).permute(0, 2, 3, 1)
