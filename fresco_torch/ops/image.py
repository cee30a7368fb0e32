"""Image value-range conversion (NHWC).  Counterpart of
``fresco_tpu/ops/image.py:unit_range_to_uint8`` (reference
src/utils.py:17-21)."""
from __future__ import annotations

import numpy as np
import torch


def unit_range_to_uint8(x: torch.Tensor) -> np.ndarray:
    """float [-1,1] [B,H,W,C] -> uint8 numpy [B,H,W,C] (utils.py:17-21)."""
    img = torch.clamp(x.to(torch.float32) / 2 + 0.5, 0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8).cpu().numpy()
