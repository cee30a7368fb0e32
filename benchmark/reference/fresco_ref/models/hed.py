"""HED edge detector (ControlNet's Apache-2 variant), PyTorch/NHWC.

Counterpart of ``fresco_tpu/models/hed.py`` (reference
src/ControlNet/annotator/hed/__init__.py:17-78): five VGG blocks of 2, 2,
3, 3, 3 convolutions (64 to 512 channels, full width; there is no tiny
configuration), each with a 1-channel projection; the edge map is the
sigmoid of the mean of the five projections resized to the input.  RGB in
[0, 255] minus a learned per-channel ``norm``.  Runs in float32, as the
JAX package's detector does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.fresco_ref.models.layers import Conv2d
from benchmark.reference.fresco_ref.ops.resize import max_pool2d, resize_bilinear

HED_SPECS = ((64, 2, False), (128, 2, True), (256, 3, True), (512, 3, True), (512, 3, True))


class _Block(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, down: bool):
        super().__init__()
        self.down, self.layers = down, layers
        for i in range(layers):
            setattr(self, f"convs_{i}", Conv2d(in_ch if i == 0 else out_ch, out_ch, 3, 1, 1))
        self.projection = Conv2d(out_ch, 1, 1, 1, 0)

    def forward(self, x):
        if self.down:
            x = max_pool2d(x, 2)
        for i in range(self.layers):
            x = F.relu(getattr(self, f"convs_{i}")(x))
        return x, self.projection(x)


class HED(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 1, 1, 3))
        in_ch = 3
        for i, (ch, layers, down) in enumerate(HED_SPECS):
            setattr(self, f"block{i + 1}", _Block(in_ch, ch, layers, down))
            in_ch = ch

    def flax_init(self, gen=None):
        """Flax initializes ``norm`` to zeros."""
        with torch.no_grad():
            self.norm.zero_()

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] RGB in [0, 255] -> edge map [B, H, W] in [0, 1]."""
        h, w = x.shape[1:3]
        feat = x - self.norm
        ups = []
        for i in range(len(HED_SPECS)):
            feat, proj = getattr(self, f"block{i + 1}")(feat)
            ups.append(resize_bilinear(proj, (h, w)))
        return torch.sigmoid(torch.mean(torch.stack(ups, dim=0), dim=0)[..., 0])


def hed_detector(hed: HED, img: np.ndarray) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> uint8 edge map [H, W] (HEDdetector.__call__),
    on the model's device."""
    dev = hed.norm.device
    x = torch.as_tensor(np.ascontiguousarray(img), device=dev).to(hed.norm.dtype)[None]
    edge = hed(x)[0]
    return torch.clamp(edge * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
