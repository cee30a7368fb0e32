"""OpenCV's INTER_LINEAR resize in plain PyTorch (the MiDaS detector's
final resize), frozen from the port's ``propagate/guides.py``."""
from __future__ import annotations

import math

import numpy as np
import torch


def _linear_tab(ssize: int, dsize: int, device):
    """OpenCV's INTER_LINEAR source indices and float32 weights."""
    scale = 1.0 / (dsize / ssize)
    i0 = np.zeros(dsize, np.int64)
    f = np.zeros(dsize, np.float32)
    for d in range(dsize):
        fx = float(np.float32((d + 0.5) * scale - 0.5))
        s = math.floor(fx)
        fx -= s
        if s < 0:
            fx, s = 0.0, 0
        if s >= ssize - 1:
            fx, s = 0.0, ssize - 1
        i0[d], f[d] = s, fx
    i0 = torch.from_numpy(i0).to(device)
    f = torch.from_numpy(f).to(device)
    return i0, (i0 + 1).clamp(max=ssize - 1), 1.0 - f, f


def _resize_linear(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """``cv2.resize(x, (nw, nh), INTER_LINEAR)`` for float32 [H, W, C]:
    horizontal then vertical two-tap interpolation."""
    h, w = x.shape[:2]
    x0, x1, ax0, ax1 = _linear_tab(w, nw, x.device)
    y0, y1, ay0, ay1 = _linear_tab(h, nh, x.device)
    rows = x[:, x0] * ax0[None, :, None] + x[:, x1] * ax1[None, :, None]
    return rows[y0] * ay0[:, None, None] + rows[y1] * ay1[:, None, None]
