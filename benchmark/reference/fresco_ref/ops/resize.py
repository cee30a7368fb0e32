"""Bilinear resize and pooling with torch ``F.interpolate`` semantics (NHWC).

Counterpart of ``fresco_tpu/ops/resize.py``: the source-coordinate
gather is written out per axis (H, then W) so that the port computes the
same float ops in the same order as the JAX package — flow rescaling,
cross-frame masks and the trajectory colour errors depend on it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _axis_resize(x: torch.Tensor, axis: int, out_size: int, align_corners: bool):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    out_pos = torch.arange(out_size, dtype=torch.float32, device=x.device)
    if align_corners:
        src = out_pos * ((in_size - 1) / max(out_size - 1, 1))
    else:
        src = torch.clamp((out_pos + 0.5) * (in_size / out_size) - 0.5, min=0.0)
    i0 = torch.clamp(torch.floor(src).to(torch.int64), 0, in_size - 1)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    w1 = (src - i0.to(torch.float32)).to(x.dtype)
    w0 = (1.0 - w1).to(x.dtype)
    shape = [1] * x.ndim
    shape[axis] = out_size
    g0 = torch.index_select(x, axis, i0)
    g1 = torch.index_select(x, axis, i1)
    return g0 * w0.reshape(shape) + g1 * w1.reshape(shape)


def resize_bilinear(
    x: torch.Tensor, out_hw: tuple[int, int], *, align_corners: bool = False
) -> torch.Tensor:
    """Bilinear-resize ``[..., H, W, C]`` to ``out_hw`` (no antialiasing)."""
    x = _axis_resize(x, x.ndim - 3, out_hw[0], align_corners)
    return _axis_resize(x, x.ndim - 2, out_hw[1], align_corners)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int | None = None) -> torch.Tensor:
    """Max-pool NHWC ``x`` (VALID padding)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride or kernel)
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, kernel: int, stride: int | None = None) -> torch.Tensor:
    """Average-pool NHWC ``x`` (VALID padding)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel, stride or kernel)
    return y.permute(0, 2, 3, 1)
