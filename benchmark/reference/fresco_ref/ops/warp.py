"""Optical-flow warping and consistency ops (NHWC).

Counterpart of ``fresco_tpu/ops/warp.py`` (reference gmflow
geometry.py:5-97): bilinear sampling as four clipped gathers and a
masked lerp, equal to ``grid_sample(align_corners=True,
padding_mode='zeros')`` on pixel coordinates.

Conventions: features [B,H,W,C]; flow [B,H,W,2] as (dx, dy);
occlusion [B,H,W] float, 1 == occluded.
"""
from __future__ import annotations

import torch


def coords_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel coordinate grid [H, W, 2] with channels (x, y)."""
    y, x = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)


def bilinear_sample(
    img: torch.Tensor,
    coords: torch.Tensor,
    *,
    padding_mode: str = "zeros",
    return_mask: bool = False,
):
    """Sample ``img`` [B,H,W,C] at pixel coordinates ``coords`` [B,h,w,2]."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(padding_mode)
    b, h_in, w_in, c = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = img.reshape(b, h_in * w_in, c)

    def gather(yi, xi):
        xc = torch.clamp(xi, 0, w_in - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, h_in - 1).to(torch.int64)
        idx = (yc * w_in + xc).reshape(b, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(*yi.shape, c)
        if padding_mode == "zeros":
            inb = (xi >= 0) & (xi <= w_in - 1) & (yi >= 0) & (yi <= h_in - 1)
            vals = vals * inb[..., None].to(img.dtype)
        return vals

    out = (
        gather(y0, x0) * (wx0 * wy0)[..., None]
        + gather(y0, x1) * (wx1 * wy0)[..., None]
        + gather(y1, x0) * (wx0 * wy1)[..., None]
        + gather(y1, x1) * (wx1 * wy1)[..., None]
    ).to(img.dtype)
    if return_mask:
        return out, (x >= 0) & (x <= w_in - 1) & (y >= 0) & (y <= h_in - 1)
    return out


def flow_warp(feature, flow, *, padding_mode: str = "zeros", return_mask: bool = False):
    """Backward-warp ``feature`` [B,H,W,C] by ``flow``: out[p] = feature[p + flow[p]]."""
    _, h, w, _ = feature.shape
    grid = coords_grid(h, w, flow.dtype, flow.device)[None] + flow
    return bilinear_sample(
        feature, grid, padding_mode=padding_mode, return_mask=return_mask
    )


def forward_backward_consistency(fwd_flow, bwd_flow, alpha: float = 0.01, beta: float = 0.5):
    """UnFlow forward-backward occlusion masks (geometry.py:76-97):
    (fwd_occ, bwd_occ) float [B,H,W], 1 == occluded."""

    def norm(f):
        return torch.sqrt(torch.sum(f * f, dim=-1))

    flow_mag = norm(fwd_flow) + norm(bwd_flow)
    diff_fwd = norm(fwd_flow + flow_warp(bwd_flow, fwd_flow))
    diff_bwd = norm(bwd_flow + flow_warp(fwd_flow, bwd_flow))
    threshold = alpha * flow_mag + beta
    return (
        (diff_fwd > threshold).to(fwd_flow.dtype),
        (diff_bwd > threshold).to(bwd_flow.dtype),
    )
