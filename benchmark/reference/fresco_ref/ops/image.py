"""Image value ranges and the host-side frame preparation (NHWC).

Counterpart of ``fresco_tpu/ops/image.py`` (reference src/utils.py:17-49).
The JAX package resizes and blurs frames with OpenCV; the port does not
depend on it (the card's machine has none), so ``resize_image`` and
``gaussian_blur9`` are written here with OpenCV's arithmetic on uint8:

  * ``INTER_LANCZOS4`` (upscaling): OpenCV's 8-tap coefficients, rounded
    to 11-bit fixed point, an integer horizontal pass, an integer vertical
    pass rounded half up from 22 fractional bits, edge pixels replicated;
  * ``INTER_AREA``: downscaling, the fractional-coverage weights of
    ``propagate/guides.py``, rounded half to even; where an axis grows,
    OpenCV's two-tap fixed-point path;
  * ``GaussianBlur(9x9, sigma 0)``: sigma 1.7, the kernel in 8-bit fixed
    point with OpenCV's error diffusion (the centre tap takes the rest of
    256), integer passes rounded half up from 16 bits, reflect-101 border.

All of it runs on the CPU in torch; frames are uint8 numpy [H, W, C].
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def unit_range_to_uint8(x: torch.Tensor) -> np.ndarray:
    """float [-1,1] [B,H,W,C] -> uint8 numpy [B,H,W,C] (utils.py:17-21)."""
    img = torch.clamp(x.to(torch.float32) / 2 + 0.5, 0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8).cpu().numpy()


def resolution_to_64(h: int, w: int, resolution: int = 512) -> tuple[int, int]:
    """Scale (h, w) so the short side is about ``resolution``, each side
    rounded to a multiple of 64 (utils.py:39-47)."""
    k = float(resolution) / min(h, w)
    return int(np.round(h * k / 64.0)) * 64, int(np.round(w * k / 64.0)) * 64


def _lanczos4_coeffs(x: float) -> np.ndarray:
    """OpenCV's interpolateLanczos4 at fraction ``x`` (float32 weights
    normalized by their float32 sum)."""
    if x < np.finfo(np.float32).eps:
        c = np.zeros(8, np.float32)
        c[3] = 1.0
        return c
    s45 = 0.70710678118654752440084436210485
    cs = [(1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45), (0, -1), (-s45, s45)]
    y0 = -(x + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs = np.zeros(8, np.float32)
    total = np.float32(0.0)
    for i in range(8):
        y = -(x + 3 - i) * math.pi * 0.25
        coeffs[i] = np.float32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y))
        total = np.float32(total + coeffs[i])
    return coeffs * np.float32(np.float32(1.0) / total)


def _lanczos4_tab(ssize: int, dsize: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per destination index: 8 source indices (edge-replicated) and the
    11-bit fixed-point weights, [dsize, 8] int64 each."""
    scale = 1.0 / (dsize / ssize)
    idx = np.zeros((dsize, 8), np.int64)
    wts = np.zeros((dsize, 8), np.int64)
    for d in range(dsize):
        fx = np.float32((d + 0.5) * scale - 0.5)
        sx = math.floor(fx)
        fx = float(np.float32(fx - np.float32(sx)))
        idx[d] = np.clip(sx - 3 + np.arange(8), 0, ssize - 1)
        wts[d] = np.rint(_lanczos4_coeffs(fx).astype(np.float32) * np.float32(2048)).astype(np.int64)
    return torch.from_numpy(idx), torch.from_numpy(wts)


def _resize_lanczos4(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    h, w = img.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int64)
    if x.ndim == 2:
        x = x[..., None]
    xi, xw = _lanczos4_tab(w, nw)
    yi, yw = _lanczos4_tab(h, nh)
    rows = (x[:, xi] * xw[None, :, :, None]).sum(2)             # [h, nw, C]
    vals = (rows[yi] * yw[:, :, None, None]).sum(1)             # [nh, nw, C]
    out = ((vals + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8).numpy()
    return out if img.ndim == 3 else out[..., 0]


def _area_up_tab(ssize: int, dsize: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """OpenCV's INTER_AREA coefficients for a resize that grows an axis
    (its two-tap "area mode"): per destination index the source index, the
    next one (clamped) and both weights in 11-bit fixed point."""
    scale, inv = 1.0 / (dsize / ssize), dsize / ssize
    i0 = np.zeros(dsize, np.int64)
    wts = np.zeros((dsize, 2), np.int64)
    for d in range(dsize):
        sx = math.floor(d * scale)
        fx = np.float32((d + 1) - (sx + 1) * inv)
        fx = np.float32(0.0) if fx <= 0 else np.float32(fx - np.float32(math.floor(fx)))
        if sx < 0:
            fx, sx = np.float32(0.0), 0
        if sx >= ssize - 1:
            fx, sx = np.float32(0.0), ssize - 1
        i0[d] = sx
        wts[d] = np.rint(np.array([np.float32(1.0) - fx, fx], np.float32) * np.float32(2048))
    i0 = torch.from_numpy(i0)
    return i0, (i0 + 1).clamp(max=ssize - 1), torch.from_numpy(wts[:, 0]), torch.from_numpy(wts[:, 1])


def _resize_area_up(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """``cv2.resize(INTER_AREA)`` on uint8 [H, W, C] where an axis grows:
    an integer horizontal pass, then OpenCV's SIMD vertical pass
    (``VResizeLinearVec_32s8u``: each row >> 4 times its weight, the high
    16 bits, the sum rounded by 2 bits), which covers every column when the
    row's W * C bytes are a multiple of the vector width (32 on AVX2), as
    at MLSD's 512x512 input."""
    h, w = x.shape[:2]
    x0, x1, ax0, ax1 = _area_up_tab(w, nw)
    y0, y1, ay0, ay1 = _area_up_tab(h, nh)
    v = x.to(torch.int64)
    rows = v[:, x0] * ax0[None, :, None] + v[:, x1] * ax1[None, :, None]
    hi = ((rows[y0] >> 4) * ay0[:, None, None] >> 16) + ((rows[y1] >> 4) * ay1[:, None, None] >> 16)
    return ((hi + 2) >> 2).clamp(0, 255).to(torch.uint8)


def _resize_area(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)`` on uint8."""
    from benchmark.reference.fresco_ref.propagate.guides import _resize_area as area_f32

    x = torch.from_numpy(np.ascontiguousarray(img))
    if x.ndim == 2:
        x = x[..., None]
    h, w = x.shape[:2]
    if nh > h or nw > w:
        out = _resize_area_up(x, nh, nw).numpy()
    elif h % nh == 0 and w % nw == 0:
        # integer scale: the block sum times 1/area rounded half to even,
        # except 2x2, whose vector path rounds half up
        ky, kx = h // nh, w // nw
        s = x.to(torch.int64).reshape(nh, ky, nw, kx, -1).sum((1, 3))
        if ky == kx == 2:
            out = ((s + 2) >> 2).to(torch.uint8).numpy()
        else:
            out = torch.round(s.to(torch.float32) * np.float32(1.0 / (ky * kx))).to(torch.uint8).numpy()
    else:
        out = torch.round(area_f32(x.to(torch.float32), nh, nw)).clamp(0, 255).to(torch.uint8).numpy()
    return out if img.ndim == 3 else out[..., 0]


def resize_image(img: np.ndarray, resolution: int = 512) -> np.ndarray:
    """Resize a uint8 [H, W, C] frame so its short side is about
    ``resolution`` and both sides are multiples of 64 (utils.py:39-49):
    LANCZOS4 when it grows, AREA otherwise."""
    h, w = img.shape[:2]
    h2, w2 = resolution_to_64(h, w, resolution)
    if (h2, w2) == (h, w):
        return img.copy()
    if float(resolution) / min(h, w) > 1:
        return _resize_lanczos4(img, h2, w2)
    return _resize_area(img, h2, w2)


def _gaussian_kernel_q8(n: int, sigma: float) -> np.ndarray:
    """OpenCV's fixed-point Gaussian kernel (8 fractional bits): the
    float kernel scaled by 256 and rounded from the outer taps in, each
    rounding error carried to the next tap; the centre takes the rest."""
    if sigma <= 0:
        sigma = ((n - 1) * 0.5 - 1) * 0.3 + 0.8
    half = (n - 1) // 2
    vals = [math.exp(-((i - half) ** 2) / (2.0 * sigma * sigma)) for i in range(half)]
    mul = 1.0 / (2.0 * sum(vals) + 1.0)
    out = np.zeros(n, np.int64)
    err, total = 0.0, 0
    for i in range(half):
        adj = vals[i] * mul * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[n - 1 - i] = v
        total += v
    out[half] = 256 - 2 * total
    return out


def gaussian_blur9(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (9, 9), 0)`` on uint8 [H, W, C]: keyframe
    selection's preprocessing (reference src/keyframe_selection.py:33)."""
    k = torch.from_numpy(_gaussian_kernel_q8(9, 0.0))
    x = torch.from_numpy(np.ascontiguousarray(img)).to(torch.float64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    # reflect-101 padding of 4 on each side (F.pad's "reflect"); the sums
    # are integers below 2^31, exact in float64
    p = F.pad(x.permute(2, 0, 1)[None], (4, 4, 4, 4), mode="reflect")[0].permute(1, 2, 0).to(torch.int64)
    h, w = x.shape[:2]
    rows = sum(p[:, j : j + w] * k[j] for j in range(9))
    vals = sum(rows[i : i + h] * k[i] for i in range(9))
    out = ((vals + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8).numpy()
    return out[..., 0] if squeeze else out
