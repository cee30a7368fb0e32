"""8-bit BGR <-> CIE Lab in torch, following OpenCV's ``cvtColor``.

The JAX package converts with ``cv2.cvtColor(x, COLOR_BGR2Lab)`` and
``COLOR_Lab2BGR`` on uint8 images (``histogram.py:31,46``,
``poisson.py:98,118``).  The port has no OpenCV, so these are OpenCV's
formulas (imgproc/src/color_lab.cpp): sRGB gamma, the D65 white point,
L scaled by 255/100, a and b offset by 128, rounded and saturated to
uint8.  ``bgr2lab`` repeats OpenCV's 8-bit fixed-point path and its
lookup tables (it differs from OpenCV on ~1e-4 of all colours, by one
level, from table rounding); ``lab2bgr`` is the float formula, which
differs from OpenCV's fixed-point inverse by one level on ~18 % of
pixels and by two on fewer than 1e-4.
"""
from __future__ import annotations

import torch

_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.53715, -0.498535),
            (-0.969256, 1.875991, 0.041556),
            (0.055648, -0.204043, 1.057311))
_WHITE = (0.950456, 1.0, 1.088754)
_T = 0.008856
_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def _lab_tables(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """OpenCV's 8-bit RGB->Lab tables (color_lab.cpp initLabTabs): sRGB
    gamma in 1/8 levels, the cube root in 2^-15 units over the 1/8-level
    XYZ range, and the RGB->XYZ matrix over the white point in 2^-12."""
    x = torch.arange(256, dtype=torch.float64) / 255.0
    gamma = torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma_tab = torch.round(255.0 * (1 << _GAMMA_SHIFT) * gamma)
    t = torch.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT), dtype=torch.float64) / (255.0 * (1 << _GAMMA_SHIFT))
    cbrt = torch.where(t < _T, t * 7.787 + 16.0 / 116.0, t ** (1.0 / 3.0))
    cbrt_tab = torch.round((1 << _LAB_SHIFT2) * cbrt)
    m = torch.tensor(_RGB2XYZ, dtype=torch.float64) / torch.tensor(_WHITE, dtype=torch.float64)[:, None]
    coeffs = torch.round((1 << _LAB_SHIFT) * m)
    return tuple(v.to(torch.int64).to(device) for v in (gamma_tab, cbrt_tab, coeffs))


def _descale(v: torch.Tensor, n: int) -> torch.Tensor:
    return (v + (1 << (n - 1))) >> n


def bgr2lab(img: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] BGR -> uint8 [..., 3] Lab (L·255/100, a+128, b+128),
    in OpenCV's fixed point."""
    gamma_tab, cbrt_tab, coeffs = _lab_tables(img.device)
    rgb = gamma_tab[img.flip(-1).long()]
    f = cbrt_tab[_descale((rgb[..., None, :] * coeffs).sum(-1), _LAB_SHIFT)]  # no int matmul on CUDA
    fx, fy, fz = f.unbind(-1)
    one = 1 << _LAB_SHIFT2
    lum = _descale(((116 * 255 + 50) // 100) * fy - (16 * 255 * one + 50) // 100, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * one, _LAB_SHIFT2)
    b = _descale(200 * (fy - fz) + 128 * one, _LAB_SHIFT2)
    return torch.stack([lum, a, b], -1).clamp(0, 255).to(torch.uint8)


def lab2bgr(lab: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] Lab (as ``bgr2lab`` writes it) -> uint8 [..., 3] BGR."""
    lab = lab.float()
    lum = lab[..., 0] * (100.0 / 255.0)
    a, b = lab[..., 1] - 128.0, lab[..., 2] - 128.0
    low = lum <= 8.0
    y = torch.where(low, lum / 903.3, ((lum + 16.0) / 116.0) ** 3)
    fy = torch.where(low, 7.787 * y + 16.0 / 116.0, (lum + 16.0) / 116.0)
    fx, fz = a / 500.0 + fy, fy - b / 200.0

    def finv(t):
        return torch.where(t > 0.206893, t ** 3, (t - 16.0 / 116.0) / 7.787)

    xyz = torch.stack([finv(fx) * _WHITE[0], y, finv(fz) * _WHITE[2]], -1)
    m = torch.tensor(_XYZ2RGB, dtype=torch.float32, device=lab.device)
    rgb = (xyz @ m.T).clamp(0.0, 1.0)
    srgb = torch.where(rgb <= 0.0031308, 12.92 * rgb, 1.055 * rgb ** (1.0 / 2.4) - 0.055)
    return _u8(srgb * 255.0).flip(-1)
