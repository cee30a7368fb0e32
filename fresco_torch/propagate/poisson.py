"""Screened-Poisson gradient fusion, in torch.

Counterpart of ``fresco_tpu/propagate/poisson.py`` (reference
src/ebsynth/blender/poisson_fusion.py): fuse the gradients of the two
propagated candidates by the selection mask and solve
min ||w∇x − w g||² + ||x − blend||² per Lab channel, in closed form by
diagonalizing the Neumann Laplacian with an orthonormal DCT-II (torch has
no DCT, so it is built on ``torch.fft``: Makhoul's even-odd reordering and
one FFT per axis).

Gradient convention (poisson_fusion.py:64-70): gx[i,j] = x[i,j] − x[i+1,j]
(rows), gy[i,j] = x[i,j] − x[i,j+1] (cols), on the first h−1 rows / w−1
cols.
"""
from __future__ import annotations

import math

import torch

from fresco_torch.propagate.color import bgr2lab, lab2bgr


def _grad(x):
    return x[:-1] - x[1:], x[:, :-1] - x[:, 1:]


def _grad_T(gx, gy, h, w):
    """Adjoint of _grad: scatter the divergence."""
    out = torch.zeros((h, w, gx.shape[-1]), dtype=gx.dtype, device=gx.device)
    out[:-1] += gx
    out[1:] -= gx
    out[:, :-1] += gy
    out[:, 1:] -= gy
    return out


def _twiddle(n: int, sign: float, x: torch.Tensor) -> torch.Tensor:
    k = torch.arange(n, dtype=x.dtype, device=x.device)
    return torch.polar(torch.ones_like(k), sign * math.pi * k / (2 * n))


def _ortho_scale(n: int, x: torch.Tensor) -> torch.Tensor:
    s = torch.full((n,), math.sqrt(1.0 / (2 * n)), dtype=x.dtype, device=x.device)
    s[0] = math.sqrt(1.0 / (4 * n))
    return s


def dct(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Orthonormal DCT-II along ``dim`` (scipy's ``dct(norm="ortho")``)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], -1)
    spec = torch.fft.fft(v, dim=-1)
    out = 2.0 * (spec * _twiddle(n, -1.0, x)).real * _ortho_scale(n, x)
    return out.movedim(-1, dim)


def idct(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Orthonormal DCT-III along ``dim``, the inverse of ``dct``."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    y = x / _ortho_scale(n, x)  # back to the unnormalized DCT-II values X_k
    y_rev = torch.cat([torch.zeros_like(y[..., :1]), y[..., 1:].flip(-1)], -1)  # X_{N-k}, X_N = 0
    spec = 0.5 * torch.complex(y, -y_rev) * _twiddle(n, 1.0, x)
    v = torch.fft.ifft(spec, dim=-1).real
    out = torch.empty_like(v)
    half = (n + 1) // 2
    out[..., ::2] = v[..., :half]
    out[..., 1::2] = v[..., half:].flip(-1)
    return out.movedim(-1, dim)


def screened_poisson(blend: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Solve (w²∇ᵀ∇ + I)x = w²∇ᵀg + blend exactly: one 2-D DCT, a
    pointwise divide by (1 + w²λ), one inverse DCT.  blend [H,W,3]
    (mean-centred per channel by the caller), gx [H-1,W,3], gy [H,W-1,3],
    weights [3]."""
    h, w, _ = blend.shape
    w2 = (weights ** 2)[None, None, :]
    b = _grad_T(w2 * gx, w2 * gy, h, w) + blend
    ky = torch.arange(h, dtype=blend.dtype, device=blend.device)
    kx = torch.arange(w, dtype=blend.dtype, device=blend.device)
    lam = ((2.0 - 2.0 * torch.cos(math.pi * ky / h))[:, None, None]
           + (2.0 - 2.0 * torch.cos(math.pi * kx / w))[None, :, None])
    spec = dct(dct(b, 0), 1)
    return idct(idct(spec / (1.0 + w2 * lam), 0), 1)


def poisson_fusion(blend_bgr: torch.Tensor, i1_bgr: torch.Tensor, i2_bgr: torch.Tensor,
                   mask: torch.Tensor, grad_weight=(2.5, 0.5, 0.5)) -> torch.Tensor:
    """Full fusion (poisson_fusion.py:54-93): Lab conversion, masked
    gradient fusion (clipped to ±100), per-channel screened solve.  uint8
    [H, W, 3] BGR in and out."""
    iab, ia, ib = (bgr2lab(x).float() for x in (blend_bgr, i1_bgr, i2_bgr))
    m = (mask > 0).float()[:, :, None]
    gx = (ia[:-1] - ia[1:]) * (1 - m[:-1]) + (ib[:-1] - ib[1:]) * m[:-1]
    gy = (ia[:, :-1] - ia[:, 1:]) * (1 - m[:, :-1]) + (ib[:, :-1] - ib[:, 1:]) * m[:, :-1]
    gx, gy = gx.clamp(-100, 100), gy.clamp(-100, 100)
    mean = iab.mean(dim=(0, 1), keepdim=True)
    x = screened_poisson(iab - mean, gx, gy,
                         torch.tensor(grad_weight, dtype=torch.float32, device=iab.device))
    return lab2bgr((x + mean).clamp(0, 255).to(torch.uint8))
