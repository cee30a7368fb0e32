"""FreeU: backbone scaling and a low-pass skip filter in the UNet decoder.

Counterpart of ``fresco_tpu/ops/freeu.py`` (reference
src/free_lunch_utils.py:25-52,120-139): pure functions the UNet's up
blocks call on NHWC tensors; the FFT runs in float32 (``torch.fft``).
"""
from __future__ import annotations

import torch


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the low-frequency components of NHWC ``x`` by ``scale``: the
    centred square [c - threshold, c + threshold) of the shifted spectrum
    (free_lunch_utils.py:44-46)."""
    xf = torch.fft.fftshift(torch.fft.fftn(x.to(torch.float32), dim=(1, 2)), dim=(1, 2))
    h, w = x.shape[1:3]
    yy = (torch.arange(h, device=x.device) - h // 2)[:, None]
    xx = (torch.arange(w, device=x.device) - w // 2)[None, :]
    low = (yy >= -threshold) & (yy < threshold) & (xx >= -threshold) & (xx < threshold)
    mask = torch.where(low, scale, 1.0)[None, :, :, None]
    xf = torch.fft.ifftshift(xf * mask, dim=(1, 2))
    return torch.fft.ifftn(xf, dim=(1, 2)).real.to(x.dtype)


def apply_freeu_to_skip(hidden: torch.Tensor, skip: torch.Tensor, b: float, s: float,
                        num_backbone_channels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """FreeU at one up-block resnet: the first ``num_backbone_channels``
    channels of ``hidden`` scaled by a per-sample, mean-modulated ``b``;
    ``skip``'s low frequencies (threshold 1) scaled by ``s``."""
    c = num_backbone_channels
    mean = hidden.mean(dim=-1, keepdim=True)
    lo = mean.amin(dim=(1, 2), keepdim=True)
    hi = mean.amax(dim=(1, 2), keepdim=True)
    mean = (mean - lo) / (hi - lo + 1e-12)
    factor = ((b - 1.0) * mean + 1.0).to(hidden.dtype)
    scaled = torch.cat([hidden[..., :c] * factor, hidden[..., c:]], dim=-1)
    return scaled, fourier_filter(skip, threshold=1, scale=s)
