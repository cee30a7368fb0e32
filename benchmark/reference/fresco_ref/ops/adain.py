"""Adaptive instance normalization (NHWC).  Counterpart of
``fresco_tpu/ops/adain.py`` (reference src/utils.py:58-78)."""
from __future__ import annotations

import torch


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5, chunk: int = 1):
    """Per-sample, per-channel mean and unbiased std, [N,1,1,C] each; with
    chunk=2 the two batch halves share statistics (utils.py:58-67)."""
    n, h, w, c = feat.shape
    g = feat.reshape(chunk, n // chunk, h * w, c)
    g = g.movedim(0, 2).reshape(n // chunk, chunk * h * w, c)
    mean = g.mean(dim=1)
    count = g.shape[1]
    var = ((g - mean[:, None, :]) ** 2).sum(dim=1) / max(count - 1, 1)
    std = torch.sqrt(var + eps)
    return (
        mean.repeat(chunk, 1)[:, None, None, :],
        std.repeat(chunk, 1)[:, None, None, :],
    )


def adain(content: torch.Tensor, style: torch.Tensor, style_eps: float = 1e-5) -> torch.Tensor:
    """Re-normalize ``content`` to ``style``'s instance statistics.

    The reference passes its chunk argument into calc_mean_std's eps slot
    (utils.py:73), so the style std uses eps=1.0 at its one call site;
    pass ``style_eps=1.0`` to reproduce it (guidance.py does)."""
    style_mean, style_std = calc_mean_std(style, eps=style_eps)
    content_mean, content_std = calc_mean_std(content)
    return (content - content_mean) / content_std * style_std + style_mean
