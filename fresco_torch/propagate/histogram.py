"""Lab-space contrast-preserving histogram blend, in torch.

Counterpart of ``fresco_tpu/propagate/histogram.py`` (reference
src/ebsynth/blender/histogram_blend.py): both propagated candidates are
normalized to a common Lab target distribution, combined with contrast
restoration, then matched to the min-error image's statistics.  The
statistics and transforms run in float64, as numpy computes them there;
std is the population std, and the result is rounded half to even and
clipped, as ``np.round`` then ``np.clip``.
"""
from __future__ import annotations

import torch

from fresco_torch.propagate.color import bgr2lab, lab2bgr


def _stats(x: torch.Tensor):
    x = x.double()
    return x.mean(dim=(0, 1)), x.std(dim=(0, 1), correction=0)


def _transform(x, mean, std, t_mean, t_std):
    return (x.double() - mean) * t_std / std + t_mean


def histogram_blend(a: torch.Tensor, b: torch.Tensor, min_error: torch.Tensor,
                    weight1: float = 0.5, weight2: float = 0.5) -> torch.Tensor:
    """a/b/min_error: uint8 [H, W, 3] BGR.  Returns the uint8 BGR blend
    (histogram_blend.py:19-50)."""
    a_l, b_l, me_l = bgr2lab(a), bgr2lab(b), bgr2lab(min_error)
    a_m, a_s = _stats(a_l)
    b_m, b_s = _stats(b_l)
    me_m, me_s = _stats(me_l)
    # the JAX package's target statistics are float32 constants
    t_mean = torch.tensor(0.5 * 256, dtype=torch.float32).double()
    t_std = torch.tensor(256 / 36, dtype=torch.float32).double()
    a_n = _transform(a_l, a_m, a_s, t_mean, t_std)
    b_n = _transform(b_l, b_m, b_s, t_mean, t_std)
    ab = (a_n * weight1 + b_n * weight2 - 0.5 * 256) / 0.5 + 0.5 * 256
    ab_m, ab_s = _stats(ab)
    ab = _transform(ab, ab_m, ab_s, me_m, me_s)
    return lab2bgr(torch.round(ab).clamp(0, 255).to(torch.uint8))
