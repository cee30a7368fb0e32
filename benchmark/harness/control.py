"""The control of the check: the reference computed one precision lower.

The configuration states bfloat16 for the UNet, the ControlNet and the
VAE, so the control computes them in fp8 (e4m3): ``fp8_`` rounds every
convolution and dense layer's weight to e4m3 under a per-tensor scale, in
place, and rounds each such layer's input the same way before it runs.
The check has to find the control's keyframes not correct.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, in ``x``'s dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _round_input(module, args):
    return (to_e4m3(args[0]),) + tuple(args[1:])


@torch.no_grad()
def fp8_(*models: torch.nn.Module) -> None:
    """Weights and inputs of every convolution and dense layer of ``models`` in e4m3."""
    for model in models:
        for m in model.modules():
            w = getattr(m, "weight", None)
            if isinstance(w, torch.nn.Parameter) and w.ndim in (2, 4) and type(m).__name__ in ("Conv2d", "Dense"):
                w.copy_(to_e4m3(w))
                m.register_forward_pre_hook(_round_input)
