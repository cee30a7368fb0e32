"""Numerical-health guards.  Counterpart of ``fresco_tpu/utils/guards.py``:
a batch whose latents are not finite fails fast with a useful message."""
from __future__ import annotations

import torch


class NumericalHealthError(RuntimeError):
    pass


def check_finite(name: str, *tensors) -> None:
    """Raise if any tensor holds a non-finite value.  Synchronizes with
    the device: call once per batch."""
    for i, t in enumerate(tensors):
        if t is None:
            continue
        t = torch.as_tensor(t)
        bad = ~torch.isfinite(t)
        n_bad = int(bad.sum())
        if n_bad:
            raise NumericalHealthError(
                f"{name}[{i}]: {n_bad}/{t.numel()} non-finite values "
                f"(dtype {t.dtype}, shape {tuple(t.shape)})")
