"""Farneback optical flow through OpenCV on the host, as a flow function.

Counterpart of ``fresco_tpu/utils/classic_flow.py``.  The CLI uses it as
the propagation stage's flow source when there is no GMFlow checkpoint
(random GMFlow weights give flows whose forward-backward check fails
almost everywhere).  It needs ``cv2``; without it, ``pairwise_flow_fn``
raises and names what is missing.

Contract: ``flow_fn(a, b)`` on float [N, H, W, 3] frame pairs in
[0, 255] returns float32 [2N, H, W, 2] on the frames' device: the N
forward flows (a -> b), then the N backward ones, channels (dx, dy).
"""
from __future__ import annotations

import numpy as np
import torch


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("Farneback flow needs OpenCV (cv2), which is not importable here; "
                          "use GMFlow (ModelBundle.gmflow) as the flow source") from e
    return cv2


def farneback_pair(img0: np.ndarray, img1: np.ndarray) -> np.ndarray:
    """Dense flow img0 -> img1 of uint8 RGB frames, [H, W, 2] float32."""
    cv2 = _cv2()
    g0 = cv2.cvtColor(img0, cv2.COLOR_RGB2GRAY)
    g1 = cv2.cvtColor(img1, cv2.COLOR_RGB2GRAY)
    return cv2.calcOpticalFlowFarneback(g0, g1, None, pyr_scale=0.5, levels=4, winsize=21,
                                        iterations=3, poly_n=5, poly_sigma=1.1, flags=0).astype(np.float32)


def pairwise_flow_fn():
    """A flow function over frame pairs, Farneback on the host."""
    _cv2()

    def flow_fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a8 = a.clamp(0, 255).to(torch.uint8).cpu().numpy()
        b8 = b.clamp(0, 255).to(torch.uint8).cpu().numpy()
        fwd = [farneback_pair(x, y) for x, y in zip(a8, b8)]
        bwd = [farneback_pair(y, x) for x, y in zip(a8, b8)]
        return torch.from_numpy(np.stack(fwd + bwd)).to(a.device)

    return flow_fn
