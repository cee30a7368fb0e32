"""Guide-channel construction for patch synthesis, in torch on the device.

Counterpart of ``fresco_tpu/propagate/guides.py`` (reference
src/ebsynth/blender/guide.py): four guides with weights [color 6, edge
0.5, temporal 0.5, positional 2].  The JAX package builds them on the host
with OpenCV; the port has no OpenCV, so its filters, warp and resizes are
written here with OpenCV's arithmetic: ``filter2D``'s saturating uint8
result and ``BORDER_REFLECT_101``, ``remap``'s ``INTER_NEAREST`` rounding
(half to even) with a constant 0 border, and ``resize``'s ``INTER_AREA``
(fractional coverage at odd sizes) and ``INTER_LINEAR`` (half-pixel
centres) coefficients.  The one exception is ``inpaint_method="telea"``,
which calls OpenCV's TELEA on the host where ``cv2`` imports (push-pull
stays the default).

Images are uint8 [H, W, 3] tensors; flows float32 [H, W, 2] as (dx, dy);
occlusion masks [H, W], nonzero = occluded.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

GUIDE_WEIGHTS = dict(color=6.0, edge=0.5, temporal=0.5, positional=2.0)


def edge_guide(img: torch.Tensor) -> torch.Tensor:
    """4-neighbour Laplacian [[0,-1,0],[-1,4,-1],[0,-1,0]], reflect-101
    border, saturated to uint8 (``cv2.filter2D``, guide.py:72-76)."""
    x = img.to(torch.int32).permute(2, 0, 1)[None].float()
    p = F.pad(x, (1, 1, 1, 1), mode="reflect")[0].permute(1, 2, 0)
    c = p[1:-1, 1:-1]
    lap = 4 * c - p[:-2, 1:-1] - p[2:, 1:-1] - p[1:-1, :-2] - p[1:-1, 2:]
    return lap.clamp(0, 255).to(torch.uint8)


def positional_first(h: int, w: int, device=None) -> torch.Tensor:
    """Coordinate image: channels (0, x-ramp, y-ramp), truncated to uint8
    from numpy's linspace (guide.py:52-60)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    r, g = (yy * 255).astype(np.uint8), (xx * 255).astype(np.uint8)
    return torch.from_numpy(np.stack([np.zeros_like(r), g, r], axis=2)).to(device)


def warp_nearest(img: torch.Tensor, bwd_flow: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour backward warp, out[p] = img[round(p + flow[p])],
    0 outside (``cv2.remap`` INTER_NEAREST, BORDER_CONSTANT).  Bool masks
    give bool."""
    h, w = img.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device), indexing="ij")
    mx = torch.round(xs + bwd_flow[..., 0].float()).to(torch.int64)  # half to even, as cvRound
    my = torch.round(ys + bwd_flow[..., 1].float()).to(torch.int64)
    inside = (mx >= 0) & (mx < w) & (my >= 0) & (my < h)
    flat = img.reshape(h * w, *img.shape[2:])
    out = flat[(my.clamp(0, h - 1) * w + mx.clamp(0, w - 1)).reshape(-1)].reshape(img.shape)
    keep = inside.reshape(h, w, *([1] * (img.ndim - 2)))
    return torch.where(keep, out, torch.zeros_like(out))


def _area_tab(ssize: int, dsize: int):
    """OpenCV's computeResizeAreaTab: per destination index, the
    (source index, weight) terms in order -> index and weight matrices
    [dsize, T] (padding terms have weight 0)."""
    scale = 1.0 / (dsize / ssize)
    terms = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        terms.append(row)
    t = max(len(r) for r in terms)
    idx = np.zeros((dsize, t), np.int64)
    wts = np.zeros((dsize, t), np.float32)
    for dx, row in enumerate(terms):
        for k, (si, a) in enumerate(row):
            idx[dx, k], wts[dx, k] = si, a
    return idx, wts


def _resize_area(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """``cv2.resize(x, (nw, nh), INTER_AREA)`` for a float32 [H, W, C]
    downscale: the integer-scale path sums each block in row order and
    scales; otherwise the separable fractional-coverage weights, rows
    first, each sum accumulated in OpenCV's term order."""
    h, w = x.shape[:2]
    sy, sx = 1.0 / (nh / h), 1.0 / (nw / w)
    if sy == int(sy) and sx == int(sx):
        ky, kx = int(sy), int(sx)
        blk = x[: nh * ky, : nw * kx].reshape(nh, ky, nw, kx, -1)
        acc = None
        for i in range(ky):
            for j in range(kx):
                acc = blk[:, i, :, j] if acc is None else acc + blk[:, i, :, j]
        return acc * (1.0 / (ky * kx))
    dev = x.device
    xi, xw = (torch.from_numpy(a).to(dev) for a in _area_tab(w, nw))
    yi, yw = (torch.from_numpy(a).to(dev) for a in _area_tab(h, nh))
    buf = torch.zeros((h, nw, x.shape[2]), dtype=torch.float32, device=dev)
    for k in range(xi.shape[1]):
        buf = buf + x[:, xi[:, k]] * xw[:, k][None, :, None]
    out = yw[:, 0][:, None, None] * buf[yi[:, 0]]
    for k in range(1, yi.shape[1]):
        out = out + yw[:, k][:, None, None] * buf[yi[:, k]]
    return out


def _linear_tab(ssize: int, dsize: int, device):
    """OpenCV's INTER_LINEAR source indices and float32 weights."""
    scale = 1.0 / (dsize / ssize)
    i0 = np.zeros(dsize, np.int64)
    f = np.zeros(dsize, np.float32)
    for d in range(dsize):
        fx = float(np.float32((d + 0.5) * scale - 0.5))
        s = math.floor(fx)
        fx -= s
        if s < 0:
            fx, s = 0.0, 0
        if s >= ssize - 1:
            fx, s = 0.0, ssize - 1
        i0[d], f[d] = s, fx
    i0 = torch.from_numpy(i0).to(device)
    f = torch.from_numpy(f).to(device)
    return i0, (i0 + 1).clamp(max=ssize - 1), 1.0 - f, f


def _resize_linear(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """``cv2.resize(x, (nw, nh), INTER_LINEAR)`` for float32 [H, W, C]:
    horizontal then vertical two-tap interpolation."""
    h, w = x.shape[:2]
    x0, x1, ax0, ax1 = _linear_tab(w, nw, x.device)
    y0, y1, ay0, ay1 = _linear_tab(h, nh, x.device)
    rows = x[:, x0] * ax0[None, :, None] + x[:, x1] * ax1[None, :, None]
    return rows[y0] * ay0[:, None, None] + rows[y1] * ay1[:, None, None]


def _telea(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``cv2.inpaint(img, mask*255, 30, INPAINT_TELEA)`` on the host, as the
    JAX package and the reference do (guide.py:40,99-101); the result comes
    back on the input's device."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("inpaint_method='telea' needs OpenCV (cv2), which is not importable here; "
                          "use the default 'pushpull'") from e
    out = cv2.inpaint(np.ascontiguousarray(img.cpu().numpy()), mask.cpu().numpy().astype(np.uint8) * 255,
                      30, cv2.INPAINT_TELEA)
    return torch.from_numpy(out).to(img.device)


def inpaint_occluded(img: torch.Tensor, occ_mask: torch.Tensor, method: str = "pushpull") -> torch.Tensor:
    """Fill the occluded pixels of a uint8 guide image (guides.py:56-91).
    ``pushpull`` (the default): area-downsample the valid pixels and their
    count to 1 pixel, then bilinear-upsample the fill into the holes, on
    the device.  ``telea``: the reference's exact TELEA inpainting, radius
    30, through OpenCV on the host (``_telea``)."""
    if method not in ("pushpull", "telea"):
        raise ValueError(f"inpaint method {method!r}: expected 'pushpull' or 'telea'")
    mask = occ_mask > 0
    if method == "telea":
        return _telea(img, mask)
    valid = (~mask).float()
    acc = img.float() * valid[..., None]
    cnt = valid[..., None]
    stack = []
    while min(acc.shape[:2]) > 1:
        stack.append((acc, cnt))
        nh, nw = max(acc.shape[0] // 2, 1), max(acc.shape[1] // 2, 1)
        acc = _resize_area(acc, nh, nw)
        cnt = _resize_area(cnt, nh, nw)
    fill = acc / cnt.clamp_min(1e-6)
    for acc_l, cnt_l in reversed(stack):
        fill = _resize_linear(fill, acc_l.shape[0], acc_l.shape[1])
        lvl = acc_l / cnt_l.clamp_min(1e-6)
        fill = torch.where(cnt_l > 1e-6, lvl, fill)
    out = torch.where(mask[..., None], fill.clamp(0, 255), img.float())
    return out.to(img.dtype)  # truncation, as numpy's astype


def positional_chain(h: int, w: int, bwd_flows: list, occs: list, method: str = "pushpull",
                     device=None) -> list[torch.Tensor]:
    """Coordinate image warped along the flow chain with inpainting
    (guide.py:26-49).  Returns len(bwd_flows) + 1 guides."""
    imgs = [positional_first(h, w, device)]
    for flow, occ in zip(bwd_flows, occs):
        imgs.append(inpaint_occluded(warp_nearest(imgs[-1], flow), occ, method=method))
    return imgs


def temporal_guide(prev_stylized: torch.Tensor, bwd_flow: torch.Tensor, occ: torch.Tensor,
                   method: str = "pushpull") -> torch.Tensor:
    """Previous stylized frame warped forward + inpainted (guide.py:79-104)."""
    return inpaint_occluded(warp_nearest(prev_stylized, bwd_flow), occ, method=method)
