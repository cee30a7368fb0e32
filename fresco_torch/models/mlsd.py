"""M-LSD line detection (MobileNetV2 FPN), PyTorch/NHWC.

Counterpart of ``fresco_tpu/models/mlsd.py`` (reference
src/ControlNet/annotator/mlsd/: MLSDdetector, MobileV2_MLSD_Large,
utils.py pred_lines).  Inference only: every Conv + BatchNorm pair is
folded into a biased convolution at conversion, in float64 as the JAX
package folds it, so there is no BatchNorm at run time.  The network and
the score / displacement decode (sigmoid, 3x3 max-pool NMS, top 200) run
on the model's device; the thresholding and the line rasterization run on
the host.  No OpenCV: the INTER_AREA resize is ``ops/image.py``'s and the
rasterization ``draw_line`` is ``cv2.line``'s (LINE_8, thickness 1).

Unlike the JAX package's detector, ``mlsd_detector`` catches nothing: an
empty line set already gives a blank map, and a failure on the device
must raise (ROADMAP F16).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fresco_torch.models.layers import Conv2d
from fresco_torch.ops.image import _resize_area
from fresco_torch.ops.resize import resize_bilinear

CHECKPOINT = "mlsd_large_512_fp32.pth"

# MobileNetV2 inverted-residual settings used by MLSD: (expand t, out c, repeats n, stride s)
_IR_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1))
_FPN_SELECTED = (1, 3, 6, 10, 13)


class ConvBNReLU(nn.Module):
    """Conv (BatchNorm folded in) + ReLU6; stride 2 pads (0, 1, 0, 1) and
    then convolves VALID (the TFLite padding)."""

    def __init__(self, cin: int, out: int, kernel: int = 3, stride: int = 1, groups: int = 1):
        super().__init__()
        self.stride = stride
        pad = 0 if stride == 2 else (kernel - 1) // 2
        self.conv = Conv2d(cin, out, kernel, stride, pad, groups=groups)

    def forward(self, x):
        if self.stride == 2:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return torch.clamp(self.conv(x), 0.0, 6.0)


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, expand: int):
        super().__init__()
        hidden = int(round(inp * expand))
        self.residual = stride == 1 and inp == oup
        self.expand = ConvBNReLU(inp, hidden, kernel=1) if expand != 1 else None
        self.dw = ConvBNReLU(hidden, hidden, 3, stride, groups=hidden)
        self.pw = Conv2d(hidden, oup, 1, 1, 0)

    def forward(self, x):
        h = x if self.expand is None else self.expand(x)
        h = self.pw(self.dw(h))
        return x + h if self.residual else h


class _ConvBnAct(nn.Module):
    """Conv (BatchNorm folded in) + ReLU, for the FPN blocks."""

    def __init__(self, cin: int, out: int, kernel: int = 3, dilation: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, out, kernel, 1, (kernel - 1) // 2 * dilation, dilation=dilation)

    def forward(self, x):
        return F.relu(self.conv(x))


class BlockTypeA(nn.Module):
    def __init__(self, in_a: int, in_b: int, out_c1: int, out_c2: int, upscale: bool = True):
        super().__init__()
        self.upscale = upscale
        self.conv1 = _ConvBnAct(in_b, out_c2, kernel=1)
        self.conv2 = _ConvBnAct(in_a, out_c1, kernel=1)

    def forward(self, a, b):
        b = self.conv1(b)
        a = self.conv2(a)
        if self.upscale:
            bh, bw = b.shape[1:3]
            b = resize_bilinear(b, (bh * 2, bw * 2), align_corners=True)
        return torch.cat([a, b], dim=-1)


class BlockTypeB(nn.Module):
    def __init__(self, cin: int, out_c: int):
        super().__init__()
        self.conv1 = _ConvBnAct(cin, cin)
        self.conv2 = _ConvBnAct(cin, out_c)

    def forward(self, x):
        return self.conv2(self.conv1(x) + x)


class BlockTypeC(nn.Module):
    def __init__(self, cin: int, out_c: int):
        super().__init__()
        self.conv1 = _ConvBnAct(cin, cin, dilation=5)
        self.conv2 = _ConvBnAct(cin, cin)
        self.conv3 = Conv2d(cin, out_c, 1, 1, 0)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class MLSDLarge(nn.Module):
    """MobileV2_MLSD_Large: [B, H, W, 4] (RGB and a ones channel, in
    [-1, 1]) -> [B, H/2, W/2, 9]: channel 0 the centre logit, 1:5 the
    displacements (channels 7..15 of the 16-channel head)."""

    def __init__(self):
        super().__init__()
        self.features_0 = ConvBNReLU(4, 32, stride=2)
        idx, cin = 1, 32
        for t, c, n, s in _IR_SETTINGS:
            for i in range(n):
                setattr(self, f"features_{idx}", InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin, idx = c, idx + 1
        self.n_features = idx
        self.block15 = BlockTypeA(64, 96, 64, 64, upscale=False)
        self.block16 = BlockTypeB(128, 64)
        self.block17 = BlockTypeA(32, 64, 64, 64)
        self.block18 = BlockTypeB(128, 64)
        self.block19 = BlockTypeA(24, 64, 64, 64)
        self.block20 = BlockTypeB(128, 64)
        self.block21 = BlockTypeA(16, 64, 64, 64)
        self.block22 = BlockTypeB(128, 64)
        self.block23 = BlockTypeC(64, 16)

    @torch.no_grad()
    def forward(self, x):
        h = self.features_0(x)
        feats = {}
        for idx in range(1, self.n_features):
            h = getattr(self, f"features_{idx}")(h)
            if idx in _FPN_SELECTED:
                feats[idx] = h
        c1, c2, c3, c4, c5 = (feats[i] for i in _FPN_SELECTED)
        x = self.block16(self.block15(c4, c5))
        x = self.block18(self.block17(c3, x))
        x = self.block20(self.block19(c2, x))
        x = self.block22(self.block21(c1, x))
        return self.block23(x)[..., 7:]


# ---------------------------------------------------------------- weights
def fold_bn(w: torch.Tensor, sd, bn: str, conv_bias=None, eps: float = 1e-5):
    """Fold BatchNorm ``bn`` of ``sd`` into the convolution weight ``w``
    (OIHW), in float64 as the JAX package's ``_fold_bn``; float32 out."""
    g, b, mu, var = (torch.as_tensor(sd[f"{bn}.{n}"]).double()
                     for n in ("weight", "bias", "running_mean", "running_var"))
    scale = g / torch.sqrt(var + eps)
    w = torch.as_tensor(w).double() * scale[:, None, None, None]
    b0 = 0.0 if conv_bias is None else torch.as_tensor(conv_bias).double()
    return w.float(), ((b0 - mu) * scale + b).float()


def _conv_bn_pairs():
    """(port module path, checkpoint conv, checkpoint BatchNorm) of every
    folded convolution of ``mlsd_large_512_fp32.pth``."""
    bb = "backbone.features"
    pairs = [("features_0.conv", f"{bb}.0.0", f"{bb}.0.1")]
    idx = 1
    for t, _, n, _ in _IR_SETTINGS:
        for _ in range(n):
            base, d = f"{bb}.{idx}.conv", f"features_{idx}"
            if t == 1:  # no expand: conv.0 = dw (conv, bn), conv.1 = pw, conv.2 = its bn
                pairs += [(f"{d}.dw.conv", f"{base}.0.0", f"{base}.0.1"), (f"{d}.pw", f"{base}.1", f"{base}.2")]
            else:  # conv.0 = expand, conv.1 = dw, conv.2 = pw, conv.3 = its bn
                pairs += [(f"{d}.expand.conv", f"{base}.0.0", f"{base}.0.1"),
                          (f"{d}.dw.conv", f"{base}.1.0", f"{base}.1.1"), (f"{d}.pw", f"{base}.2", f"{base}.3")]
            idx += 1
    for blk in range(15, 24):
        for cv in ("conv1", "conv2"):
            pairs.append((f"block{blk}.{cv}.conv", f"block{blk}.{cv}.0", f"block{blk}.{cv}.1"))
    return pairs


def convert_mlsd(sd, strict: bool = False) -> dict[str, torch.Tensor]:
    """``mlsd_large_512_fp32.pth`` (torch layout, Conv + BatchNorm) -> the
    port's folded state dict (``fresco_tpu/models/mlsd.py:convert_mlsd``).
    A missing key raises ``KeyError``; ``strict`` raises on a checkpoint
    key left unused (BatchNorm's ``num_batches_tracked`` apart)."""
    out, used = {}, set()
    for dst, conv, bn in _conv_bn_pairs():
        bias = sd.get(f"{conv}.bias")
        out[f"{dst}.weight"], out[f"{dst}.bias"] = fold_bn(sd[f"{conv}.weight"], sd, bn, bias)
        used |= {f"{conv}.weight", f"{conv}.bias"} | {f"{bn}.{n}" for n in
                                                       ("weight", "bias", "running_mean", "running_var")}
    out["block23.conv3.weight"] = torch.as_tensor(sd["block23.conv3.weight"]).contiguous()
    out["block23.conv3.bias"] = torch.as_tensor(sd["block23.conv3.bias"]).contiguous()
    used |= {"block23.conv3.weight", "block23.conv3.bias"}
    if strict:
        left = sorted(k for k in set(sd) - used if not k.endswith("num_batches_tracked"))
        if left:
            raise ValueError(f"{len(left)} checkpoint keys not consumed by the converter, e.g. {left[:8]}")
    return out


# ---------------------------------------------------------------- decode
@torch.no_grad()
def decode_center_displacement(out: torch.Tensor, topk: int = 200, ksize: int = 3):
    """out [1, h, w, 9] -> (scores [topk], yx int64 [topk, 2], displacement
    [h, w, 4]): sigmoid, max-pool NMS, the top ``topk`` by a stable
    descending sort, so that ties keep the lower index as
    ``jax.lax.top_k`` does."""
    heat = torch.sigmoid(out[0, :, :, 0])
    pad = (ksize - 1) // 2
    hmax = F.max_pool2d(heat[None, None], ksize, 1, pad)[0, 0]
    heat = torch.where(hmax == heat, heat, torch.zeros_like(heat))
    w = heat.shape[1]
    scores, idx = torch.sort(heat.reshape(-1), descending=True, stable=True)
    scores, idx = scores[:topk], idx[:topk]
    return scores, torch.stack([idx // w, idx % w], dim=-1), out[0, :, :, 1:5]


def pred_lines(img_rgb: np.ndarray, model: MLSDLarge, input_shape=(512, 512), score_thr: float = 0.10,
               dist_thr: float = 20.0) -> np.ndarray:
    """uint8 RGB [h, w, 3] -> lines [N, 4] float32 (x0, y0, x1, y1) in image
    coordinates (utils.py pred_lines)."""
    dev = next(model.parameters()).device
    h, w = img_rgb.shape[:2]
    resized = torch.as_tensor(_resize_area(img_rgb, input_shape[0], input_shape[1]), device=dev)
    x = torch.cat([resized.float(), torch.ones((*input_shape, 1), device=dev)], dim=-1) / 127.5 - 1.0
    scores, yx, disp = (t.cpu().numpy() for t in decode_center_displacement(model(x[None]), 200, 3))

    start, end = disp[:, :, :2], disp[:, :, 2:]
    dist_map = np.sqrt(np.sum((start - end) ** 2, axis=-1))
    segs = []
    for (y, xx), s in zip(yx, scores):
        if s > score_thr and dist_map[y, xx] > dist_thr:
            dxs, dys, dxe, dye = disp[y, xx]
            segs.append([xx + dxs, y + dys, xx + dxe, y + dye])
    if not segs:
        return np.zeros((0, 4), np.float32)
    lines = 2 * np.asarray(segs, np.float32)  # decode resolution -> input resolution
    lines[:, 0::2] *= w / input_shape[1]
    lines[:, 1::2] *= h / input_shape[0]
    return lines


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to [0, w) x [0, h): the clipped end points, or
    None where the segment misses the image."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def draw_line(img: np.ndarray, p0: tuple[int, int], p1: tuple[int, int], value: int = 255) -> None:
    """``cv2.line(img, p0, p1, value, 1)`` (LINE_8) on a uint8 [H, W] map,
    in place: ``clipLine`` where an end point lies outside, then
    ``LineIterator``'s Bresenham walk from the left end point, whose minor
    coordinate after i steps along the major axis is
    ceil((2 i |d_minor| - |d_major|) / (2 |d_major|))."""
    h, w = img.shape[:2]
    x1, y1 = int(p0[0]), int(p0[1])
    x2, y2 = int(p1[0]), int(p1[1])
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    i = np.arange(max(dx, dy) + 1)
    if dy > dx:  # steep: y is the major axis
        minor = -((dy - 2 * dx * i) // (2 * dy))
        img[y1 + sy * i, x1 + minor] = value
    else:
        minor = -((dx - 2 * dy * i) // (2 * dx)) if dx else i * 0
        img[y1 + sy * minor, x1 + i] = value


def mlsd_detector(model: MLSDLarge, img_rgb: np.ndarray, thr_v: float = 0.1, thr_d: float = 0.1,
                  input_shape=(512, 512)) -> np.ndarray:
    """uint8 RGB [h, w, 3] -> uint8 line map [h, w] (MLSDdetector.__call__)."""
    out = np.zeros(img_rgb.shape[:2], np.uint8)
    for x0, y0, x1, y1 in pred_lines(img_rgb, model, input_shape, thr_v, thr_d):
        draw_line(out, (int(x0), int(y0)), (int(x1), int(y1)))
    return out
