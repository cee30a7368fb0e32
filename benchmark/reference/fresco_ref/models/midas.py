"""MiDaS DPT-hybrid depth estimator, PyTorch/NHWC.

Counterpart of ``fresco_tpu/models/midas.py`` (reference
src/ControlNet/annotator/midas/): a BiT ResNetV2 stem (weight-standardized
convolutions, GroupNorm, pre-activation bottlenecks, stages [3, 4, 9])
feeding 1/16 tokens to a ViT-B/16 whose learned positions are resized
bilinearly to the input grid; DPT reassembly (stem stages 0 / 1 at 1/4 and
1/8, ViT blocks 8 and 11 through the 'project' readout at 1/16 and 1/32,
taken before the final LayerNorm, which is kept for conversion only); four
fusion blocks with align-corners upsampling, and a non-negative head.  The
ViT's attention is plain float32 softmax attention, as in the JAX package
(no Pallas kernel there, none here).

``midas_detector`` is the annotator's host side without OpenCV: the
INTER_LINEAR resize is ``propagate/guides.py``'s copy of OpenCV's
arithmetic, the Sobel filter a reflect-101 3x3 stencil.  Runs in float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.fresco_ref.models.layers import Conv2d, Dense, GroupNorm32, LayerNorm32
from benchmark.reference.fresco_ref.ops.resize import resize_bilinear
from benchmark.reference.fresco_ref.propagate.guides import _resize_linear

CHECKPOINT = "dpt_hybrid-midas-501f0c75.pt"


class StdConv(Conv2d):
    """Weight-standardized convolution (BiT, timm ``StdConv2d``): each
    output channel's kernel less its mean, over the square root of its
    biased variance plus 1e-6."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__(in_ch, out_ch, kernel, stride, padding, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight
        var, mean = torch.var_mean(k, dim=(1, 2, 3), keepdim=True, correction=0)
        k = (k - mean) * torch.rsqrt(var + 1e-6)
        y = F.conv2d(x.permute(0, 3, 1, 2), k, None, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


def GN(channels: int) -> GroupNorm32:
    """GroupNorm with min(32, C) groups, eps 1e-5."""
    return GroupNorm32(channels, min(32, channels), 1e-5)


class PreActBottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        self.norm1 = GN(cin)
        self.downsample_conv = StdConv(cin, out, 1, stride) if has_downsample else None
        self.conv1 = StdConv(cin, mid, 1)
        self.norm2 = GN(mid)
        self.conv2 = StdConv(mid, mid, 3, stride, 1)
        self.norm3 = GN(mid)
        self.conv3 = StdConv(mid, out, 1)

    def forward(self, x):
        pre = F.relu(self.norm1(x))
        shortcut = x if self.downsample_conv is None else self.downsample_conv(pre)
        h = self.conv1(pre)
        h = self.conv2(F.relu(self.norm2(h)))
        h = self.conv3(F.relu(self.norm3(h)))
        return h + shortcut


class ResNetV2Stem(nn.Module):
    """BiT-R50 trunk (3 stages): returns (stage 0 at 1/4, stage 1 at 1/8,
    stage 2 at 1/16)."""

    def __init__(self, widths=(256, 512, 1024), depths=(3, 4, 9)):
        super().__init__()
        self.widths, self.depths = tuple(widths), tuple(depths)
        self.stem_conv = StdConv(3, 64, 7, 2, 3)
        self.stem_norm = GN(64)
        cin = 64
        for si, (w, d) in enumerate(zip(self.widths, self.depths)):
            for b in range(d):
                stride = (1 if si == 0 else 2) if b == 0 else 1
                setattr(self, f"stage{si}_block{b}",
                        PreActBottleneck(cin, w // 4, w, stride, has_downsample=b == 0))
                cin = w

    def forward(self, x):
        h = F.relu(self.stem_norm(self.stem_conv(x)))
        # 'same' 3x3/2 max pool, padded with -inf (timm's stem pool)
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
        feats = []
        for si, d in enumerate(self.depths):
            for b in range(d):
                h = getattr(self, f"stage{si}_block{b}")(h)
            feats.append(h)
        return feats


class ViTBlock(nn.Module):
    """Pre-LN ViT block: float32 softmax attention, exact-GELU MLP."""

    def __init__(self, dim: int = 768, heads: int = 12, mlp: int = 3072):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm32(dim, 1e-6)
        self.qkv = Dense(dim, dim * 3)
        self.proj = Dense(dim, dim)
        self.norm2 = LayerNorm32(dim, 1e-6)
        self.fc1 = Dense(dim, mlp)
        self.fc2 = Dense(mlp, dim)

    def forward(self, x):
        b, s, dim = x.shape
        d = dim // self.heads
        q, k, v = (t.reshape(b, s, self.heads, d).transpose(1, 2)
                   for t in self.qkv(self.norm1(x)).chunk(3, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)).float() * (d ** -0.5)
        o = torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)
        x = x + self.proj(o.transpose(1, 2).reshape(b, s, dim))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int = 256):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, 1, 1)
        self.conv2 = Conv2d(features, features, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    """FeatureFusionBlock_custom, bn=False, align_corners=True; the
    coarsest block has no skip input and so no ``res1``."""

    def __init__(self, features: int = 256, has_skip: bool = True):
        super().__init__()
        self.res1 = ResidualConvUnit(features) if has_skip else None
        self.res2 = ResidualConvUnit(features)
        self.out_conv = Conv2d(features, features, 1, 1, 0)

    def forward(self, x, skip=None):
        out = x if skip is None else x + self.res1(skip)
        out = self.res2(out)
        h, w = out.shape[1:3]
        return self.out_conv(resize_bilinear(out, (h * 2, w * 2), align_corners=True))


class DPTHybridDepth(nn.Module):
    def __init__(self, vit_dim: int = 768, vit_depth: int = 12, hooks=(8, 11), features: int = 256,
                 grid_size_train: int = 24, stem_widths=(256, 512, 1024), stem_depths=(3, 4, 9)):
        super().__init__()
        self.vit_dim, self.vit_depth, self.hooks = vit_dim, vit_depth, tuple(hooks)
        self.grid_size_train = grid_size_train
        self.backbone = ResNetV2Stem(stem_widths, stem_depths)
        self.patch_proj = Conv2d(stem_widths[-1], vit_dim, 1, 1, 0)
        self.cls_token = nn.Parameter(torch.empty(1, 1, vit_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, grid_size_train ** 2 + 1, vit_dim))
        for i in range(vit_depth):
            setattr(self, f"block_{i}", ViTBlock(vit_dim, max(vit_dim // 64, 1), vit_dim * 4))
        # the checkpoint's final LayerNorm: the hooks fire before it, so
        # the forward never applies it
        self.vit_norm = LayerNorm32(vit_dim, 1e-6)
        self.readout3 = Dense(2 * vit_dim, vit_dim)
        self.post3_conv = Conv2d(vit_dim, vit_dim, 1, 1, 0)
        self.readout4 = Dense(2 * vit_dim, vit_dim)
        self.post4_conv = Conv2d(vit_dim, vit_dim, 1, 1, 0)
        self.post4_down = Conv2d(vit_dim, vit_dim, 3, 2, 1)
        f = features
        for i, cin in enumerate((stem_widths[0], stem_widths[1], vit_dim, vit_dim)):
            setattr(self, f"layer{i + 1}_rn", Conv2d(cin, f, 3, 1, 1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FusionBlock(f, has_skip=i < 4))
        self.head_conv1 = Conv2d(f, f // 2, 3, 1, 1)
        self.head_conv2 = Conv2d(f // 2, 32, 3, 1, 1)
        self.head_conv3 = Conv2d(32, 1, 1, 1, 0)

    def flax_init(self, gen=None) -> None:
        """Flax's zeros for the class token and N(0, 0.02) positions."""
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def _readout(self, t: torch.Tensor, dense: Dense, gh: int, gw: int) -> torch.Tensor:
        """The 'project' readout: each patch token with the class token, a
        Dense, exact GELU, back to the grid."""
        cls = t[:, :1].expand_as(t[:, 1:])
        proj = F.gelu(dense(torch.cat([t[:, 1:], cls], dim=-1)))
        return proj.reshape(t.shape[0], gh, gw, self.vit_dim)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] in [-1, 1], H and W multiples of 32 -> depth
        [B, H, W], non-negative."""
        b, H, W, _ = x.shape
        gh, gw, g = H // 16, W // 16, self.grid_size_train
        s0, s1, s2 = self.backbone(x)
        tokens = self.patch_proj(s2).reshape(b, gh * gw, self.vit_dim)
        pos_grid = resize_bilinear(self.pos_embed[0, 1:].reshape(1, g, g, self.vit_dim), (gh, gw))
        pos = torch.cat([self.pos_embed[:, :1], pos_grid.reshape(1, gh * gw, self.vit_dim)], dim=1)
        h = torch.cat([self.cls_token.expand(b, 1, self.vit_dim), tokens], dim=1) + pos
        hooked = {}
        for i in range(self.vit_depth):
            h = getattr(self, f"block_{i}")(h)
            if i in self.hooks:
                hooked[i] = h
        l3 = self.post3_conv(self._readout(hooked[self.hooks[0]], self.readout3, gh, gw))
        l4 = self.post4_down(self.post4_conv(self._readout(hooked[self.hooks[1]], self.readout4, gh, gw)))

        r1, r2, r3, r4 = self.layer1_rn(s0), self.layer2_rn(s1), self.layer3_rn(l3), self.layer4_rn(l4)
        p = self.refinenet4(r4)
        p = self.refinenet3(p, r3)
        p = self.refinenet2(p, r2)
        p = self.refinenet1(p, r1)
        h = self.head_conv1(p)
        hh, ww = h.shape[1:3]
        h = resize_bilinear(h, (hh * 2, ww * 2), align_corners=True)
        h = F.relu(self.head_conv3(F.relu(self.head_conv2(h))))
        return h[..., 0]


# ---------------------------------------------------------------- weights
def _depth(model: DPTHybridDepth, img: np.ndarray) -> torch.Tensor:
    """uint8 RGB [h, w, 3] -> float32 depth [h, w] on the model's device:
    zero-padded to multiples of 32 in [-1, 1] space, and the whole padded
    map resized to (h, w) with OpenCV's INTER_LINEAR arithmetic."""
    dev = model.pos_embed.device
    h, w = img.shape[:2]
    H, W = -(-h // 32) * 32, -(-w // 32) * 32
    x = torch.zeros((1, H, W, 3), dtype=torch.float32, device=dev)
    x[0, :h, :w] = torch.as_tensor(np.ascontiguousarray(img), device=dev).float() / 127.5 - 1.0
    depth = model(x)[0]
    return _resize_linear(depth[..., None], h, w)[..., 0]


def _depth_image(depth: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(min-max normalized depth d, d * 255 truncated to uint8)."""
    d = depth - depth.min()
    d = d / torch.clamp(d.max(), min=1e-6)
    return d, (d * 255.0).clamp(0, 255).to(torch.uint8)


def depth_detector(model: DPTHybridDepth, img: np.ndarray) -> np.ndarray:
    """uint8 RGB [h, w, 3] -> the uint8 depth image [h, w] (the control
    signal of ``controlnet_type: depth``)."""
    return _depth_image(_depth(model, img))[1].cpu().numpy()


def midas_detector(model: DPTHybridDepth, img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 RGB [h, w, 3] -> (depth image [h, w], normal image [h, w, 3]),
    uint8 (MidasDetector.__call__): the normal from a 3x3 Sobel of the
    depth (reflect-101 border), zeroed where the normalized depth is under
    0.1, with z = 2 pi."""
    depth = _depth(model, img)
    d, depth_image = _depth_image(depth)
    p = F.pad(depth[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    dx = p[:, 2:] - p[:, :-2]
    dy = p[2:, :] - p[:-2, :]
    gx = dx[:-2] + 2.0 * dx[1:-1] + dx[2:]
    gy = dy[:, :-2] + 2.0 * dy[:, 1:-1] + dy[:, 2:]
    bg = d < 0.1
    gx, gy = gx.masked_fill(bg, 0.0), gy.masked_fill(bg, 0.0)
    normal = torch.stack([gx, gy, torch.full_like(gx, np.pi * 2.0)], dim=2)
    normal = normal / torch.sum(normal ** 2.0, dim=2, keepdim=True) ** 0.5
    normal_image = (normal * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)
    return depth_image.cpu().numpy(), normal_image.cpu().numpy()
