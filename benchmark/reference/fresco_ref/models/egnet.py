"""EGNet salient-object detection (ResNet-50 variant), PyTorch/NHWC.

Counterpart of ``fresco_tpu/models/egnet.py`` (reference src/EGNet/model.py
``build_model('resnet')`` with the frozen-BatchNorm ResNet-50 of
src/EGNet/resnet.py): backbone features at 1/2 .. 1/16 -> 1x1 converts ->
MergeLayer1 (top-down saliency features and the edge feature) ->
MergeLayer2 (fused scores).  ``forward`` returns every head, as the JAX
module does; FRESCO reads only the last fused score (reference
src/utils.py:98-99), and ``final_score`` computes just that path: it
skips the nine score convolutions and full-resolution resizes of the
other heads, which the JAX package drops through XLA's dead-code
elimination.

Inference only: BatchNorms are frozen running-stats affine maps.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.fresco_ref.models.layers import Conv2d
from benchmark.reference.fresco_ref.ops.morphology import dilate
from benchmark.reference.fresco_ref.ops.resize import resize_bilinear

SOD_MEAN_BGR = np.array([104.00699, 116.66877, 122.67892], np.float32)


class FrozenBN(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.mean = nn.Parameter(torch.zeros(c))
        self.var = nn.Parameter(torch.ones(c))

    def flax_init(self, gen=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        inv = torch.rsqrt(self.var + self.eps) * self.weight
        return x * inv + (self.bias - self.mean * inv)


def _maxpool_ceil(x: torch.Tensor, k: int = 3, s: int = 2, p: int = 1) -> torch.Tensor:
    """``MaxPool2d(k, s, p, ceil_mode=True)`` on NHWC (resnet.py:120)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s, p, ceil_mode=True).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, dilation: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 1, stride, 0, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, dilation, bias=False, dilation=dilation)
        self.bn2 = FrozenBN(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, 1, 0, bias=False)
        self.bn3 = FrozenBN(planes * 4)
        if has_downsample:
            self.downsample_conv = Conv2d(in_ch, planes * 4, 1, stride, 0, bias=False)
            self.downsample_bn = FrozenBN(planes * 4)
        self.has_downsample = has_downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + out)


RESNET_SPECS = ((64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 2, 1), (512, 3, 1, 2))  # planes, blocks, stride, dilation


class ResNet50Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(64)
        in_ch = 64
        for li, (planes, blocks, stride, dil) in enumerate(RESNET_SPECS, start=1):
            for b in range(blocks):
                setattr(self, f"layer{li}_{b}",
                        Bottleneck(in_ch, planes, stride if b == 0 else 1, dil, b == 0))
                in_ch = planes * 4

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        feats = [h]
        h = _maxpool_ceil(h)
        for li, (_, blocks, _, _) in enumerate(RESNET_SPECS, start=1):
            for b in range(blocks):
                h = getattr(self, f"layer{li}_{b}")(h)
            feats.append(h)
        return feats


class _ConvRelu(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, bias: bool = False):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, 1, (kernel - 1) // 2, bias=bias)

    def forward(self, x):
        return F.relu(self.conv(x))


class _UpBlock(nn.Module):
    """3 x (conv k + relu) (model.py:50)."""

    def __init__(self, in_ch: int, ch: int, kernel: int):
        super().__init__()
        pad = (kernel - 1) // 2
        self.conv_0 = Conv2d(in_ch, ch, kernel, 1, pad)
        self.conv_1 = Conv2d(ch, ch, kernel, 1, pad)
        self.conv_2 = Conv2d(ch, ch, kernel, 1, pad)

    def forward(self, x):
        for c in (self.conv_0, self.conv_1, self.conv_2):
            x = F.relu(c(x))
        return x


def _up(x, size_hw):
    return resize_bilinear(x, tuple(size_hw), align_corners=True)


BACKBONE_CH = (64, 256, 512, 1024, 2048)


class EGNet(nn.Module):
    """``forward`` returns (up_edge, up_sal, up_score) like TUN_bone.forward."""

    convert_out = (128, 256, 512, 512, 512)
    # (trans out, unused, up channels, up kernel) per level (config_resnet, model.py:15)
    merge1 = ((128, 256, 128, 3), (256, 512, 256, 3), (512, 0, 512, 5), (512, 0, 512, 5), (512, 0, 512, 7))
    merge2_ch = 128
    merge2_kernels = (3, 5, 5, 7)

    def __init__(self):
        super().__init__()
        self.base = ResNet50Backbone()
        for i in range(5):
            setattr(self, f"convert_{i}", _ConvRelu(BACKBONE_CH[i], self.convert_out[i]))
        m1 = self.merge1
        self.m1_up_4 = _UpBlock(self.convert_out[4], m1[4][2], m1[4][3])
        self.m1_score_4 = Conv2d(m1[4][2], 1, 3, 1, 1)
        u_ch = m1[4][2]
        for i in (3, 2, 1):
            if self.convert_out[i] < u_ch:
                setattr(self, f"m1_trans_{i}", _ConvRelu(u_ch, m1[i][0]))
            setattr(self, f"m1_up_{i}", _UpBlock(self.convert_out[i], m1[i][2], m1[i][3]))
            setattr(self, f"m1_score_{i}", Conv2d(m1[i][2], 1, 3, 1, 1))
            u_ch = m1[i][2]
        self.m1_trans_final = _ConvRelu(m1[4][2], 128)
        self.m1_up_0 = _UpBlock(self.convert_out[0], m1[0][2], m1[0][3])
        self.m1_score_0 = Conv2d(m1[0][2], 1, 3, 1, 1)
        # sal_feature order is levels 4, 3, 2, 1; MergeLayer2 reads it reversed
        sal_ch = [m1[i][2] for i in (1, 2, 3, 4)]
        for j in range(4):
            setattr(self, f"m2_trans_{j}", _ConvRelu(sal_ch[j], self.merge2_ch))
            setattr(self, f"m2_up_{j}", _UpBlock(self.merge2_ch, self.merge2_ch, self.merge2_kernels[j]))
            setattr(self, f"m2_score_{j}", Conv2d(self.merge2_ch, 1, 3, 1, 1))
        self.m2_final_0 = Conv2d(self.merge2_ch, self.merge2_ch, 5, 1, 2)
        self.m2_final_1 = Conv2d(self.merge2_ch, 1, 3, 1, 1)

    def _merge1(self, x):
        """MergeLayer1's features: (sal_feature [levels 4, 3, 2, 1], edge_feat)."""
        feats = self.base(x)
        conv = [getattr(self, f"convert_{i}")(feats[i]) for i in range(5)]
        tmp = self.m1_up_4(conv[4])
        sal_feature = [tmp]
        u = tmp
        for i in (3, 2, 1):
            if conv[i].shape[-1] < u.shape[-1]:
                u = conv[i] + _up(getattr(self, f"m1_trans_{i}")(u), conv[i].shape[1:3])
            else:
                u = conv[i] + _up(u, conv[i].shape[1:3])
            u = getattr(self, f"m1_up_{i}")(u)
            sal_feature.append(u)
        u = conv[0] + _up(self.m1_trans_final(sal_feature[0]), conv[0].shape[1:3])
        return sal_feature, self.m1_up_0(u)

    def _merge2_features(self, sal_feature, edge_feat):
        sal_rev = sal_feature[::-1]
        tmp_features = []
        for j in range(4):
            t = _up(getattr(self, f"m2_trans_{j}")(sal_rev[j]), edge_feat.shape[1:3]) + edge_feat
            tmp_features.append(getattr(self, f"m2_up_{j}")(t))
        return tmp_features

    def _final(self, tmp_features, x_size):
        acc = tmp_features[0]
        for tf in tmp_features[1:]:
            acc = F.relu(acc + _up(tf, tmp_features[0].shape[1:3]))
        final = self.m2_final_1(F.relu(self.m2_final_0(acc)))
        return _up(final, x_size)

    @torch.no_grad()
    def forward(self, x):
        x_size = x.shape[1:3]
        sal_feature, edge_feat = self._merge1(x)
        up_sal = [_up(self.m1_score_4(sal_feature[0]), x_size)]
        up_sal += [_up(getattr(self, f"m1_score_{i}")(f), x_size) for i, f in zip((3, 2, 1), sal_feature[1:])]
        up_edge = [_up(self.m1_score_0(edge_feat), x_size)]
        tmp_features = self._merge2_features(sal_feature, edge_feat)
        up_score = [_up(getattr(self, f"m2_score_{j}")(tf), x_size) for j, tf in enumerate(tmp_features)]
        up_score.append(self._final(tmp_features, x_size))
        return up_edge, up_sal, up_score

    @torch.no_grad()
    def final_score(self, x):
        """``forward(x)[2][-1]`` alone: the one head FRESCO reads."""
        sal_feature, edge_feat = self._merge1(x)
        return self._final(self._merge2_features(sal_feature, edge_feat), x.shape[1:3])


def saliency_input(imgs_rgb: np.ndarray, device=None) -> torch.Tensor:
    """uint8 RGB [F, H, W, 3] -> EGNet input [F, H/2, W/2, 3] float32: BGR
    minus the mean, halved by half-pixel bilinear without antialiasing
    (reference src/utils.py:26-31)."""
    x = torch.as_tensor(np.ascontiguousarray(imgs_rgb[..., ::-1]), device=device).to(torch.float32)
    x = x - torch.from_numpy(SOD_MEAN_BGR).to(x.device)
    h, w = x.shape[1:3]
    return resize_bilinear(x, (h // 2, w // 2))


def saliency_background_mask(egnet: EGNet, imgs_rgb, dilate_kernel: int = 7) -> torch.Tensor:
    """Background mask 1 - dilate(sigmoid(final score)), [F, H/2, W/2, 1]
    float32 on the model's device (reference src/utils.py:95-102).  The
    forward runs in the model's dtype; sigmoid and dilation in float32."""
    p = next(egnet.parameters())
    x = saliency_input(np.asarray(imgs_rgb), p.device).to(p.dtype)
    sal = torch.sigmoid(egnet.final_score(x).to(torch.float32))
    return 1.0 - dilate(sal, dilate_kernel)


def make_saliency_fn(egnet: EGNet, dilate_kernel: int = 7):
    """imgs_rgb uint8 [F, H, W, 3] -> background mask (``saliency_background_mask``);
    ``.args[0]`` is the model."""
    return functools.partial(saliency_background_mask, egnet, dilate_kernel=dilate_kernel)
