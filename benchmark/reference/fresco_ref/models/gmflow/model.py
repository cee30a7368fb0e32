"""GMFlow optical flow (transformer matching), PyTorch/NHWC.

Counterpart of ``fresco_tpu/models/gmflow/model.py`` (reference
src/ebsynth/deps/gmflow/gmflow/) in the configuration FRESCO uses:
one scale, 128 feature channels, 6 transformer layers, shifted-window
attention with ``attn_splits`` 2, global correlation, global flow
propagation, bidirectional prediction, convex upsampling x8.  Module and
parameter names are the Flax ones, so ``models/convert.py`` carries a
Flax tree across.

Every product is a plain ``torch.matmul`` (the JAX package computes them
as einsums outside any Pallas kernel).  The global correlation and the
flow propagation take their softmax in float32 over [2B, hw, hw].

Dtypes: the JAX package's input normalization has a float32 mean and
std, which promotes its whole forward to float32 even when the weights
are cast to ``config.aux_dtype``.  So the port computes in float32 too:
``aux_dtype`` rounds the weights (``build_models`` holds them in float32
after rounding) and the input frames, not the arithmetic.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.fresco_ref.models.layers import Conv2d, Dense, LayerNorm32
from benchmark.reference.fresco_ref.ops.warp import coords_grid


@dataclasses.dataclass(frozen=True)
class GMFlowConfig:
    feature_channels: int = 128
    num_transformer_layers: int = 6
    ffn_dim_expansion: int = 4
    attn_splits: int = 2
    upsample_factor: int = 8

    @staticmethod
    def tiny() -> "GMFlowConfig":
        return GMFlowConfig(feature_channels=16, num_transformer_layers=2)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm over H, W (biased variance)."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.downsample = (Conv2d(in_planes, planes, 1, stride, 0)
                           if stride != 1 or in_planes != planes else None)

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    """7x7/s2 stem + 3 residual stages to 1/8 resolution."""

    def __init__(self, out_dim: int):
        super().__init__()
        dims = [max(out_dim // 2, 4), max(out_dim * 3 // 4, 6), out_dim]
        self.conv1 = Conv2d(3, dims[0], 7, 2, 3, bias=False)
        self.layer1_0 = ResidualBlock(dims[0], dims[0], 1)
        self.layer1_1 = ResidualBlock(dims[0], dims[0], 1)
        self.layer2_0 = ResidualBlock(dims[0], dims[1], 2)
        self.layer2_1 = ResidualBlock(dims[1], dims[1], 1)
        self.layer3_0 = ResidualBlock(dims[1], dims[2], 2)
        self.layer3_1 = ResidualBlock(dims[2], dims[2], 1)
        self.conv2 = Conv2d(dims[2], out_dim, 1, 1, 0)

    def forward(self, x):
        h = F.relu(instance_norm(self.conv1(x)))
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1", "layer3_0", "layer3_1"):
            h = getattr(self, name)(h)
        return self.conv2(h)


def split_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*k*k, H/k, W/k, C], window-row-major (reference
    utils.py order)."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    bkk, h, w, c = x.shape
    b = bkk // (k * k)
    x = x.reshape(b, k, k, h, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, k * h, k * w, c)


def sine_position_embedding(h: int, w: int, num_feats: int, device=None) -> torch.Tensor:
    """Normalized DETR sine embedding [H, W, 2*num_feats]: interleaved
    (sin, cos) pairs, y channels before x."""
    scale = 2 * math.pi
    y = torch.arange(h, dtype=torch.float32, device=device) + 1.0
    x = torch.arange(w, dtype=torch.float32, device=device) + 1.0
    y = y / (y[-1] + 1e-6) * scale
    x = x / (x[-1] + 1e-6) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_feats)
    pos_x = (x[None, :, None] / dim_t).expand(h, w, num_feats)
    pos_y = (y[:, None, None] / dim_t).expand(h, w, num_feats)

    def interleave(p):
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1).reshape(h, w, -1)

    return torch.cat([interleave(pos_y), interleave(pos_x)], dim=-1)


def shifted_window_mask(h: int, w: int, k: int, device=None) -> torch.Tensor:
    """Swin SW-MSA additive mask [k*k, hw_win, hw_win]: -100 between
    tokens of different regions, 0 within one."""
    wh, ww = h // k, w // k
    sh, sw = wh // 2, ww // 2
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(k, wh, k, ww).transpose(0, 2, 1, 3).reshape(k * k, wh * ww)
    diff = win[:, None, :] - win[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0).astype(np.float32)).to(device)


def _softmax_product(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(s) (float32) cast to v's dtype, times v."""
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def window_attention(q, k_, v, *, num_splits: int, h: int, w: int, with_shift: bool, attn_mask=None):
    """Single-head (shifted-)window attention over [B, HW, C] tokens."""
    b, _, c = q.shape
    scale = c ** -0.5
    q, k_, v = (t.reshape(b, h, w, c) for t in (q, k_, v))
    if with_shift:
        sh, sw = (h // num_splits) // 2, (w // num_splits) // 2
        q, k_, v = (torch.roll(t, (-sh, -sw), dims=(1, 2)) for t in (q, k_, v))
    n = b * num_splits ** 2
    qs, ks, vs = (split_windows(t, num_splits).reshape(n, -1, c) for t in (q, k_, v))
    s = torch.matmul(qs, ks.transpose(1, 2)).to(torch.float32) * scale
    if with_shift:
        s = s + attn_mask.repeat(b, 1, 1)
    out = _softmax_product(s, vs)
    out = merge_windows(out.reshape(n, h // num_splits, w // num_splits, c), num_splits)
    if with_shift:
        out = torch.roll(out, (sh, sw), dims=(1, 2))
    return out.reshape(b, h * w, c)


def full_attention(q, k_, v):
    c = q.shape[-1]
    s = torch.matmul(q, k_.transpose(1, 2)).to(torch.float32) * (c ** -0.5)
    return _softmax_product(s, v)


class TransformerLayer(nn.Module):
    """(shifted-)window attention, merge, LayerNorm, and an optional FFN."""

    heads = 1  # single-head attention

    def __init__(self, c: int, no_ffn: bool, ffn_expansion: int, with_shift: bool):
        super().__init__()
        self.no_ffn, self.with_shift = no_ffn, with_shift
        self.q_proj = Dense(c, c, bias=False)
        self.k_proj = Dense(c, c, bias=False)
        self.v_proj = Dense(c, c, bias=False)
        self.merge = Dense(c, c, bias=False)
        self.norm1 = LayerNorm32(c)
        if not no_ffn:
            self.mlp_0 = Dense(2 * c, 2 * c * ffn_expansion, bias=False)
            self.mlp_2 = Dense(2 * c * ffn_expansion, c, bias=False)
            self.norm2 = LayerNorm32(c)

    def forward(self, source, target, *, h, w, num_splits, attn_mask):
        q, k_, v = self.q_proj(source), self.k_proj(target), self.v_proj(target)
        if num_splits > 1:
            msg = window_attention(q, k_, v, num_splits=num_splits, h=h, w=w,
                                   with_shift=self.with_shift, attn_mask=attn_mask)
        else:
            msg = full_attention(q, k_, v)
        msg = self.norm1(self.merge(msg))
        if not self.no_ffn:
            msg = torch.cat([source, msg], dim=-1)
            msg = F.gelu(self.mlp_0(msg), approximate="none")
            msg = self.norm2(self.mlp_2(msg))
        return source + msg


class FeatureTransformer(nn.Module):
    """``num_layers`` blocks of (self-attention, cross-attention + FFN),
    odd blocks shifted."""

    def __init__(self, c: int, num_layers: int, ffn_expansion: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            shift = i % 2 == 1
            setattr(self, f"layers_{i}_self_attn", TransformerLayer(c, True, ffn_expansion, shift))
            setattr(self, f"layers_{i}_cross_attn_ffn", TransformerLayer(c, False, ffn_expansion, shift))

    def forward(self, feat0, feat1, *, num_splits: int):
        b, h, w, c = feat0.shape
        attn_mask = shifted_window_mask(h, w, num_splits, feat0.device) if num_splits > 1 else None
        concat0 = torch.cat([feat0, feat1], dim=0).reshape(2 * b, h * w, c)
        concat1 = torch.cat([feat1, feat0], dim=0).reshape(2 * b, h * w, c)
        kw = dict(h=h, w=w, num_splits=num_splits, attn_mask=attn_mask)
        for i in range(self.num_layers):
            concat0 = getattr(self, f"layers_{i}_self_attn")(concat0, concat0, **kw)
            concat0 = getattr(self, f"layers_{i}_cross_attn_ffn")(concat0, concat1, **kw)
            f0, f1 = concat0.chunk(2, dim=0)
            concat1 = torch.cat([f1, f0], dim=0)
        f0, f1 = concat0.chunk(2, dim=0)
        return f0.reshape(b, h, w, c), f1.reshape(b, h, w, c)


def global_correlation_softmax(feat0, feat1, bidir: bool):
    """Softmax global matching: flow [B (x2 with bidir), h, w, 2] as
    (dx, dy).  The correlation is float32 products of the features'
    values (exact for bfloat16 features)."""
    b, h, w, c = feat0.shape
    f0 = feat0.reshape(b, h * w, c).to(torch.float32)
    f1 = feat1.reshape(b, h * w, c).to(torch.float32)
    corr = torch.matmul(f0, f1.transpose(1, 2)) / (c ** 0.5)
    grid = coords_grid(h, w, device=feat0.device)
    if bidir:
        corr = torch.cat([corr, corr.transpose(1, 2)], dim=0)
    prob = torch.softmax(corr, dim=-1)
    del corr
    correspondence = torch.matmul(prob, grid.reshape(1, h * w, 2))
    return correspondence.reshape(-1, h, w, 2) - grid[None]


class FeatureFlowAttention(nn.Module):
    """Global flow propagation: query q_proj(feature), key k_proj(q) (the
    reference's quirk: the key projects the projected query), value the
    flow.  Unlike the transformer's projections these have biases."""

    heads = 1

    def __init__(self, c: int):
        super().__init__()
        self.q_proj = Dense(c, c)
        self.k_proj = Dense(c, c)

    def forward(self, feature, flow):
        b, h, w, c = feature.shape
        q = self.q_proj(feature.reshape(b, h * w, c))
        k_ = self.k_proj(q)
        s = torch.matmul(q, k_.transpose(1, 2)) / (c ** 0.5)
        out = torch.matmul(torch.softmax(s, dim=-1), flow.reshape(b, h * w, 2))
        return out.reshape(b, h, w, 2)


class GMFlow(nn.Module):
    def __init__(self, cfg: GMFlowConfig = GMFlowConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.feature_channels
        self.backbone = CNNEncoder(c)
        self.transformer = FeatureTransformer(c, cfg.num_transformer_layers, cfg.ffn_dim_expansion)
        self.feature_flow_attn = FeatureFlowAttention(c)
        self.upsampler_0 = Conv2d(2 + c, 256, 3, 1, 1)
        self.upsampler_2 = Conv2d(256, cfg.upsample_factor ** 2 * 9, 1, 1, 0)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0/img1 [B, H, W, 3] in [0, 255] -> flow [2B, H, W, 2]:
        forward (img0 -> img1), then backward; float32.  Differentiable
        (``parallel/flow_train.py`` trains through it); inference callers
        hold their own ``torch.no_grad()``."""
        c = self.cfg
        dev = img0.device
        mean = torch.tensor([0.485, 0.456, 0.406], device=dev) * 255.0
        std = torch.tensor([0.229, 0.224, 0.225], device=dev) * 255.0
        x = (torch.cat([img0, img1], dim=0) - mean) / std
        feat = self.backbone(x)
        b = img0.shape[0]
        feat0, feat1 = feat[:b], feat[b:]

        h, w = feat0.shape[1:3]
        k = c.attn_splits
        pos = sine_position_embedding(h // k, w // k, c.feature_channels // 2, dev)
        pos_full = merge_windows(pos[None].repeat(k * k, 1, 1, 1), k)
        feat0, feat1 = feat0 + pos_full, feat1 + pos_full
        feat0, feat1 = self.transformer(feat0, feat1, num_splits=k)

        flow = global_correlation_softmax(feat0, feat1, bidir=True)
        feat_cat = torch.cat([feat0, feat1], dim=0)
        flow = self.feature_flow_attn(feat_cat, flow)

        # convex upsampling: softmax over the 9 neighbours of each coarse
        # pixel, ordered (i, j) row-major, then a (0,1,3,2,4,5) transpose
        up = c.upsample_factor
        concat = torch.cat([flow, feat_cat], dim=-1)
        mask = self.upsampler_2(F.relu(self.upsampler_0(concat)))
        bb, hh, ww, _ = flow.shape
        mask = torch.softmax(mask.reshape(bb, hh, ww, 9, up * up), dim=3)
        flow_pad = F.pad(flow * up, (0, 0, 1, 1, 1, 1))
        patches = torch.stack([flow_pad[:, i : i + hh, j : j + ww] for i in range(3) for j in range(3)], dim=3)
        up_flow = torch.einsum("bhwku,bhwkc->bhwuc", mask, patches)
        up_flow = up_flow.reshape(bb, hh, ww, up, up, 2).permute(0, 1, 3, 2, 4, 5)
        return up_flow.reshape(bb, hh * up, ww * up, 2)
