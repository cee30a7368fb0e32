"""AutoencoderKL (the SD 1.5 VAE), PyTorch, NHWC.

Counterpart of ``fresco_tpu/models/vae.py``: encoder/decoder ResNet
stacks with one single-head mid-block attention (through the flash
kernel, d = 512 at full width), diagonal Gaussian latents, scaling
factor 0.18215.  ``encode`` takes its posterior noise as an argument.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.fresco_ref.attention.flash import flash_attention
from benchmark.reference.fresco_ref.models.layers import Conv2d, Dense, GroupNorm32


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_groups=4)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, groups, 1e-6)
        self.conv1 = Conv2d(in_ch, out_ch)
        self.norm2 = GroupNorm32(out_ch, groups, 1e-6)
        self.conv2 = Conv2d(out_ch, out_ch)
        self.conv_shortcut = Dense(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class MidAttention(nn.Module):
    """Single-head self-attention over the spatial tokens."""

    heads = 1

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm32(ch, groups, 1e-6)
        self.to_q, self.to_k = Dense(ch, ch), Dense(ch, ch)
        self.to_v, self.to_out = Dense(ch, ch), Dense(ch, ch)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        o = flash_attention(self.to_q(y)[:, None], self.to_k(y)[:, None], self.to_v(y)[:, None])
        return x + self.to_out(o[:, 0]).reshape(b, h, w, c)


class Downsample(nn.Module):
    """Stride-2 conv after diffusers' asymmetric (0, 1) padding."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class Encoder(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        self.c = c
        chans = c.block_out_channels
        self.conv_in = Conv2d(c.in_channels, chans[0])
        prev = chans[0]
        for i, ch in enumerate(chans):
            for j in range(c.layers_per_block):
                setattr(self, f"down_{i}_res_{j}", ResnetBlock(prev, ch, c.norm_groups))
                prev = ch
            if i < len(chans) - 1:
                setattr(self, f"down_{i}_downsample", Downsample(ch))
        self.mid_res_0 = ResnetBlock(chans[-1], chans[-1], c.norm_groups)
        self.mid_attn = MidAttention(chans[-1], c.norm_groups)
        self.mid_res_1 = ResnetBlock(chans[-1], chans[-1], c.norm_groups)
        self.conv_norm_out = GroupNorm32(chans[-1], c.norm_groups, 1e-6)
        self.conv_out = Conv2d(chans[-1], 2 * c.latent_channels)

    def forward(self, x):
        c = self.c
        h = self.conv_in(x)
        for i in range(len(c.block_out_channels)):
            for j in range(c.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i < len(c.block_out_channels) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        self.c = c
        chans = list(reversed(c.block_out_channels))
        self.conv_in = Conv2d(c.latent_channels, chans[0])
        self.mid_res_0 = ResnetBlock(chans[0], chans[0], c.norm_groups)
        self.mid_attn = MidAttention(chans[0], c.norm_groups)
        self.mid_res_1 = ResnetBlock(chans[0], chans[0], c.norm_groups)
        prev = chans[0]
        for i, ch in enumerate(chans):
            for j in range(c.layers_per_block + 1):
                setattr(self, f"up_{i}_res_{j}", ResnetBlock(prev, ch, c.norm_groups))
                prev = ch
            if i < len(chans) - 1:
                setattr(self, f"up_{i}_upsample", Upsample(ch))
        self.conv_norm_out = GroupNorm32(chans[-1], c.norm_groups, 1e-6)
        self.conv_out = Conv2d(chans[-1], c.in_channels)

    def forward(self, z):
        c = self.c
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(self.conv_in(z))))
        n = len(c.block_out_channels)
        for i in range(n):
            for j in range(c.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i < n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Dense(2 * cfg.latent_channels, 2 * cfg.latent_channels)
        self.post_quant_conv = Dense(cfg.latent_channels, cfg.latent_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode_moments(self, x):
        """x [B,H,W,3] in [-1,1] -> (mean, logvar) [B,H/8,W/8,4]."""
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x, noise: torch.Tensor | None = None):
        """Scaled latent: posterior sample mean + std·noise (pipe_FRESCO.py:160)
        with ``noise`` standard normal [B,H/8,W/8,4], or the mean when
        ``noise`` is None.  Returned in the model dtype."""
        mean, logvar = self.encode_moments(x)
        wd = torch.promote_types(mean.dtype, torch.float32)
        z = mean.to(wd)
        if noise is not None:
            z = z + torch.exp(0.5 * logvar.to(wd)) * noise.to(wd)
        return (z * self.cfg.scaling_factor).to(self.dtype)

    def decode(self, z):
        """Scaled latent -> image in [-1,1] (unclamped)."""
        z = (z / self.cfg.scaling_factor).to(self.dtype)
        return self.decoder(self.post_quant_conv(z))
