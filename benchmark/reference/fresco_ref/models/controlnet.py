"""ControlNet (sd-controlnet-{hed,depth,canny} family), PyTorch, NHWC.

Counterpart of ``fresco_tpu/models/controlnet.py`` (reference
src/pipe_FRESCO.py:184-196): a copy of the UNet encoder + mid block
conditioned on an edge map through a small conv embedding; zero-
initialized 1x1 projections emit one residual per UNet skip plus the mid
block.  ``embed_cond`` runs the conditioning embedding alone, so the
sampler computes it once per batch instead of once per step.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.fresco_ref.models.layers import Conv2d, Dense
from benchmark.reference.fresco_ref.models.unet import UNetConfig, build_encoder, embed_time, run_encoder


class ControlNetConditioningEmbedding(nn.Module):
    """[0,1] RGB condition image -> latent-resolution embedding."""

    def __init__(self, out_ch: int, block_channels: tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        self.n = len(block_channels) - 1
        self.conv_in = Conv2d(3, block_channels[0])
        for i in range(self.n):
            setattr(self, f"blocks_{2 * i}", Conv2d(block_channels[i], block_channels[i]))
            setattr(self, f"blocks_{2 * i + 1}", Conv2d(block_channels[i], block_channels[i + 1], stride=2))
        self.conv_out = Conv2d(block_channels[-1], out_ch)
        self.conv_out.zero_init = True

    def forward(self, cond):
        h = F.silu(self.conv_in(cond))
        for i in range(2 * self.n):
            h = F.silu(getattr(self, f"blocks_{i}")(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig(),
                 cond_embed_channels: tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        self.cfg = cfg
        skips = build_encoder(self, cfg)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            cfg.block_out_channels[0], cond_embed_channels)
        for idx, ch in enumerate(skips):
            zc = Dense(ch, ch)
            zc.zero_init = True
            setattr(self, f"controlnet_down_blocks_{idx}", zc)
        self.n_residuals = len(skips)
        self.controlnet_mid_block = Dense(cfg.block_out_channels[-1], cfg.block_out_channels[-1])
        self.controlnet_mid_block.zero_init = True

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample, timestep, encoder_hidden_states, cond,
                conditioning_scale: float = 1.0, *, cond_is_embedded: bool = False):
        """sample [B,h,w,4]; cond [B,8h,8w,3] in [0,1], or with
        ``cond_is_embedded`` the output of ``embed_cond``.  Returns
        (down_residuals, mid_residual) scaled by ``conditioning_scale``."""
        c = self.cfg
        chans = c.block_out_channels
        dt = self.dtype
        context = encoder_hidden_states.to(dt)
        temb = embed_time(self, timestep, sample.shape[0], chans[0], dt, sample.device)
        h = self.conv_in(sample.to(dt))
        if cond_is_embedded:
            h = h + cond.to(dt)
        else:
            h = h + self.controlnet_cond_embedding(cond.to(dt))
        residuals = [h]
        h = run_encoder(self, c, h, temb, context, residuals)
        down = tuple(
            getattr(self, f"controlnet_down_blocks_{i}")(r) * conditioning_scale
            for i, r in enumerate(residuals)
        )
        return down, self.controlnet_mid_block(h) * conditioning_scale


def embed_cond(controlnet: ControlNet, cond: torch.Tensor) -> torch.Tensor:
    """The conditioning embedding alone (hoisted out of the step loop)."""
    return controlnet.controlnet_cond_embedding(cond.to(controlnet.dtype))
