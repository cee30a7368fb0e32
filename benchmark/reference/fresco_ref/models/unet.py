"""SD 1.5 UNet2DConditionModel with FRESCO hooks (PyTorch, NHWC).

Counterpart of ``fresco_tpu/models/unet.py`` (reference
src/diffusion_hacked.py:491-816):

  * self-attention in the up blocks listed in ``fresco_up_blocks`` runs
    the FRESCO variants from a ``FrescoAttnParams``;
  * ``guidance_fn(stage, x)`` runs before each up block (feature
    optimization, diffusion_hacked.py:773-779);
  * ``return_up_features`` also returns the features entering each up
    block, and ``capture_refs`` (a list) collects the post-norm hidden
    states of every FRESCO self-attention layer in visit order — what the
    JAX package's ``sow("intermediates", "fresco_ref", x)`` records;
  * ControlNet residuals are explicit inputs.

Every UNet self-attention goes through the flash kernel; the 77-key
text cross-attention stays plain tensor math, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.fresco_ref.attention.fresco_attention import (
    FrescoAttnParams,
    _merge_heads,
    _split_heads,
    fresco_self_attention,
)
from benchmark.reference.fresco_ref.models.layers import (
    Conv2d,
    Dense,
    GroupNorm32,
    LayerNorm32,
    TimestepEmbedding,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8
    norm_groups: int = 32
    fresco_up_blocks: tuple[int, ...] = (2, 3)

    @staticmethod
    def tiny() -> "UNetConfig":
        return UNetConfig(block_out_channels=(8, 16), layers_per_block=1, cross_attention_dim=16,
                          attention_heads=2, norm_groups=4, fresco_up_blocks=(1,))

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, groups)
        self.conv1 = Conv2d(in_ch, out_ch)
        self.time_emb_proj = Dense(temb_ch, out_ch)
        self.norm2 = GroupNorm32(out_ch, groups)
        self.conv2 = Conv2d(out_ch, out_ch)
        self.conv_shortcut = Dense(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Dense(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) gelu, as diffusers' GEGLU


class CrossAttention(nn.Module):
    """Text cross-attention; 77 keys, plain tensor math."""

    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = Dense(dim, dim, bias=False)
        self.to_k = Dense(context_dim, dim, bias=False)
        self.to_v = Dense(context_dim, dim, bias=False)
        self.to_out = Dense(dim, dim)

    def forward(self, x, context):
        return self.to_out(self.attend(self.to_q(x), self.to_k(context), self.to_v(context), self.heads))

    @staticmethod
    def attend(q, k, v, heads: int):
        """Softmax attention of q [B, S, C] over k / v [B, 77, C] -> [B, S, C]."""
        qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
        d = qh.shape[-1]
        sd = torch.promote_types(qh.dtype, torch.float32)
        s = torch.matmul(qh, kh.transpose(-1, -2)).to(sd) * d**-0.5
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = (p / p.sum(dim=-1, keepdim=True)).to(vh.dtype)
        return _merge_heads(torch.matmul(p, vh))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = Dense(dim, dim, bias=False)
        self.to_k = Dense(dim, dim, bias=False)
        self.to_v = Dense(dim, dim, bias=False)
        self.to_out = Dense(dim, dim)

    def forward(self, x, fresco, layer_index: int, capture_refs: list | None):
        if layer_index >= 0 and capture_refs is not None:
            capture_refs.append(x)
        return fresco_self_attention(x, self.to_q, self.to_k, self.to_v, self.to_out,
                                     self.heads, fresco, layer_index)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = SelfAttention(dim, heads)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads)
        self.norm3 = LayerNorm32(dim)
        self.ff_geglu = GEGLU(dim, dim * 4)
        self.ff_out = Dense(dim * 4, dim)

    def forward(self, x, context, fresco, layer_index, capture_refs):
        x = x + self.attn1(self.norm1(x), fresco, layer_index, capture_refs)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff_out(self.ff_geglu(self.norm3(x)))


class Transformer2D(nn.Module):
    """GroupNorm + 1x1 in-projection, one basic block, out-projection."""

    def __init__(self, dim: int, context_dim: int, heads: int, groups: int):
        super().__init__()
        self.norm = GroupNorm32(dim, groups, epsilon=1e-6)
        self.proj_in = Dense(dim, dim)
        self.block = BasicTransformerBlock(dim, context_dim, heads)
        self.proj_out = Dense(dim, dim)

    def forward(self, x, context, fresco=None, layer_index=-1, capture_refs=None):
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x).reshape(b, h * w, c))
        y = self.proj_out(self.block(y, context, fresco, layer_index, capture_refs))
        return x + y.reshape(b, h, w, c)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


def build_encoder(mod: nn.Module, c: UNetConfig) -> list[int]:
    """Add the time embedding, conv_in and down/mid blocks (shared by the
    UNet and the ControlNet); returns the skip channel list."""
    chans = c.block_out_channels
    temb = chans[0] * 4
    mod.time_embedding = TimestepEmbedding(chans[0], temb)
    mod.conv_in = Conv2d(c.in_channels, chans[0])
    skips = [chans[0]]
    prev = chans[0]
    for i, ch in enumerate(chans):
        for j in range(c.layers_per_block):
            setattr(mod, f"down_{i}_res_{j}", ResnetBlock(prev, ch, temb, c.norm_groups))
            prev = ch
            if i < len(chans) - 1:
                setattr(mod, f"down_{i}_attn_{j}",
                        Transformer2D(ch, c.cross_attention_dim, c.attention_heads, c.norm_groups))
            skips.append(ch)
        if i < len(chans) - 1:
            setattr(mod, f"down_{i}_downsample", Downsample(ch))
            skips.append(ch)
    mod.mid_res_0 = ResnetBlock(chans[-1], chans[-1], temb, c.norm_groups)
    mod.mid_attn = Transformer2D(chans[-1], c.cross_attention_dim, c.attention_heads, c.norm_groups)
    mod.mid_res_1 = ResnetBlock(chans[-1], chans[-1], temb, c.norm_groups)
    return skips


def run_encoder(mod: nn.Module, c: UNetConfig, h, temb, context, collect: list):
    """Down blocks + mid; appends every skip to ``collect``."""
    chans = c.block_out_channels
    for i in range(len(chans)):
        for j in range(c.layers_per_block):
            h = getattr(mod, f"down_{i}_res_{j}")(h, temb)
            if i < len(chans) - 1:
                h = getattr(mod, f"down_{i}_attn_{j}")(h, context)
            collect.append(h)
        if i < len(chans) - 1:
            h = getattr(mod, f"down_{i}_downsample")(h)
            collect.append(h)
    h = mod.mid_res_0(h, temb)
    h = mod.mid_attn(h, context)
    return mod.mid_res_1(h, temb)


def embed_time(mod: nn.Module, timestep, batch: int, ch: int, dtype, device):
    t = torch.as_tensor(timestep, device=device).reshape(-1).expand(batch)
    return mod.time_embedding(timestep_embedding(t, ch).to(dtype))


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg
        chans = c.block_out_channels
        temb = chans[0] * 4
        skips = build_encoder(self, c)
        rev = list(reversed(chans))
        prev = chans[-1]
        for i, ch in enumerate(rev):
            for j in range(c.layers_per_block + 1):
                skip_ch = skips.pop()
                setattr(self, f"up_{i}_res_{j}", ResnetBlock(prev + skip_ch, ch, temb, c.norm_groups))
                prev = ch
                if i > 0:
                    setattr(self, f"up_{i}_attn_{j}",
                            Transformer2D(ch, c.cross_attention_dim, c.attention_heads, c.norm_groups))
            if i < len(rev) - 1:
                setattr(self, f"up_{i}_upsample", Upsample(ch))
        self.conv_norm_out = GroupNorm32(chans[0], c.norm_groups)
        self.conv_out = Conv2d(chans[0], c.out_channels)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: ``set_compute_dtype``'s, else the parameters'."""
        return self.conv_in.compute_dtype or self.conv_in.weight.dtype

    def forward(
        self,
        sample: torch.Tensor,
        timestep,
        encoder_hidden_states: torch.Tensor,
        *,
        controlnet_residuals: tuple[Sequence[torch.Tensor], torch.Tensor] | None = None,
        fresco: FrescoAttnParams | None = None,
        guidance_fn: Callable[[int, torch.Tensor], torch.Tensor] | None = None,
        return_up_features: bool = False,
        capture_refs: list | None = None,
    ):
        """sample [B,h,w,4]; timestep int or [B]; text [B,77,768] ->
        eps [B,h,w,4] (and the up-block input features when
        ``return_up_features``)."""
        c = self.cfg
        chans = c.block_out_channels
        dt = self.dtype
        context = encoder_hidden_states.to(dt)
        temb = embed_time(self, timestep, sample.shape[0], chans[0], dt, sample.device)
        h = self.conv_in(sample.to(dt))
        skips = [h]
        h = run_encoder(self, c, h, temb, context, skips)
        if controlnet_residuals is not None:
            down_res, mid_res = controlnet_residuals
            skips = [s + r.to(s.dtype) for s, r in zip(skips, down_res)]
            h = h + mid_res.to(h.dtype)

        up_features = []
        fresco_layer = 0
        rev = list(reversed(chans))
        for i, ch in enumerate(rev):
            if return_up_features:
                up_features.append(h)
            if guidance_fn is not None:
                h = guidance_fn(i, h)
            has_attn = i > 0
            is_fresco = i in c.fresco_up_blocks
            blk_fresco = fresco if (has_attn and is_fresco) else None
            for j in range(c.layers_per_block + 1):
                skip = skips.pop()
                h = torch.cat([h, skip.to(h.dtype)], dim=-1)
                h = getattr(self, f"up_{i}_res_{j}")(h, temb)
                if has_attn:
                    h = getattr(self, f"up_{i}_attn_{j}")(
                        h, context, blk_fresco, fresco_layer if is_fresco else -1, capture_refs)
                    if is_fresco:
                        fresco_layer += 1
            if i < len(rev) - 1:
                h = getattr(self, f"up_{i}_upsample")(h)

        eps = self.conv_out(F.silu(self.conv_norm_out(h)))
        if return_up_features:
            return eps, tuple(up_features)
        return eps
