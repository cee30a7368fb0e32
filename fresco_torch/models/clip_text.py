"""CLIP text encoder (SD 1.5's clip-vit-large-patch14 text tower), PyTorch.

Counterpart of ``fresco_tpu/models/clip_text.py``: causal transformer,
quick-GELU MLP, final layer norm, optional ``clip_skip``.  Runs in
float32 (as in the JAX package); the 77-token attention is plain tensor
math.  Submodule names follow the Flax tree (``layers_0.self_attn.q_proj``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from fresco_torch.models.layers import Dense, LayerNorm32, quick_gelu


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                              intermediate_size=64, max_position_embeddings=77)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj, self.k_proj = Dense(c, c), Dense(c, c)
        self.v_proj, self.out_proj = Dense(c, c), Dense(c, c)

    def forward(self, x, causal_mask):
        return self.out_proj(self.attend(self.q_proj(x), self.k_proj(x), self.v_proj(x), causal_mask, self.heads))

    @staticmethod
    def attend(q, k, v, causal_mask, heads: int):
        """Causal softmax attention of ``heads`` heads over q / k / v [B, T, C]."""
        b, t, c = q.shape
        d = c // heads

        def split(y):
            return y.reshape(b, t, heads, d).transpose(1, 2)

        s = torch.matmul(split(q), split(k).transpose(-1, -2)) * d**-0.5
        s = torch.where(causal_mask, s.float(), torch.full_like(s.float(), -1e30))
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.matmul(p, split(v)).transpose(1, 2).reshape(b, t, c)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.layer_norm1 = LayerNorm32(c, eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm32(c, eps)
        self.mlp_fc1 = Dense(c, cfg.intermediate_size)
        self.mlp_fc2 = Dense(cfg.intermediate_size, c)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp_fc2(quick_gelu(self.mlp_fc1(self.layer_norm2(x))))


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        for i in range(cfg.num_layers):
            setattr(self, f"layers_{i}", CLIPLayer(cfg))
        self.final_layer_norm = LayerNorm32(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, clip_skip: int = 0) -> torch.Tensor:
        """input_ids int [B, T] -> hidden states [B, T, C]."""
        t = input_ids.shape[1]
        pos = torch.arange(t, device=input_ids.device)[None]
        x = self.token_embedding(input_ids) + self.position_embedding(pos)
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))[None, None]
        outputs = []
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layers_{i}")(x, causal)
            outputs.append(x)
        if clip_skip > 0:
            x = outputs[-(clip_skip + 1)]
        return self.final_layer_norm(x)
