"""CLIP vision encoder (the ViT image tower) for the frame-similarity metric.

Counterpart of ``fresco_tpu/models/clip_vision.py`` (HF
``CLIPVisionTransformer``, the openai/clip-vit-large-patch14 family): a
patch-embedding convolution, the class token and learned positions,
pre-LN, non-causal transformer layers (``clip_text.CLIPLayer`` with a full
mask), the post-LN class token as the pooled output, and an optional
projection to the shared image/text space.  Plain tensor code in float32:
the JAX tower runs no Pallas kernel either.

Images are NHWC; ``image_embeddings`` takes [-1, 1] RGB frames and applies
CLIP's pixel normalization.  Submodule names follow the Flax tree.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from fresco_torch.models.clip_text import CLIPLayer, CLIPTextConfig
from fresco_torch.models.layers import Conv2d, Dense, LayerNorm32
from fresco_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                                image_size=32, patch_size=8, projection_dim=16)

    def as_text_cfg(self) -> CLIPTextConfig:
        """The shared ``CLIPLayer``'s config."""
        return CLIPTextConfig(hidden_size=self.hidden_size, num_layers=self.num_layers, num_heads=self.num_heads,
                              intermediate_size=self.intermediate_size, layer_norm_eps=self.layer_norm_eps)


# CLIP pixel normalization (HF CLIPImageProcessor constants)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPVisionEncoder(nn.Module):
    """``projection``: whether the module holds ``visual_projection`` (a
    full ``CLIPModel`` checkpoint has it, a bare vision tower does not)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(), projection: bool = False):
        super().__init__()
        c = cfg.hidden_size
        self.cfg = cfg
        self.patch_embedding = Conv2d(3, c, cfg.patch_size, stride=cfg.patch_size, padding=0, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c))
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, c)
        self.pre_layrnorm = LayerNorm32(c, cfg.layer_norm_eps)  # [sic] HF parameter name
        tc = cfg.as_text_cfg()
        for i in range(cfg.num_layers):
            setattr(self, f"layers_{i}", CLIPLayer(tc))
        self.post_layernorm = LayerNorm32(c, cfg.layer_norm_eps)
        self.visual_projection = Dense(c, cfg.projection_dim, bias=False) if projection else None

    def flax_init(self, gen=None) -> None:
        """The class token's N(0, 0.02) init (``init_flax_default_`` hook)."""
        with torch.no_grad():
            self.class_embedding.normal_(0.0, 0.02, generator=gen)

    def forward(self, pixels: torch.Tensor, project: bool = False) -> torch.Tensor:
        """pixels [B, S, S, 3] CLIP-normalized (S = cfg.image_size) -> the
        pooled embedding [B, C], or with ``project`` its projection
        [B, projection_dim]."""
        c = self.cfg.hidden_size
        x = self.patch_embedding(pixels)
        b = x.shape[0]
        x = x.reshape(b, -1, c)  # row-major patches
        x = torch.cat([self.class_embedding.to(x.dtype).expand(b, 1, c), x], 1)
        x = x + self.position_embedding(torch.arange(x.shape[1], device=x.device))[None]
        x = self.pre_layrnorm(x)
        full = torch.ones((1, 1, x.shape[1], x.shape[1]), dtype=torch.bool, device=x.device)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layers_{i}")(x, full)
        pooled = self.post_layernorm(x[:, 0])
        if project:
            if self.visual_projection is None:
                raise ValueError("project=True needs visual_projection weights (a full CLIPModel checkpoint)")
            pooled = self.visual_projection(pooled)
        return pooled


def infer_vision_config(sd) -> CLIPVisionConfig:
    """A CLIPVisionConfig from a checkpoint's tensor shapes (CLIPVisionModel
    or CLIPModel layout), so any CLIP vision variant loads."""
    p = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
    hidden, _, patch, _ = tuple(sd[f"{p}embeddings.patch_embedding.weight"].shape)  # OIHW
    n_pos = sd[f"{p}embeddings.position_embedding.weight"].shape[0]
    image_size = int(round((n_pos - 1) ** 0.5)) * patch
    n_layers = 1 + max(int(k.split("encoder.layers.")[1].split(".")[0]) for k in sd if "encoder.layers." in k)
    inter = sd[f"{p}encoder.layers.0.mlp.fc1.weight"].shape[0]
    proj = sd.get("visual_projection.weight")
    proj_dim = proj.shape[0] if proj is not None else hidden
    # the head count is not in the fused shapes; the known towers pin it per
    # width (ViT-B 768/12, ViT-L 1024/16, ViT-H 1280/16, ViT-bigG 1664/16)
    heads = {768: 12, 1024: 16, 1280: 16, 1664: 16}.get(hidden, max(hidden // 64, 1))
    return CLIPVisionConfig(hidden_size=hidden, num_layers=n_layers, num_heads=heads, intermediate_size=inter,
                            image_size=image_size, patch_size=patch, projection_dim=proj_dim)


def preprocess_unit_images(images: torch.Tensor, image_size: int) -> torch.Tensor:
    """[-1, 1] RGB [B, H, W, 3] -> CLIP-normalized [B, S, S, 3]: to [0, 1],
    bilinear resize to the tower's square input, CLIP mean / std (the HF
    processor's centre crop is skipped, as in the JAX package)."""
    x = (images + 1.0) / 2.0
    x = resize_bilinear(x, (image_size, image_size))
    mean = torch.tensor(_CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


@torch.no_grad()
def image_embeddings(model: CLIPVisionEncoder, images: torch.Tensor, project: bool = True) -> torch.Tensor:
    """L2-normalized CLIP embeddings of [-1, 1] RGB frames [B, H, W, 3]."""
    emb = model(preprocess_unit_images(images, model.cfg.image_size), project=project)
    return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
