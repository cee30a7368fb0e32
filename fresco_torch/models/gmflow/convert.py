"""The reference's GMFlow checkpoint (``gmflow_sintel-*.pth``) -> the
port's GMFlow state dict.

Counterpart of ``fresco_tpu/models/gmflow/convert.py``: the reference's
module names (src/ebsynth/deps/gmflow/gmflow/) onto the port's, which
are the Flax ones.  InstanceNorms are affine-free (no tensors); the
transformer layers counted are the port's (the JAX converter counts the
checkpoint's).
"""
from __future__ import annotations

from typing import Mapping

import torch

from fresco_torch.models.convert import KeyMap, convert


def gmflow_map(b: KeyMap) -> None:
    def resblock(dst, src):
        b.raw_conv(f"{dst}/conv1", f"{src}.conv1")
        b.raw_conv(f"{dst}/conv2", f"{src}.conv2")
        if b.has(f"{dst}/downsample"):
            b.raw_conv(f"{dst}/downsample", f"{src}.downsample.0")

    b.raw_conv("backbone/conv1", "backbone.conv1")
    for layer in (1, 2, 3):
        for j in (0, 1):
            resblock(f"backbone/layer{layer}_{j}", f"backbone.layer{layer}.{j}")
    b.raw_conv("backbone/conv2", "backbone.conv2")
    i = 0
    while b.has(f"transformer/layers_{i}_self_attn/q_proj"):
        for part in ("self_attn", "cross_attn_ffn"):
            s, d = f"transformer.layers.{i}.{part}", f"transformer/layers_{i}_{part}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                b.dense(f"{d}/{proj}", f"{s}.{proj}")
            b.norm(f"{d}/norm1", f"{s}.norm1", wrapped=False)
            if part == "cross_attn_ffn":
                b.dense(f"{d}/mlp_0", f"{s}.mlp.0")
                b.dense(f"{d}/mlp_2", f"{s}.mlp.2")
                b.norm(f"{d}/norm2", f"{s}.norm2", wrapped=False)
        i += 1
    b.dense("feature_flow_attn/q_proj", "feature_flow_attn.q_proj")
    b.dense("feature_flow_attn/k_proj", "feature_flow_attn.k_proj")
    b.raw_conv("upsampler_0", "upsampler.0")
    b.raw_conv("upsampler_2", "upsampler.2")


def convert_gmflow(sd: Mapping, cfg=None, strict: bool = False) -> dict[str, torch.Tensor]:
    from fresco_torch.models.convert import _meta_keys
    from fresco_torch.models.gmflow.model import GMFlow, GMFlowConfig

    return convert(sd, gmflow_map, _meta_keys(GMFlow, cfg or GMFlowConfig()), strict)
