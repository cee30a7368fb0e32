"""LoRA checkpoints (kohya format) merged into the port's state dicts.

Counterpart of ``fresco_tpu/models/lora.py`` (the reference WebUI's
community-base path, webUI.py:429-434): W <- W + scale · (alpha / r) ·
up @ down at load time, so the runtime path is unchanged.  ``up @ down``
is [out, in], the torch weight layout as it is: no transpose.
"""
from __future__ import annotations

import re
from typing import Mapping

import torch

from fresco_torch.models.convert import torch_key


def _flax_path_for(module: str) -> list[str] | None:
    """kohya module name (underscored diffusers path) -> Flax path, e.g.
    'lora_unet_up_blocks_2_attentions_1_transformer_blocks_0_attn1_to_q'
    -> ['up_2_attn_1', 'block', 'attn1', 'to_q']
    (``fresco_tpu/models/lora.py:_flax_path_for``)."""
    m = re.match(r"lora_unet_(down|up)_blocks_(\d+)_attentions_(\d+)_transformer_blocks_0_(attn\d|ff)_(.+)", module)
    if m:
        side, bi, ai, sub, leaf = m.groups()
        base = f"{side}_{bi}_attn_{ai}"
    else:
        m = re.match(r"lora_unet_mid_block_attentions_0_transformer_blocks_0_(attn\d|ff)_(.+)", module)
        if m:
            sub, leaf = m.groups()
            base = "mid_attn"
    if m:
        if sub.startswith("attn"):
            return [base, "block", sub, leaf.replace("to_out_0", "to_out")]
        return {"net_0_proj": [base, "block", "ff_geglu", "proj"],
                "net_2": [base, "block", "ff_out"]}.get(leaf)
    m = re.match(r"lora_te_text_model_encoder_layers_(\d+)_(.+)", module)
    if m:
        li, leaf = m.groups()
        return [f"layers_{li}"] + leaf.replace("self_attn_", "self_attn/").split("/")
    return None


@torch.no_grad()
def merge_lora(state_dict: dict[str, torch.Tensor], lora_sd: Mapping[str, torch.Tensor],
               scale: float = 1.0, target: str = "lora_unet_") -> tuple[dict, int]:
    """Merge the ``target`` modules of a kohya LoRA into ``state_dict`` in
    place: the sum in float32, rounded back to each weight's dtype.
    Returns (state_dict, number of modules merged); modules that map to no
    weight of the state dict are skipped."""
    modules = dict.fromkeys(k.split(".lora_down")[0] for k in lora_sd
                            if k.startswith(target) and ".lora_down" in k)
    merged = 0
    for mod in modules:
        path = _flax_path_for(mod)
        key = None if path is None else torch_key((*path, "kernel"))
        if key not in state_dict:
            continue
        down = lora_sd[f"{mod}.lora_down.weight"].to(torch.float32)
        up = lora_sd[f"{mod}.lora_up.weight"].to(torch.float32)
        r = down.shape[0]
        alpha_key = f"{mod}.alpha"
        alpha = float(lora_sd[alpha_key]) if alpha_key in lora_sd else float(r)
        delta = (up @ down) * (alpha / r) * scale
        w = state_dict[key]
        state_dict[key] = (w.to(torch.float32) + delta.to(w.device)).to(w.dtype)
        merged += 1
    return state_dict, merged
