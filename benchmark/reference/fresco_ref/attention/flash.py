"""Masked attention in plain PyTorch, computed in blocks.

softmax(q kᵀ · scale) v over the keys that a per-key mask [B, Sk] marks
valid; a query row with no valid key gives exact zeros.  q [B, H, Sq, D],
k / v [B, H, Sk, D]; the result has q's dtype.  Each batch row keeps only
its valid keys (a masked key's weight is exactly nought), the scores and
the softmax are float32, and the score block of one product stays under
``BLOCK_ELEMS`` elements.  For bfloat16 q, k, v both products run on TF32
tensor cores (``precision.py``): q kᵀ is then exact, and p v rounds the
float32 probabilities to TF32's 10 mantissa bits.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.fresco_ref.precision import tf32_for_bf16_operands

BLOCK_ELEMS = 1 << 28  # 1 GiB of float32 scores


def flash_attention(q, k, v, key_mask=None, *, scale=None):
    b, h, sq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    acc_t = torch.promote_types(q.dtype, torch.float32)
    out = torch.zeros((b, h, sq, d), dtype=q.dtype, device=q.device)
    with tf32_for_bf16_operands(q.dtype == torch.bfloat16):
        for bi in range(b):
            kb, vb = k[bi], v[bi]
            if key_mask is not None:
                keep = torch.nonzero(key_mask[bi]).flatten()
                if keep.numel() == 0:
                    continue
                kb, vb = kb[:, keep], vb[:, keep]
            kb, vb = kb.to(acc_t), vb.to(acc_t)
            rows = max(1, min(sq, BLOCK_ELEMS // max(1, h * kb.shape[1])))
            for r0 in range(0, sq, rows):
                s = torch.matmul(q[bi, :, r0 : r0 + rows].to(acc_t), kb.transpose(-1, -2)) * scale
                out[bi, :, r0 : r0 + rows] = torch.matmul(torch.softmax(s, dim=-1), vb).to(q.dtype)
    return out
