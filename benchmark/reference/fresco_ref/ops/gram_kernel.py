"""The spatial feature-optimization gradient in plain PyTorch.

S·v with S = sign(v·vᵀ − C), for v [B, hw, c] and the reference gram
C [B, hw, hw] in the gram dtype: float32 products of the gram-dtype values
(float64 for float64 inputs), in row blocks; the result is the unscaled
float32 product.  For bfloat16 operands the products run on TF32 tensor
cores, which hold them exactly (``precision.py``).
"""
from __future__ import annotations

import torch

from benchmark.reference.fresco_ref.precision import tf32_for_bf16_operands


def sign_gram_apply(v: torch.Tensor, corr: torch.Tensor, chunk_rows: int = 1024) -> torch.Tensor:
    b, hw, c = v.shape
    work = torch.promote_types(v.dtype, torch.float32)
    vf = v.to(work)
    out = torch.empty((b, hw, c), dtype=work, device=v.device)
    with tf32_for_bf16_operands(v.dtype == torch.bfloat16):
        for r0 in range(0, hw, chunk_rows):
            g = torch.matmul(vf[:, r0 : r0 + chunk_rows], vf.transpose(1, 2))
            s = torch.sign(g - corr[:, r0 : r0 + chunk_rows].to(work))
            out[:, r0 : r0 + chunk_rows] = torch.matmul(s, vf)
    return out
