"""Batched bf16 GEMM with float32 accumulation and output: wrapper and
plain version.

``bmm`` runs ``fresco_torch/csrc/bmm.cu`` (wgmma, which replaces the
Pallas ``_mm_kernel`` of ``scripts/bench_gemm.py``) on CUDA tensors and
``bmm_plain`` on CPU tensors.  On the main path it is the apply half of
the sign-gram pair (``ops/gram_kernel.py``: S [B, hw, hw] @ v [B, hw, c]);
``fresco_torch/scripts/bench_gemm.py`` times it at the TPU microbench's
rows.
"""
from __future__ import annotations

import torch

from fresco_torch import kernels


def bmm_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 a @ x of the upcast operands; a [B,M,K] broadcasts over the
    leading dims of x [..., B, K, N]."""
    return torch.matmul(a.float(), x.float())


def bmm(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a [B,M,K] bf16 @ x [..., B, K, N] bf16 -> float32 [..., B, M, N],
    accumulated in float32 (``a`` is shared by the leading dims of ``x``)."""
    if a.ndim != 3 or x.ndim < 3 or x.shape[-3] != a.shape[0] or x.shape[-2] != a.shape[2]:
        raise ValueError(f"bmm: shapes a{tuple(a.shape)} x{tuple(x.shape)}")
    if a.device.type == "cpu":
        return bmm_plain(a, x)
    card = kernels.launch_card("bmm", a=a, x=x)
    if a.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise TypeError(f"bmm: the CUDA kernel takes bfloat16, got {a.dtype}, {x.dtype}")
    a, x = a.contiguous(), x.contiguous()
    b, m, k = a.shape
    n = x.shape[-1]
    nb = x.shape[:-2].numel()
    out = torch.empty((*x.shape[:-2], m, n), dtype=torch.float32, device=card)
    kernels.call(bmm, "bmm", card, a.data_ptr(), x.data_ptr(), out.data_ptr(), nb, m, n, k, b)
    return out


bmm.launches = 0
bmm.launches_by_card = {}
