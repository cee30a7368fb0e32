"""Masked flash attention: CUDA kernel wrapper and its plain version.

Counterpart of ``fresco_tpu/attention/flash.py``.  The kernel
(``fresco_torch/csrc/flash_attn.cu``, which replaces the Pallas
``_flash_kernel``) computes softmax(q kᵀ · scale) v over the keys a
per-key mask [B, Sk] marks valid, shared by every query and head.  Query
rows with no valid key give exact zeros.

Layouts: q [B, H, Sq, D], k/v [B, H, Sk, D] — any strides with a
unit-stride head dim, so the [B, S, H, D] views that head splitting
gives need no copy.  The output is [B, H, Sq, D] as a view of a
[B, Sq, H, D] buffer (head merging is then free).

``flash_attention`` runs the kernel for CUDA tensors (bf16 only; it
raises otherwise) and ``naive_attention`` for CPU tensors.  Forward only:
the pipeline never differentiates through attention.
"""
from __future__ import annotations

import math

import torch

from fresco_torch import kernels


def naive_attention(q, k, v, key_mask=None, *, scale=None):
    """Plain O(Sq·Sk) attention in float32 (``fresco_tpu`` flash.py:255-277).

    Masked logits are excluded, and rows with no valid key are exact
    zeros (where SDPA would give NaN).  Returns q's dtype."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    acc_t = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc_t), k.to(acc_t)) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
        any_valid = key_mask.any(dim=-1)[:, None, None, None]
        s = torch.where(any_valid, s, torch.zeros_like(s))
    p = torch.softmax(s, dim=-1)
    if key_mask is not None:
        p = torch.where(any_valid, p, torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc_t)).to(q.dtype)


def flash_attention(q, k, v, key_mask=None, *, scale=None):
    """Masked attention.  q [B,H,Sq,D], k/v [B,H,Sk,D], key_mask [B,Sk]
    bool (True = attend) or None -> [B,H,Sq,D]."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if key_mask is not None and (key_mask.shape != (b, sk) or key_mask.dtype != torch.bool):
        raise ValueError(f"flash_attention: key_mask must be bool [{b}, {sk}]")
    if q.device.type == "cpu":
        return naive_attention(q, k, v, key_mask, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} must be bfloat16 on {q.device}, got {t.dtype} on {t.device}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a unit-stride head dim, 16-byte "
                             f"aligned rows and strides that are multiples of 8 (got {t.stride()})")
    if d % 8 or d > 512:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple of 8 and <= 512")
    if key_mask is not None:
        if key_mask.device != q.device:
            raise ValueError("flash_attention: key_mask on another device")
        if key_mask.stride(-1) != 1:
            raise ValueError("flash_attention: key_mask needs a unit-stride key axis")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = kernels.load()
    rc = lib.fresco_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_mask.data_ptr() if key_mask is not None else None, out.data_ptr(),
        b, h, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        key_mask.stride(0) if key_mask is not None else 0,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(rc, "flash_attn_fwd")
    kernels.count_launch(flash_attention)
    return out


flash_attention.launches = 0
