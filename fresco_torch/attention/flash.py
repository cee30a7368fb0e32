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

The kernel is one pass of online softmax over a cp.async ring of K/V
tiles, with wgmma products at head dims up to 160 and an mma.sync split
over warps at 256 and 512 (its source note gives the design per head
dim); it walks only the key tiles that hold a valid key, so fully masked
tiles cost nothing, and needs no scratch from the wrapper.  The softmax
scale must be positive.

``flash_attention`` runs the kernel for CUDA tensors (bf16 only; it
raises otherwise) and ``naive_attention`` for CPU tensors.

Gradients.  Where grad mode is on and q, k or v requires grad, the call
goes through ``_FlashAttention``, an ``autograd.Function`` whose forward
is the same kernel launch and whose backward is the VJP of
``naive_attention`` in float32, recomputed from the saved q, k, v: the
JAX package's custom VJP (``fresco_tpu/attention/flash.py:135-157``),
which has no backward kernel either, so this plain-math backward is the
port of it.  The mask gets no gradient, a query row with no valid key
gets zero gradients, and the scale is a constant.  The backward holds
[B, H, Sq, Sk] float32 scores and probabilities while it runs.  Under
``torch.no_grad()``, or for inputs that require no grad, the kernel is
launched directly and nothing is saved.
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

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
    bool (True = attend) or None -> [B,H,Sq,D].

    A call is the profiler range ``fresco::attention`` and, once its shapes
    pass the checks, counts once in ``kernels.work_counts()["attention"]``
    by (B, H, Sq, Sk, D), Sk the keys given, masked or not.  Every UNet,
    ControlNet and VAE self-attention and the cross-frame and
    spatial-guided attentions come here; the 77-key text cross-attention
    (``models/unet.py`` ``CrossAttention.attend``) and the trajectory
    attention (``fresco_attention.trajectory_frames``) are plain tensor
    math, in neither the range nor the count."""
    with record_function("fresco::attention"):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        if scale is None:
            scale = 1.0 / math.sqrt(d)
        if not scale > 0:
            raise ValueError(f"flash_attention: scale must be positive, got {scale}")
        if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
            raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
        if key_mask is not None and (key_mask.shape != (b, sk) or key_mask.dtype != torch.bool):
            raise ValueError(f"flash_attention: key_mask must be bool [{b}, {sk}]")
        kernels.count_work("attention", (b, h, sq, sk, d))
        if q.device.type == "cpu":
            return naive_attention(q, k, v, key_mask, scale=scale)
        kernels.launch_card("flash_attention", q=q, k=k, v=v, key_mask=key_mask)
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.dtype != torch.bfloat16:
                raise TypeError(f"flash_attention: {name} must be bfloat16, got {t.dtype}")
            if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} needs a unit-stride head dim, 16-byte "
                                 f"aligned rows and strides that are multiples of 8 (got {t.stride()})")
        if d % 8 or d > 512:
            raise ValueError(f"flash_attention: head dim {d} must be a multiple of 8 and <= 512")
        if key_mask is not None and key_mask.stride(-1) != 1:
            raise ValueError("flash_attention: key_mask needs a unit-stride key axis")
        return _run(q, k, v, key_mask, float(scale))


def _run(q, k, v, key_mask, scale: float):
    """The kernel on checked inputs: through ``_FlashAttention`` where a
    gradient is needed, else one bare launch (nothing saved)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, key_mask, scale)
    return _launch(q, k, v, key_mask, scale)


def _launch(q, k, v, key_mask, scale: float):
    """One launch of the kernel on checked CUDA inputs, which
    ``flash_attention`` found all on q's card -> [B,H,Sq,D]."""
    card = q.device
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=card).transpose(1, 2)
    kernels.call(flash_attention, "flash_attn_fwd", card,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 key_mask.data_ptr() if key_mask is not None else None, out.data_ptr(),
                 b, h, sq, sk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 key_mask.stride(0) if key_mask is not None else 0, scale)
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel forward with the naive attention's VJP as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.scale = scale
        return _launch(q, k, v, key_mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = naive_attention(*qkv, key_mask, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None


flash_attention.launches = 0
flash_attention.launches_by_card = {}
