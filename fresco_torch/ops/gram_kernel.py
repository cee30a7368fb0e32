"""Spatial feature-optimization gradient kernel: wrapper and plain version.

Counterpart of ``fresco_tpu/ops/gram_kernel.py``.  Per Adam iteration
the spatial term of FRESCO's feature optimization (reference
src/diffusion_hacked.py:469-476) needs

    S·v  with  S = sign(v·vᵀ − C)

for v [B, hw, c] the row-normalized features and C [B, hw, hw] the dense
reference gram, both in the gram dtype.  G = v·vᵀ is accumulated in f32,
C is read as stored, the sign is cast back to the gram dtype for the
apply product, and the output is the UNSCALED f32 product (the caller
applies 2/(B·hw²)).

On CUDA, ``sign_gram_apply`` runs two kernels.  In bf16 (the main path's
gram dtype): the wgmma sign kernel of ``fresco_torch/csrc/sign_gram.cu``,
which writes S as bf16, then ``ops.gemm.bmm`` (``csrc/bmm.cu``) for S·v.
In float32: the CUDA-core pair of ``sign_gram.cu``.  It raises for any
other dtype.  On the CPU it runs ``sign_gram_plain``, the chunked form
of ``fresco_tpu/diffusion/guidance.py:394-412``.

``sign_gram_apply.launches`` counts the calls that launched the sign
kernel, and ``sign_gram_apply.launches_by_shape`` the same by (hw, c).

Where the reference gram stays factored, C = r·rᵀ for r [B, hw, c] (the
caller's ``dense_corr_max_mb`` keeps it out of memory), the same gradient
is sign(v·vᵀ − r·rᵀ)·v.  ``factored_sign_gram_apply`` runs it in bf16 as
one kernel (``fresco_torch/csrc/factored_gram.cu``: D, its sign and the
apply per tile on chip, no [B, hw, hw] tensor); ``factored_sign_gram_plain``
is the chunked form, three products a row chunk, in any dtype.
``factored_sign_gram_apply.launches`` (by (hw, c), by card) counts its
launches.
"""
from __future__ import annotations

import torch

from fresco_torch import kernels
from fresco_torch.ops import gemm


def sign_gram_plain(v: torch.Tensor, corr: torch.Tensor, chunk_rows: int = 1024) -> torch.Tensor:
    """S·v in row chunks of ``chunk_rows``; any dtype, any hw.  Products
    run in f32 on the gram-dtype values (exact for bf16 inputs; the sign
    is -1/0/1 in any dtype), in f64 for f64 inputs (the float64 mode)."""
    b, hw, c = v.shape
    work = torch.promote_types(v.dtype, torch.float32)
    vf = v.to(work)
    out = torch.empty((b, hw, c), dtype=work, device=v.device)
    for r0 in range(0, hw, chunk_rows):
        g = torch.matmul(vf[:, r0 : r0 + chunk_rows], vf.transpose(1, 2))
        s = torch.sign(g - corr[:, r0 : r0 + chunk_rows].to(work))
        out[:, r0 : r0 + chunk_rows] = torch.matmul(s, vf)
    return out


def _check_cuda_inputs(v: torch.Tensor, corr: torch.Tensor) -> torch.device:
    """Raise unless the CUDA kernels take ``v`` and ``corr``; their card."""
    b, hw, c = v.shape
    card = kernels.launch_card("sign_gram", v=v, corr=corr)
    if v.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sign_gram: the CUDA kernels take bfloat16 or float32, got {v.dtype}")
    if not (v.is_contiguous() and corr.is_contiguous()):
        raise ValueError("sign_gram: v and corr must be contiguous")
    if c % 8 or v.data_ptr() % 16:
        raise ValueError(f"sign_gram: channels {c} must be a multiple of 8 and v 16-byte aligned")
    return card


def sign_matrix(v: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """The sign kernel alone: S = sign(v·vᵀ − corr).  bf16 v gives bf16 S
    [B, hw, hw] with entries -1, 0, +1 (what the apply multiplies); float32
    v gives int8 S [B, hw, ldS], ldS = hw rounded up to 16 with the padding
    columns 0 (the float32 apply kernel's layout)."""
    card = _check_cuda_inputs(v, corr)
    b, hw, c = v.shape
    if v.dtype == torch.bfloat16:
        lds, s = hw, torch.empty((b, hw, hw), dtype=torch.bfloat16, device=v.device)
    else:
        lds = -(-hw // 16) * 16  # 16-byte rows for the float32 apply kernel's int8 loads
        s = torch.empty((b, hw, lds), dtype=torch.int8, device=v.device)
    kernels.call(None, "sign_gram_sign", card, v.data_ptr(), corr.data_ptr(), s.data_ptr(), b, hw, c, lds,
                 int(v.dtype == torch.float32))
    return s


def sign_gram_apply(v: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """sign(v·vᵀ − corr)·v, f32 [B, hw, c] (f64 on the CPU for f64 inputs;
    the card's kernels refuse f64).  v [B, hw, c], corr [B, hw, hw], same
    dtype, contiguous."""
    b, hw, c = v.shape
    if corr.shape != (b, hw, hw) or corr.dtype != v.dtype:
        raise ValueError(f"sign_gram_apply: corr {tuple(corr.shape)} {corr.dtype} vs v {tuple(v.shape)} {v.dtype}")
    if v.device.type == "cpu":
        return sign_gram_plain(v, corr)
    s = sign_matrix(v, corr)
    kernels.count_launch(sign_gram_apply, (hw, c), v.device)
    return apply_sign(s, v)


def apply_sign(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The second kernel alone: S·v, f32 [B, hw, c], for S from
    ``sign_matrix(v, ...)``.  bf16 runs ``bmm``, float32 the CUDA-core
    apply kernel (which takes a transposed, zero-padded copy of v)."""
    if v.dtype == torch.bfloat16:
        return gemm.bmm(s, v)
    b, hw, c = v.shape
    lds = s.shape[2]
    vt = torch.zeros((b, c, lds), dtype=v.dtype, device=v.device)
    vt[:, :, :hw] = v.transpose(1, 2)
    out = torch.empty((b, hw, c), dtype=torch.float32, device=v.device)
    card = kernels.launch_card("sign_gram_apply_f32", s=s, v=v)
    kernels.call(None, "sign_gram_apply_f32", card, s.data_ptr(), vt.data_ptr(), out.data_ptr(), b, hw, c, lds)
    return out


sign_gram_apply.launches = 0
sign_gram_apply.launches_by_shape = {}
sign_gram_apply.launches_by_card = {}


def factored_sign_gram_plain(v: torch.Tensor, r: torch.Tensor, chunk_rows: int = 1024) -> torch.Tensor:
    """sign(v·vᵀ − r·rᵀ)·v in row chunks of ``chunk_rows``; any dtype, any
    hw.  The three products run in f32 on the given values (exact for bf16
    inputs), in f64 for f64 inputs (the float64 mode); f32 (f64) [B, hw, c],
    unscaled."""
    b, hw, c = v.shape
    work = torch.promote_types(v.dtype, torch.float32)
    vf = v.to(work)
    vr = r.to(work)
    out = torch.empty((b, hw, c), dtype=work, device=v.device)
    for row0 in range(0, hw, chunk_rows):
        rows = slice(row0, row0 + chunk_rows)
        g = torch.matmul(vf[:, rows], vf.transpose(1, 2))
        s = torch.sign(g - torch.matmul(vr[:, rows], vr.transpose(1, 2)))
        out[:, rows] = torch.matmul(s, vf)
    return out


def factored_sign_gram_apply(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """sign(v·vᵀ − r·rᵀ)·v, f32 [B, hw, c], unscaled, for v and r [B, hw, c]
    bf16, contiguous, 16-byte aligned, c a multiple of 8; raises otherwise,
    on any device.  On a card one launch of the fused kernel (counted); on
    the CPU ``factored_sign_gram_plain``."""
    if v.dim() != 3 or r.shape != v.shape:
        raise ValueError(f"factored_sign_gram_apply: v {tuple(v.shape)} and r {tuple(r.shape)} must be one [B, hw, c]")
    if v.dtype != torch.bfloat16 or r.dtype != torch.bfloat16:
        raise TypeError(f"factored_sign_gram_apply: takes bfloat16, got v {v.dtype}, r {r.dtype}")
    b, hw, c = v.shape
    if not (v.is_contiguous() and r.is_contiguous()):
        raise ValueError("factored_sign_gram_apply: v and r must be contiguous")
    if c % 8 or v.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError(f"factored_sign_gram_apply: channels {c} must be a multiple of 8 and v, r 16-byte aligned")
    if v.device.type == "cpu" and r.device.type == "cpu":
        return factored_sign_gram_plain(v, r)
    card = kernels.launch_card("sign_gram_factored", v=v, r=r)
    out = torch.empty((b, hw, c), dtype=torch.float32, device=v.device)
    kernels.call(factored_sign_gram_apply, "factored_sign_gram", card, v.data_ptr(), r.data_ptr(), out.data_ptr(),
                 b, hw, c, shape=(hw, c))
    return out


factored_sign_gram_apply.launches = 0
factored_sign_gram_apply.launches_by_shape = {}
factored_sign_gram_apply.launches_by_card = {}
