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

On CUDA, ``sign_gram_apply`` runs the two kernels of
``fresco_torch/csrc/sign_gram.cu`` (bf16 on the tensor cores, f32 on the
CUDA cores; it raises for any other dtype); on CPU it runs
``sign_gram_plain``, the chunked form of
``fresco_tpu/diffusion/guidance.py:394-412``.
"""
from __future__ import annotations

import torch

from fresco_torch import kernels


def sign_gram_plain(v: torch.Tensor, corr: torch.Tensor, chunk_rows: int = 1024) -> torch.Tensor:
    """S·v in row chunks of ``chunk_rows``; any dtype, any hw.  Products
    run in f32 on the gram-dtype values (exact for bf16 inputs; the sign
    is -1/0/1 in any dtype)."""
    b, hw, c = v.shape
    vf = v.float()
    out = torch.empty((b, hw, c), dtype=torch.float32, device=v.device)
    for r0 in range(0, hw, chunk_rows):
        g = torch.matmul(vf[:, r0 : r0 + chunk_rows], vf.transpose(1, 2))
        s = torch.sign(g - corr[:, r0 : r0 + chunk_rows].float())
        out[:, r0 : r0 + chunk_rows] = torch.matmul(s, vf)
    return out


def _check_cuda_inputs(v: torch.Tensor, corr: torch.Tensor) -> None:
    b, hw, c = v.shape
    if v.device.type != "cuda" or corr.device != v.device:
        raise ValueError(f"sign_gram: unsupported devices {v.device}, {corr.device}")
    if v.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sign_gram: the CUDA kernels take bfloat16 or float32, got {v.dtype}")
    if not (v.is_contiguous() and corr.is_contiguous()):
        raise ValueError("sign_gram: v and corr must be contiguous")
    if c % 8:
        raise ValueError(f"sign_gram: channels {c} must be a multiple of 8")


def sign_matrix(v: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """The first CUDA kernel alone: S = sign(v·vᵀ − corr) as int8
    [B, hw, ldS] (ldS = hw rounded up to 16; the padding columns are 0)."""
    _check_cuda_inputs(v, corr)
    b, hw, c = v.shape
    lds = -(-hw // 16) * 16  # 16-byte rows for the apply kernel's int8 loads
    s = torch.empty((b, hw, lds), dtype=torch.int8, device=v.device)
    kernels.check(kernels.load().fresco_sign_gram_sign(
        v.data_ptr(), corr.data_ptr(), s.data_ptr(), b, hw, c, lds, int(v.dtype == torch.float32),
        torch.cuda.current_stream(v.device).cuda_stream), "sign_gram_sign")
    return s


def sign_gram_apply(v: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """sign(v·vᵀ − corr)·v, f32 [B, hw, c].  v [B, hw, c], corr [B, hw, hw],
    same dtype, contiguous."""
    b, hw, c = v.shape
    if corr.shape != (b, hw, hw) or corr.dtype != v.dtype:
        raise ValueError(f"sign_gram_apply: corr {tuple(corr.shape)} {corr.dtype} vs v {tuple(v.shape)} {v.dtype}")
    if v.device.type == "cpu":
        return sign_gram_plain(v, corr)
    s = sign_matrix(v, corr)
    lds = s.shape[2]
    vt = torch.zeros((b, c, lds), dtype=v.dtype, device=v.device)
    vt[:, :, :hw] = v.transpose(1, 2)
    out = torch.empty((b, hw, c), dtype=torch.float32, device=v.device)
    lib = kernels.load()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    kernels.check(lib.fresco_sign_gram_apply(
        s.data_ptr(), vt.data_ptr(), out.data_ptr(), b, hw, c, lds, int(v.dtype == torch.float32),
        stream), "sign_gram_apply")
    kernels.count_launch(sign_gram_apply)
    return out


sign_gram_apply.launches = 0
