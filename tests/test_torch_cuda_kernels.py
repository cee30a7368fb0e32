"""The hand-written CUDA kernels against their plain PyTorch versions on
a GPU (``cuda`` marker; each test skips without a card).

This file imports neither jax nor the JAX package, so it runs on a GPU
machine that has only PyTorch: from the repo root,
``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py``.

Tolerances.  Flash: 5e-3 absolute and 1e-2 relative Frobenius on
unit-variance inputs — the kernel rounds P to bf16 and writes bf16, the
plain version is float32 math on the same bf16 inputs; a skipped or
doubled key tile moves either far more.  Sign-gram (bf16 and float32):
C is built with a margin of ~1 around every sign, so both compute the
same S and the f32 outputs agree to 1e-5 relative Frobenius.
"""
import pytest
import torch

from fresco_torch.attention.flash import flash_attention, naive_attention
from fresco_torch.ops.gram_kernel import sign_gram_apply, sign_gram_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,sq,sk,d", [(8, 300, 200, 40), (8, 256, 256, 80), (8, 130, 190, 160),
                                       (1, 256, 256, 512)])
def test_flash_kernel_matches_plain(cuda_device, h, sq, sk, d):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, h, s, d, device=cuda_device, generator=g).to(torch.bfloat16)
               for s in (sq, sk, sk))
    mask = torch.rand(2, sk, device=cuda_device, generator=g) > 0.5
    mask[0, :64] = False  # a fully masked key tile
    mask[1] = False       # a batch row with no valid key
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = naive_attention(q.float(), k.float(), v.float(), mask)
    assert (out[1] == 0).all()
    diff = out.float() - ref
    assert diff.abs().max().item() < 5e-3
    assert (diff.norm() / ref.norm()).item() < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hw,c", [(2, 64, 1280), (2, 1000, 320), (1, 1280, 640)])
def test_sign_gram_kernel_matches_plain(cuda_device, b, hw, c, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    # unit rows keep |G| <= 1, so C = G - M rounded to bf16 keeps a margin
    # of ~1 around every sign
    v = torch.nn.functional.normalize(torch.randn(b, hw, c, device=cuda_device, generator=g), dim=-1)
    v = v.to(dtype)
    sgn = torch.where(torch.rand(b, hw, hw, device=cuda_device, generator=g) > 0.5, 1.0, -1.0)
    sgn = torch.triu(sgn) + torch.triu(sgn, 1).transpose(1, 2)
    corr = (torch.matmul(v.float(), v.float().transpose(1, 2)) - sgn).to(dtype)
    before = sign_gram_apply.launches
    out = sign_gram_apply(v.contiguous(), corr.contiguous())
    torch.cuda.synchronize()
    assert sign_gram_apply.launches == before + 1
    ref = sign_gram_plain(v, corr)
    rel = ((out - ref).norm() / ref.norm()).item()
    assert rel < 1e-5, rel
