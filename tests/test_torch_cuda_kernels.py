"""The hand-written CUDA kernels against their plain PyTorch versions on
a GPU (``cuda`` marker; each test skips without a card).

This file imports neither jax nor the JAX package, so it runs on a GPU
machine that has only PyTorch: from the repo root,
``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py``.

Tolerances.  Row gather: bit-equal to index_select.  Patch evaluation:
where kernel and plain keep the same match their float32 errors agree to
1e-5 relative (other summation order); elsewhere, on at most 0.1 % of
pixels, the kernel's match must be one the plain arithmetic reaches when
comparisons within 1e-5 relative of a tie go either way.  Flash: 5e-3 absolute and 1e-2 relative Frobenius on
unit-variance inputs — the kernel rounds P to bf16 and writes bf16, the
plain version is float32 math on the same bf16 inputs; a skipped or
doubled key tile moves either far more.  Sign-gram (bf16 and float32):
C is built with a margin of ~1 around every sign, so both compute the
same S and the f32 outputs agree to 1e-5 relative Frobenius.  Batched
GEMM: float32 sums of exact bf16 products in two orders, 1e-5 relative
Frobenius, at ragged shapes (M, N, K that no tile divides, K and N not
multiples of 8) and in the guidance layout.
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w", [(torch.float32, 75), (torch.bfloat16, 384), (torch.bfloat16, 3),
                                     (torch.float32, 8), (torch.uint8, 5)])
def test_row_gather_kernel_bit_equal(cuda_device, dtype, w):
    from fresco_torch.propagate.gather import gather_rows, gather_rows_plain

    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, k = 1000, 777
    table = (torch.rand(n, w, device=cuda_device, generator=g) * 200).to(dtype)
    idx = torch.randint(0, n, (k,), device=cuda_device, generator=g, dtype=torch.int32)
    before = gather_rows.launches
    out = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(out, gather_rows_plain(table, idx))
    bad = torch.tensor([-1, n], dtype=torch.int32, device=cuda_device)
    assert (gather_rows(table, bad) == 0).all()


def _patch_inputs(dev, sh, sw, th, tw, c, patch, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = patch // 2
    src = (torch.rand(sh, sw, c, device=dev, generator=g) * 255).to(torch.bfloat16)
    tgt = (torch.rand(th, tw, c, device=dev, generator=g) * 255).to(torch.bfloat16)
    weights = torch.rand(c, device=dev, generator=g)
    omega = (torch.rand(sh, sw, device=dev, generator=g) * 3000).to(torch.bfloat16)
    nnf = torch.stack([torch.randint(-3, sh + 3, (th, tw), device=dev, generator=g),
                       torch.randint(-3, sw + 3, (th, tw), device=dev, generator=g)], -1).to(torch.int32)
    deltas = torch.randint(-9, 10, (3, th, tw, 2), device=dev, generator=g, dtype=torch.int32)
    mask = torch.rand(th, tw, device=dev, generator=g) > 0.7
    mask[:16, :16] = False  # one whole frozen tile
    return src, tgt, weights, omega, nnf, deltas, mask, r


def assert_near_tie_agreement(args, out, ref, patch, rel=1e-5, min_agree=0.999):
    """Where the kernel and the plain version keep the same match their
    errors agree to ``rel``; elsewhere the kernel's match must be one the
    plain arithmetic reaches when near-tie comparisons go either way."""
    from fresco_torch.propagate.patch_eval import near_tie_matches

    (kn, ke), (pn, pe) = out, ref
    same = (kn == pn).all(-1)
    assert same.float().mean().item() >= min_agree
    fin = torch.isfinite(pe) & same
    assert torch.allclose(ke[fin], pe[fin], rtol=rel, atol=0)
    for y, x in torch.nonzero(~same).tolist():
        assert tuple(kn[y, x].tolist()) in near_tie_matches(*args[:8], y, x, patch=patch, rel=rel)


@pytest.mark.cuda
@pytest.mark.parametrize("c,patch", [(15, 5), (15, 3), (20, 5)])
@pytest.mark.parametrize("mode", ["be0", "candidates", "full_sweep", "compact"])
def test_patch_eval_kernel_matches_plain(cuda_device, c, patch, mode):
    from fresco_torch.propagate.patch_eval import active_set, patch_eval, patch_eval_plain

    src, tgt, weights, omega, nnf, deltas, mask, r = _patch_inputs(cuda_device, 40, 56, 37, 45, c, patch)
    _, e0 = patch_eval_plain(src, tgt, weights, omega, nnf, None, patch=patch)
    if mode == "be0":
        args = (src, tgt, weights, omega, nnf, None, (), None, None)
    else:
        nnf0 = torch.stack([nnf[..., 0].clamp(r, 39 - r), nnf[..., 1].clamp(r, 55 - r)], -1)
        act = None if mode == "candidates" else active_set(mask, compact=mode == "compact")
        args = (src, tgt, weights, omega, nnf0, e0, (1, 2, 4, 8), deltas, act)
    before = patch_eval.launches
    out = patch_eval(*args, patch=patch)
    torch.cuda.synchronize()
    assert patch_eval.launches == before + 1
    ref = patch_eval_plain(*args, patch=patch)
    assert_near_tie_agreement(args, out, ref, patch)
    if mode in ("full_sweep", "compact"):  # frozen pixels keep their inputs
        assert torch.equal(out[0][~mask], args[4][~mask]) and torch.equal(out[1][~mask], e0[~mask])


@pytest.mark.cuda
@pytest.mark.parametrize("xshape,m", [((3, 264, 136), 200), ((2, 37, 29), 53), ((1, 512, 640), 256),
                                      ((2, 3, 96, 40), 70)])
def test_bmm_kernel_matches_plain(cuda_device, xshape, m):
    from fresco_torch.scripts.bench_gemm import bmm, bmm_plain

    g = torch.Generator(device=cuda_device).manual_seed(0)
    b, k = xshape[-3], xshape[-2]
    a = torch.randn(b, m, k, device=cuda_device, generator=g).to(torch.bfloat16)
    x = torch.randn(*xshape, device=cuda_device, generator=g).to(torch.bfloat16)
    before = bmm.launches
    out = bmm(a, x)
    torch.cuda.synchronize()
    assert bmm.launches == before + 1
    ref = bmm_plain(a, x)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert ((out - ref).norm() / ref.norm()).item() < 1e-5
