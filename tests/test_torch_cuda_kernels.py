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
same S (in bf16, S itself is compared bit for bit) and the f32 outputs
agree to 1e-5 relative Frobenius.  Batched
GEMM: float32 sums of exact bf16 products in two orders, 1e-5 relative
Frobenius, at ragged shapes (M, N, K that no tile divides, K and N not
multiples of 8) and in the guidance layout.  The sparse warp (plain
tensor code, no kernel of its own): its backward bit-identical across
two calls, and within 1e-5 relative Frobenius of the dense matrix's
transpose product.  Checkpoint tensors read on the host move to the card
unchanged.
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


def _flash_mask(kind, sk, device, g):
    """[2, sk] key masks; batch row 1 has no valid key unless ``kind`` is
    "none" (no mask at all)."""
    if kind == "none":
        return None
    mask = torch.rand(2, sk, device=device, generator=g) > 0.5
    if kind == "random":
        mask[0, :64] = False          # a fully masked key tile
    elif kind == "first":
        mask[0] = True
        mask[0, :64] = False          # the first tile, and only it
    elif kind == "last":
        mask[0, sk // 2:] = False     # every tile of the second half
    elif kind == "two":
        mask[0] = True
        mask[0, 64:192] = False       # two masked tiles in a row
    mask[1] = False                   # a batch row with no valid key
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("h,sq,sk,d,mask_kind,layout", [
    pytest.param(8, 300, 200, 40, "random", "bhsd", id="8-300-200-40"),
    pytest.param(8, 256, 256, 80, "random", "bhsd", id="8-256-256-80"),
    pytest.param(8, 130, 190, 160, "random", "bhsd", id="8-130-190-160"),
    pytest.param(1, 256, 256, 512, "random", "bhsd", id="1-256-256-512"),
    # lengths no tile divides, at the one-warp-per-slab and the split widths
    pytest.param(8, 1000, 1030, 40, "none", "bhsd", id="ragged-40"),
    pytest.param(1, 1000, 1030, 512, "none", "bhsd", id="ragged-512"),
    # the ring's skip path: first tile, last tiles, two tiles in a row
    pytest.param(8, 300, 500, 40, "first", "bhsd", id="first-tile-masked-40"),
    pytest.param(8, 300, 500, 40, "last", "bhsd", id="last-tiles-masked-40"),
    pytest.param(8, 300, 500, 40, "two", "bhsd", id="two-tiles-masked-40"),
    pytest.param(1, 300, 500, 512, "first", "bhsd", id="first-tile-masked-512"),
    pytest.param(1, 300, 500, 512, "two", "bhsd", id="two-tiles-masked-512"),
    # fewer keys than one tile, and fewer tiles than the ring is deep
    pytest.param(8, 300, 24, 40, "last", "bhsd", id="sk-under-a-tile"),
    pytest.param(8, 300, 100, 80, "last", "bhsd", id="sk-under-the-ring"),
    pytest.param(2, 300, 333, 256, "random", "bhsd", id="d256"),
    pytest.param(4, 300, 333, 8, "random", "bhsd", id="d8"),
    # the [B, S, H, D] memory of the models' head split, not copied
    pytest.param(8, 300, 333, 40, "random", "bshd", id="bshd-strided-40"),
    pytest.param(2, 300, 333, 512, "two", "bshd", id="bshd-strided-512"),
])
def test_flash_kernel_matches_plain(cuda_device, h, sq, sk, d, mask_kind, layout):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    if layout == "bshd":
        q, k, v = (torch.randn(2, s, h, d, device=cuda_device, generator=g).to(torch.bfloat16).transpose(1, 2)
                   for s in (sq, sk, sk))
        assert not q.is_contiguous()
    else:
        q, k, v = (torch.randn(2, h, s, d, device=cuda_device, generator=g).to(torch.bfloat16)
                   for s in (sq, sk, sk))
    if sk < 128:
        # a mean of few unit-variance values is large: at |out| > 2 half a bf16
        # step of the output alone is 3.9e-3, so keep |out| under 1
        v = v * 0.25
    mask = _flash_mask(mask_kind, sk, cuda_device, g)
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = naive_attention(q.float(), k.float(), v.float(), mask)
    if mask is not None:
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
@pytest.mark.parametrize("b,hw,c,c_offset", [
    (1, 72, 8, 0), (16, 72, 640, 0),          # under one tile
    (1, 200, 1280, 0), (16, 200, 8, 0),       # ragged tiles
    (1, 100, 640, 0), (16, 100, 1280, 0),     # hw % 8 != 0: element-by-element C / S and bmm's element path
    (2, 256, 640, 4),                         # C 8 but not 16 bytes aligned: C and S element by element
    (1, 1280, 640, 0), (16, 1280, 8, 0),
    (16, 4096, 640, 0), (1, 4096, 1280, 0),   # the main path's largest shapes
])
def test_sign_gram_bf16_pair(cuda_device, b, hw, c, c_offset):
    """The bf16 pair: the wgmma sign kernel writes S as bf16 [B, hw, hw] in
    {-1, 0, +1}, equal to the plain sign (C keeps a margin of ~1 around
    every sign, so there is no tie), and the apply runs on bmm."""
    from fresco_torch.ops import gram_kernel as gk
    from fresco_torch.ops.gemm import bmm

    g = torch.Generator(device=cuda_device).manual_seed(0)
    v = torch.nn.functional.normalize(torch.randn(b, hw, c, device=cuda_device, generator=g), dim=-1)
    v = v.to(torch.bfloat16)
    sgn = torch.where(torch.rand(b, hw, hw, device=cuda_device, generator=g) > 0.5, 1.0, -1.0)
    corr_vals = (torch.matmul(v.float(), v.float().transpose(1, 2)) - sgn).to(torch.bfloat16)
    buf = torch.empty(c_offset + corr_vals.numel(), dtype=torch.bfloat16, device=cuda_device)
    corr = buf[c_offset:].view(b, hw, hw)
    corr.copy_(corr_vals)
    assert corr.is_contiguous() and corr.data_ptr() % 16 == 2 * c_offset % 16

    s = gk.sign_matrix(v, corr)
    torch.cuda.synchronize()
    assert s.dtype == torch.bfloat16 and s.shape == (b, hw, hw)
    assert bool(((s == -1) | (s == 0) | (s == 1)).all())
    plain_s = torch.sign(torch.matmul(v.float(), v.float().transpose(1, 2)) - corr.float())
    assert torch.equal(s.float(), plain_s)

    before, before_bmm = gk.sign_gram_apply.launches, bmm.launches
    before_shape = gk.sign_gram_apply.launches_by_shape.get((hw, c), 0)
    out = gk.sign_gram_apply(v, corr)
    torch.cuda.synchronize()
    assert gk.sign_gram_apply.launches == before + 1 and bmm.launches == before_bmm + 1
    assert gk.sign_gram_apply.launches_by_shape[(hw, c)] == before_shape + 1
    ref = gk.sign_gram_plain(v, corr)
    assert out.dtype == torch.float32 and out.shape == (b, hw, c)
    assert ((out - ref).norm() / ref.norm()).item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w,k,base", [
    (torch.float32, 75, 777, 0), (torch.bfloat16, 384, 777, 0), (torch.bfloat16, 3, 777, 0),
    (torch.float32, 8, 777, 0), (torch.uint8, 5, 777, 0),
    (torch.float32, 75, 777, 1),                              # table base 4 but not 16 bytes aligned
    (torch.float32, 75, 1, 0), (torch.float32, 75, 9, 0),     # one row; a warp's 8 rows + 1
    (torch.bfloat16, 384, 9, 0),
    (torch.float32, 1, 777, 0), (torch.float32, 3, 777, 0), (torch.float32, 27, 777, 0),
    (torch.float32, 76, 777, 0)])
def test_row_gather_kernel_bit_equal(cuda_device, dtype, w, k, base):
    from fresco_torch.propagate.gather import gather_rows, gather_rows_plain

    g = torch.Generator(device=cuda_device).manual_seed(0)
    n = 1000
    flat = (torch.rand(n * w + base, device=cuda_device, generator=g) * 200).to(dtype)
    table = flat[base:].view(n, w)
    idx = torch.randint(0, n, (k,), device=cuda_device, generator=g, dtype=torch.int32)
    before = gather_rows.launches
    out = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(out, gather_rows_plain(table, idx))
    # indices outside [0, N) give zero rows; the others are still gathered
    bad = idx.clone()
    bad[::3] = -1
    bad[1::4] = n
    ok = (bad >= 0) & (bad < n)
    out = gather_rows(table, bad)
    assert (out[~ok] == 0).all()
    assert torch.equal(out[ok], gather_rows_plain(table, bad[ok]))


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


def _level_deltas(dev, h, w, seeded, g):
    """The shifts and random deltas ``_synthesize_level`` runs at an h x w
    level: 15 candidates when seeded, 20 at the coarsest level."""
    from fresco_torch.propagate.patchmatch import level_candidates

    shifts, radii = level_candidates(h, w, seeded)
    return shifts, torch.stack([torch.randint(-rad, rad + 1, (h, w, 2), device=dev, generator=g, dtype=torch.int32)
                                for rad in radii])


def _periodic(dev, h, w, c, g):
    """Integers in [0, 64) repeating every 8 pixels, as bf16 (exact)."""
    period = torch.randint(0, 64, (8, 8, c), device=dev, generator=g).float()
    return period.repeat(-(-h // 8), -(-w // 8), 1)[:h, :w].to(torch.bfloat16).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("c,patch", [(15, 5), (15, 3), (20, 5)])
@pytest.mark.parametrize("mode", ["be0", "candidates", "full_sweep", "compact", "level16x20", "level32x40",
                                  "level64x80", "exact_tie", "constant"])
def test_patch_eval_kernel_matches_plain(cuda_device, c, patch, mode):
    """The kernel against its plain version under the near-tie rule: one
    ragged 37x45 grid in four modes; the coarse levels' shapes with their
    candidate sets and a ragged active set; an 8-px periodic source of
    small integers with power-of-two weights and no omega, where every
    error is exact and identical patches tie, so the NNF and the errors
    must be bit-equal (the earlier candidate wins a tie); a constant image
    (the same weights), where no candidate is strictly better and the NNF
    comes back as it went in."""
    from fresco_torch.propagate.patch_eval import active_set, patch_eval, patch_eval_plain

    dev = cuda_device
    exact = mode in ("exact_tie", "constant")
    if mode.startswith("level"):
        h, w = map(int, mode[len("level"):].split("x"))
        src, tgt, weights, omega, nnf, _, mask, r = _patch_inputs(dev, h, w, h, w, c, patch)
        shifts, deltas = _level_deltas(dev, h, w, h > 16, torch.Generator(device=dev).manual_seed(1))
        sh, sw = h, w
    else:
        sh, sw = 40, 56
        src, tgt, weights, omega, nnf, deltas, mask, r = _patch_inputs(dev, sh, sw, 37, 45, c, patch)
        shifts = (1, 2, 4, 8)
    nnf0 = torch.stack([nnf[..., 0].clamp(r, sh - 1 - r), nnf[..., 1].clamp(r, sw - 1 - r)], -1)
    if exact:
        g = torch.Generator(device=dev).manual_seed(2)
        weights = 2.0 ** -torch.randint(0, 3, (c,), device=dev, generator=g).float()
        if mode == "exact_tie":
            src, tgt = _periodic(dev, sh, sw, c, g), _periodic(dev, 37, 45, c, g)
        else:
            src = torch.full_like(src, 77.0)
            tgt = torch.full_like(tgt, 80.0)
        args = (src, tgt, weights, None, nnf0, None, shifts, deltas, None)
    elif mode == "be0":
        args = (src, tgt, weights, omega, nnf, None, (), None, None)
    else:
        _, e0 = patch_eval_plain(src, tgt, weights, omega, nnf, None, patch=patch)
        act = None if mode == "candidates" else active_set(mask, compact=mode != "full_sweep")
        args = (src, tgt, weights, omega, nnf0, e0, shifts, deltas, act)
    shape = (tgt.shape[0], tgt.shape[1], max(4 * len(args[6]) + (0 if args[7] is None else args[7].shape[0]), 1))
    before, before_shape = patch_eval.launches, patch_eval.launches_by_shape.get(shape, 0)
    out = patch_eval(*args, patch=patch)
    torch.cuda.synchronize()
    assert patch_eval.launches == before + 1
    assert patch_eval.launches_by_shape[shape] == before_shape + 1
    ref = patch_eval_plain(*args, patch=patch)
    if exact:
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        if mode == "constant":
            assert torch.equal(out[0], nnf0)
        return
    assert_near_tie_agreement(args, out, ref, patch)
    if args[8] is not None:  # frozen pixels keep their inputs
        assert torch.equal(out[0][~mask], args[4][~mask]) and torch.equal(out[1][~mask], args[5][~mask])


@pytest.mark.cuda
@pytest.mark.parametrize("xshape,m", [((3, 264, 136), 200), ((2, 37, 29), 53), ((1, 512, 640), 256),
                                      ((2, 3, 96, 40), 70),
                                      ((2, 40, 700), 200),       # K under one k-tile, N of no tile
                                      ((2, 264, 512), 256),      # K a multiple of 8, not of 64
                                      ((2, 3, 264, 136), 200),   # a_period 3, 4-D x
                                      ((1, 1000, 264), 300),     # a ragged last k-tile after a full ring
                                      ((2, 133, 45), 77)])       # K and N not multiples of 8
def test_bmm_kernel_matches_plain(cuda_device, xshape, m):
    from fresco_torch.ops.gemm import bmm, bmm_plain

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


@pytest.mark.cuda
@pytest.mark.parametrize("hw_side,d", [(8, 2560), (32, 2560), (64, 1280)])
def test_sparse_warp_backward_is_deterministic(cuda_device, hw_side, d):
    """The sparse warp's backward (a gather over the sorted transpose and a
    segment sum, no scatter-add) gives the same bits twice on the card, and
    the dense matrix's product to 1e-5 relative Frobenius in float32."""
    from fresco_torch.diffusion.guidance import apply_sparse_warp, make_sparse_warp, warp_matrix

    g = torch.Generator(device=cuda_device).manual_seed(1)
    flow = torch.randn(8, hw_side, hw_side, 2, device=cuda_device, generator=g) * 3
    x = torch.randn(8, hw_side * hw_side, d, device=cuda_device, generator=g)
    ct = torch.randn_like(x)
    warp = make_sparse_warp(flow)
    grads = []
    for _ in range(2):
        xr = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(apply_sparse_warp(xr, warp), xr, ct)
        grads.append(gx)
    assert torch.equal(grads[0].view(torch.int32), grads[1].view(torch.int32))
    dense = warp_matrix(flow)
    ref = torch.matmul(dense.transpose(1, 2), ct)
    assert ((grads[0] - ref).norm() / ref.norm()).item() < 1e-5


@pytest.mark.cuda
def test_safetensors_reader_on_cuda(cuda_device, tmp_path):
    """Checkpoint tensors read on the host move to the card unchanged."""
    from fresco_torch.models.convert import read_safetensors, write_safetensors

    g = torch.Generator(device=cuda_device).manual_seed(2)
    src = {"f32": torch.randn(33, 7, device=cuda_device, generator=g),
           "f16": torch.randn(5, device=cuda_device, generator=g).half(),
           "bf16": torch.randn(3, 4, device=cuda_device, generator=g).bfloat16(),
           "i64": torch.arange(77, device=cuda_device)[None]}
    path = str(tmp_path / "x.safetensors")
    write_safetensors(path, src)
    got = {k: v.to(cuda_device) for k, v in read_safetensors(path).items()}
    for k, v in src.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(got[k], v), k
