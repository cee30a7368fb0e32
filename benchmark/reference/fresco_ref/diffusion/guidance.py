"""FRESCO feature optimization: inner Adam loop on UNet decoder features.

Counterpart of ``fresco_tpu/diffusion/guidance.py:optimize_feature``
(reference src/diffusion_hacked.py:416-488): for ``iters`` Adam steps the
decoder feature minimizes

  * a temporal loss — L1 between each frame and its flow-warped neighbour
    on non-occluded pixels (both directions); its gradient comes from
    autograd.  The warp is built once per call as dense warp matrices
    [F, hw, hw];
  * a spatial loss — L1 between the cosine gram of the feature and the
    reference gram C; its gradient is the closed form 2·sign(G − C)·v̂/N,
    through the sign-gram kernel when C is dense and in bf16, else the
    chunked plain path (``fresco_tpu`` guidance.py:385-412);

then AdaIN-renormalizes to the input's statistics.

Float64 features (``FrescoConfig(dtype="float64")``, the sharding-
validation mode) are optimized in float64 with float64 grams, as in
``fresco_tpu`` guidance.py:499-503; any other dtype in float32.
"""
from __future__ import annotations

import dataclasses
import torch

from benchmark.reference.fresco_ref.ops import gram_kernel
from benchmark.reference.fresco_ref.ops.adain import adain
from benchmark.reference.fresco_ref.ops.blend import prepare_flow_for_scale
from benchmark.reference.fresco_ref.ops.warp import coords_grid
from benchmark.reference.fresco_ref.precision import tf32_for_bf16_operands


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    iters: int = 20          # diffusion_hacked.py:417
    lr: float = 0.2          # diffusion_hacked.py:433
    intra_weight: float = 1e2
    optimize_temporal: bool = True
    chunk: int = 2
    # dtype of the gram and warp products ("float32" for strict parity)
    gram_dtype: str = "bfloat16"
    # a factored reference gram [B, hw, C] is materialized dense once per
    # call when it fits this budget (MB, in the gram dtype)
    dense_corr_max_mb: float = 600.0


def warp_taps(flow: torch.Tensor):
    """flow [F,h,w,2] -> (src int64 [F,hw,4] source pixels, wt [F,hw,4]
    bilinear weights in at least float32 (float64 flows keep float64), zero
    out of bounds)."""
    f, h, w, _ = flow.shape
    hw = h * w
    grid = coords_grid(h, w, flow.dtype, flow.device)[None] + flow
    x, y = grid[..., 0].reshape(f, hw), grid[..., 1].reshape(f, hw)
    x0, y0 = torch.floor(x), torch.floor(y)
    srcs, wts = [], []
    for yi, xi, wt in (
        (y0, x0, (x0 + 1 - x) * (y0 + 1 - y)),
        (y0, x0 + 1, (x - x0) * (y0 + 1 - y)),
        (y0 + 1, x0, (x0 + 1 - x) * (y - y0)),
        (y0 + 1, x0 + 1, (x - x0) * (y - y0)),
    ):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        srcs.append(torch.clamp(yi, 0, h - 1).to(torch.int64) * w
                    + torch.clamp(xi, 0, w - 1).to(torch.int64))
        wts.append((wt * inb.to(flow.dtype)).to(torch.promote_types(flow.dtype, torch.float32)))
    return torch.stack(srcs, -1), torch.stack(wts, -1)


def warp_matrix(flow: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Bilinear backward warp as a dense matrix W [F, hw, hw] with
    W[f, p, q] = weight of source pixel q for output pixel p, built in
    ``dtype``; ``W @ x`` equals ``flow_warp(x, flow)``."""
    src, wt = warp_taps(flow)
    f, hw, _ = src.shape
    wmat = torch.zeros((f, hw, hw), dtype=dtype, device=flow.device)
    return wmat.scatter_add_(2, src, wt.to(dtype))


def temporal_loss(cs, fwd_warp, bwd_warp, fwd_occ, bwd_occ, chunk: int):
    """Bidirectional warp-consistency L1 (diffusion_hacked.py:461-466).
    cs [chunk*F,h,w,C]; warps dense [F,hw,hw]; occs [F,h,w,1]."""
    b, h, w, c = cs.shape
    f = b // chunk
    c1 = cs.reshape(chunk, f, h * w, c)
    c2 = torch.roll(c1, -1, dims=1)

    def warp(x, wop):
        return torch.matmul(wop, x.to(wop.dtype)).to(cs.dtype)

    warped1 = warp(c1, bwd_warp).reshape(cs.shape)
    warped2 = warp(c2, fwd_warp).reshape(cs.shape)
    c1f, c2f = c1.reshape(cs.shape), c2.reshape(cs.shape)
    bo, fo = bwd_occ.repeat(chunk, 1, 1, 1), fwd_occ.repeat(chunk, 1, 1, 1)
    l = torch.abs((c2f - warped1) * (1.0 - bo)) + torch.abs((c1f - warped2) * (1.0 - fo))
    return l.mean() * 2.0


def _normalize_rows(cs: torch.Tensor) -> torch.Tensor:
    b, h, w, c = cs.shape
    v = cs.reshape(b, h * w, c)
    return v / torch.sqrt(torch.sum(v * v, dim=2, keepdim=True))


def _gram_l1_grad(v_hat, correlation, gram_dtype, chunk_rows: int, is_dense: bool):
    """∂/∂v̂ of mean|v̂v̂ᵀ − C| = 2·S·v̂ / N, S = sign(G − C) symmetric,
    N = B·hw².

    Dense C goes through the sign-gram wrapper (the CUDA kernels on the
    card, the chunked plain version on the CPU); factored C [B,hw,C] is
    rebuilt one row chunk at a time."""
    b, hw, c = v_hat.shape
    n = b * hw * hw
    vg = v_hat.to(gram_dtype)
    if is_dense:
        sv = gram_kernel.sign_gram_apply(vg.contiguous(), correlation.to(gram_dtype).contiguous())
        return 2.0 * sv / n
    work = torch.promote_types(gram_dtype, torch.float32)
    vf = vg.to(work)
    vr = correlation.to(gram_dtype).to(work)
    grad = torch.empty((b, hw, c), dtype=work, device=v_hat.device)
    with tf32_for_bf16_operands(gram_dtype == torch.bfloat16):  # exact for bf16-valued operands
        for row0 in range(0, hw, chunk_rows):
            rows = slice(row0, row0 + chunk_rows)
            g = torch.matmul(vf[:, rows], vf.transpose(1, 2))
            s = torch.sign(g - torch.matmul(vr[:, rows], vr.transpose(1, 2)))
            grad[:, rows] = 2.0 * torch.matmul(s, vf)
    return grad / n


def optimize_feature(sample, fwd_flow, bwd_flow, fwd_occ, bwd_occ, correlation,
                     cfg: GuidanceConfig = GuidanceConfig(), corr_is_dense: bool | None = None):
    """Inner Adam loop on one decoder feature map.

    sample [chunk*F,h,w,C] (any dtype; optimized in f32, f64 stays f64);
    flows [F,H,W,2] at video resolution; correlation dense [chunk*F,hw,hw],
    factored [chunk*F,hw,C] (``corr_is_dense=False``) or None.  Returns the optimized feature AdaIN-matched to
    ``sample``, in sample's dtype."""
    do_temporal = cfg.optimize_temporal and fwd_flow is not None
    do_spatial = correlation is not None and cfg.intra_weight > 0
    if not do_temporal and not do_spatial:
        return sample
    h, w = sample.shape[1:3]
    if sample.dtype == torch.float64:  # the sharding-validation mode (fresco_tpu guidance.py:499-503)
        work_dtype = gram_dtype = torch.float64
    else:
        work_dtype = torch.float32
        gram_dtype = torch.bfloat16 if cfg.gram_dtype == "bfloat16" else torch.float32

    with torch.no_grad():
        if do_temporal:
            bwd_flow_s, bwd_occ_s = prepare_flow_for_scale(bwd_flow, bwd_occ, (h, w), dilate_full_res=False)
            fwd_flow_s, fwd_occ_s = prepare_flow_for_scale(fwd_flow, fwd_occ, (h, w), dilate_full_res=False)
            fwd_warp, bwd_warp = warp_matrix(fwd_flow_s, gram_dtype), warp_matrix(bwd_flow_s, gram_dtype)
        if do_spatial and corr_is_dense is None:
            corr_is_dense = correlation.shape[1] == correlation.shape[2]
        if do_spatial and not corr_is_dense:
            b_c, hw_c = correlation.shape[:2]
            itemsize = torch.empty((), dtype=gram_dtype).element_size()
            if b_c * hw_c * hw_c * itemsize / 2**20 <= cfg.dense_corr_max_mb:
                vr = correlation.to(gram_dtype)
                correlation = torch.matmul(vr, vr.transpose(1, 2))
                corr_is_dense = True

    x0 = sample.to(work_dtype)
    cs = x0.clone()
    mu = torch.zeros_like(cs)
    nu = torch.zeros_like(cs)
    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam defaults (= torch Adam's)
    for it in range(1, cfg.iters + 1):
        with torch.enable_grad():
            x = cs.detach().requires_grad_(True)
            total = torch.zeros((), dtype=work_dtype, device=x.device)
            if do_temporal:
                total = total + temporal_loss(x, fwd_warp, bwd_warp, fwd_occ_s, bwd_occ_s, cfg.chunk)
            if do_spatial:
                v = _normalize_rows(x)
                gv = _gram_l1_grad(v.detach(), correlation, gram_dtype,
                                   min(1024, v.shape[1]), corr_is_dense)
                total = total + cfg.intra_weight * torch.sum(v * gv)
            (g,) = torch.autograd.grad(total, x)
        with torch.no_grad():
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            mu_hat = mu / (1 - b1**it)
            nu_hat = nu / (1 - b2**it)
            cs = cs - cfg.lr * mu_hat / (torch.sqrt(nu_hat) + eps)
    # style_eps=1.0: the reference's eps/chunk argument swap (ops/adain.py)
    return adain(cs, x0, style_eps=1.0).to(sample.dtype)
