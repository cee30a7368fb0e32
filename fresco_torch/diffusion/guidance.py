"""FRESCO feature optimization: inner Adam loop on UNet decoder features.

Counterpart of ``fresco_tpu/diffusion/guidance.py:optimize_feature``
(reference src/diffusion_hacked.py:416-488): for ``iters`` Adam steps the
decoder feature minimizes

  * a temporal loss — L1 between each frame and its flow-warped neighbour
    on non-occluded pixels (both directions); its gradient comes from
    autograd.  The warp is built once per call: dense warp matrices
    [F, hw, hw] (``warp_mode="dense"``, the default), or the 4-tap
    structure of ``make_sparse_warp`` (``"sparse"``), whose backward is a
    sorted segment sum with no scatter, so two runs give the same bits;
  * a spatial loss — L1 between the cosine gram of the feature and the
    reference gram C; its gradient is the closed form 2·sign(G − C)·v̂/N,
    through the sign-gram kernel when C is dense and in bf16, else the
    chunked plain path (``fresco_tpu`` guidance.py:385-412);

then AdaIN-renormalizes to the input's statistics.

Float64 features (``FrescoConfig(dtype="float64")``, the sharding-
validation mode) are optimized in float64 with float64 grams, as in
``fresco_tpu`` guidance.py:499-503; any other dtype in float32.

Over a mesh (frames over ``data``) ``sample`` and ``correlation`` hold this
rank's frames and the flows the whole batch's: the temporal loss gathers
each rank's first frame (``comm.gather_frames``), the one frame its
previous rank's last frame is compared with, and holds only this rank's
frames' terms, over the whole batch's count, so the gathered gradient is
the whole loss's; the gram gradient divides by the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from fresco_torch import kernels
from fresco_torch.core import comm
from fresco_torch.ops import gram_kernel
from fresco_torch.ops.adain import adain
from fresco_torch.ops.blend import prepare_flow_for_scale
from fresco_torch.ops.warp import coords_grid


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
    # the temporal loss's warp: "dense" [F, hw, hw] matrices in the gram
    # dtype, or "sparse" 4-tap gathers in float32 ("banded" is refused, as
    # in fresco_tpu guidance.py:515-528)
    warp_mode: str = "dense"


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


class SparseWarp(NamedTuple):
    """The bilinear warp as 4 taps per output pixel, and its transpose
    sorted by source pixel (``fresco_tpu`` guidance.py:199)."""
    src: torch.Tensor         # int64 [F, hw, 4] source pixel of each tap
    wt: torch.Tensor          # f32 [F, hw, 4] its weight
    out_sorted: torch.Tensor  # int64 [F, 4hw] the taps' output pixels, by source pixel
    wt_sorted: torch.Tensor   # f32 [F, 4hw] their weights, in that order
    offsets: torch.Tensor     # int64 [F*hw + 1] where each (frame, source pixel)'s run starts


def make_sparse_warp(flow: torch.Tensor) -> SparseWarp:
    """flow [F,h,w,2] -> the structure ``apply_sparse_warp`` needs: the
    taps, and the (output pixel, weight) pairs sorted (stably) by source
    pixel, with each source pixel's run delimited."""
    src, wt = warp_taps(flow)
    f, hw, t = src.shape
    key = src.reshape(f, hw * t)
    order = torch.argsort(key, dim=1, stable=True)
    frame = torch.arange(f, device=flow.device)[:, None] * hw
    runs = (torch.gather(key, 1, order) + frame).reshape(-1)
    offsets = torch.searchsorted(runs, torch.arange(f * hw + 1, device=flow.device))
    return SparseWarp(src, wt, order // t, torch.gather(wt.reshape(f, hw * t), 1, order), offsets)


class _ApplySparseWarp(torch.autograd.Function):
    """y[f, p] = Σ_t wt[f, p, t] · x[f, src[f, p, t]]; the backward is the
    gather over the sorted transpose and a segment sum over each source
    pixel's run, in a fixed order (no scatter-add)."""

    @staticmethod
    def forward(ctx, x, warp: SparseWarp):
        f, hw, d = x.shape
        rows = x.reshape(f * hw, d)
        idx = (torch.arange(f, device=x.device)[:, None, None] * hw + warp.src).reshape(f * hw, -1)
        wt = warp.wt.reshape(f * hw, -1).to(x.dtype)
        y = wt[:, :1] * rows.index_select(0, idx[:, 0])
        for k in range(1, idx.shape[1]):
            y = y + wt[:, k:k + 1] * rows.index_select(0, idx[:, k])
        ctx.warp = warp
        return y.reshape(f, hw, d)

    @staticmethod
    def backward(ctx, ct):
        warp = ctx.warp
        f, hw, d = ct.shape
        gidx = (torch.arange(f, device=ct.device)[:, None] * hw + warp.out_sorted).reshape(-1)
        rows = ct.reshape(f * hw, d).index_select(0, gidx) * warp.wt_sorted.reshape(-1, 1).to(ct.dtype)
        dx = torch.segment_reduce(rows, "sum", offsets=warp.offsets, axis=0)
        return dx.reshape(f, hw, d), None


def apply_sparse_warp(x: torch.Tensor, warp: SparseWarp) -> torch.Tensor:
    """``warp_matrix(flow) @ x`` for x [F, hw, d] in O(4·hw·d) work: four
    row gathers; a deterministic backward (``_ApplySparseWarp``)."""
    return _ApplySparseWarp.apply(x, warp)


def temporal_loss(cs, fwd_warp, bwd_warp, fwd_occ, bwd_occ, chunk: int, mesh=None):
    """Bidirectional warp-consistency L1 (diffusion_hacked.py:461-466).
    cs [chunk*F,h,w,C]; warps dense [F,hw,hw] or ``SparseWarp``; occs
    [F,h,w,1].  With a ``mesh``, cs holds this rank's frames and the warps
    and occlusions those same frames; the loss is this rank's share of the
    whole batch's."""
    b, h, w, c = cs.shape
    f = b // chunk
    c1 = cs.reshape(chunk, f, h * w, c)
    if mesh is None or mesh.data == 1:
        c2 = torch.roll(c1, -1, dims=1)
        n_total = cs.numel()
    else:  # frame i+1 of the whole batch: the next rank's first frame follows the last
        firsts = comm.gather_frames(c1[:, 0], mesh, chunk).reshape(chunk, mesh.data, h * w, c)
        c2 = torch.cat([c1[:, 1:], firsts[:, (mesh.data_rank + 1) % mesh.data, None]], dim=1)
        n_total = cs.numel() * mesh.data

    def warp(x, wop):
        if isinstance(wop, SparseWarp):  # fold (chunk, c) -> d
            xd = x.permute(1, 2, 0, 3).reshape(f, h * w, chunk * c)
            return apply_sparse_warp(xd, wop).reshape(f, h * w, chunk, c).permute(2, 0, 1, 3)
        return torch.matmul(wop, x.to(wop.dtype)).to(cs.dtype)

    warped1 = warp(c1, bwd_warp).reshape(cs.shape)
    warped2 = warp(c2, fwd_warp).reshape(cs.shape)
    c1f, c2f = c1.reshape(cs.shape), c2.reshape(cs.shape)
    bo, fo = bwd_occ.repeat(chunk, 1, 1, 1), fwd_occ.repeat(chunk, 1, 1, 1)
    l = torch.abs((c2f - warped1) * (1.0 - bo)) + torch.abs((c1f - warped2) * (1.0 - fo))
    return (l.mean() if n_total == l.numel() else l.sum() / n_total) * 2.0


def _normalize_rows(cs: torch.Tensor) -> torch.Tensor:
    b, h, w, c = cs.shape
    v = cs.reshape(b, h * w, c)
    return v / torch.sqrt(torch.sum(v * v, dim=2, keepdim=True))


def _gram_l1_grad(v_hat, correlation, gram_dtype, chunk_rows: int, is_dense: bool, n_batch: int | None = None):
    """∂/∂v̂ of mean|v̂v̂ᵀ − C| = 2·S·v̂ / N, S = sign(G − C) symmetric,
    N = n_batch·hw² (``n_batch``: the whole batch's, default v̂'s own).

    Dense C goes through the sign-gram wrapper (the CUDA kernels on the
    card, the chunked plain version on the CPU); factored C [B,hw,C] is
    rebuilt one row chunk at a time.  Either path is the profiler range
    ``fresco::gram`` and counts once in ``kernels.work_counts()["gram"]``
    by v̂'s (B, hw, c)."""
    b, hw, c = v_hat.shape
    kernels.count_work("gram", (b, hw, c))
    with record_function("fresco::gram"):
        n = (n_batch or b) * hw * hw
        vg = v_hat.to(gram_dtype)
        if is_dense:
            sv = gram_kernel.sign_gram_apply(vg.contiguous(), correlation.to(gram_dtype).contiguous())
            return 2.0 * sv / n
        work = torch.promote_types(gram_dtype, torch.float32)
        vf = vg.to(work)
        vr = correlation.to(gram_dtype).to(work)
        grad = torch.empty((b, hw, c), dtype=work, device=v_hat.device)
        for row0 in range(0, hw, chunk_rows):
            rows = slice(row0, row0 + chunk_rows)
            g = torch.matmul(vf[:, rows], vf.transpose(1, 2))
            s = torch.sign(g - torch.matmul(vr[:, rows], vr.transpose(1, 2)))
            grad[:, rows] = 2.0 * torch.matmul(s, vf)
        return grad / n


def optimize_feature(sample, fwd_flow, bwd_flow, fwd_occ, bwd_occ, correlation,
                     cfg: GuidanceConfig = GuidanceConfig(), corr_is_dense: bool | None = None,
                     mesh=None):
    """Inner Adam loop on one decoder feature map.

    sample [chunk*F,h,w,C] (any dtype; optimized in f32, f64 stays f64);
    flows [F,H,W,2] at video resolution; correlation dense [chunk*F,hw,hw],
    factored [chunk*F,hw,C] (``corr_is_dense=False``) or None.  With a
    ``mesh``, sample and correlation hold this rank's frames and the flows
    the whole batch's.  Returns the optimized feature AdaIN-matched to
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
    d = 1 if mesh is None else mesh.data
    n_batch = sample.shape[0] * d

    with torch.no_grad():
        if do_temporal:
            loc = slice(None) if d == 1 else mesh.frame_slice(sample.shape[0] // cfg.chunk * d)
            bwd_flow_s, bwd_occ_s = prepare_flow_for_scale(bwd_flow[loc], bwd_occ[loc], (h, w),
                                                           dilate_full_res=False)
            fwd_flow_s, fwd_occ_s = prepare_flow_for_scale(fwd_flow[loc], fwd_occ[loc], (h, w),
                                                           dilate_full_res=False)
            if cfg.warp_mode == "sparse":
                fwd_warp, bwd_warp = make_sparse_warp(fwd_flow_s), make_sparse_warp(bwd_flow_s)
            elif cfg.warp_mode == "dense":
                fwd_warp, bwd_warp = warp_matrix(fwd_flow_s, gram_dtype), warp_matrix(bwd_flow_s, gram_dtype)
            else:
                raise ValueError(f"warp_mode={cfg.warp_mode!r} is not supported inside optimize_feature: "
                                 "use 'dense' or 'sparse' (the JAX package refuses 'banded' too)")
        if do_spatial and corr_is_dense is None:
            corr_is_dense = correlation.shape[1] == correlation.shape[2]
        if do_spatial and not corr_is_dense:
            b_c, hw_c = correlation.shape[:2]
            itemsize = torch.empty((), dtype=gram_dtype).element_size()
            # the whole batch's size decides, so that every mesh takes the same path
            if b_c * d * hw_c * hw_c * itemsize / 2**20 <= cfg.dense_corr_max_mb:
                # the reference gram, built once a call: the gram's range times it too
                with record_function("fresco::gram"):
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
                total = total + temporal_loss(x, fwd_warp, bwd_warp, fwd_occ_s, bwd_occ_s, cfg.chunk, mesh)
            if do_spatial:
                v = _normalize_rows(x)
                gv = _gram_l1_grad(v.detach(), correlation, gram_dtype,
                                   min(1024, v.shape[1]), corr_is_dense, n_batch)
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
