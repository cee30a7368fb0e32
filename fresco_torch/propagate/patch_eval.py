"""Fused PatchMatch candidate evaluation: CUDA kernel wrapper and plain version.

One call runs one PatchMatch iteration of
``fresco_tpu/propagate/patchmatch.py`` (``eval_cand`` + ``consider``,
:287-307 and :367-374, over the candidate set of ``pm_iter``, :401-425):
for every active target pixel, starting from its current match and error,
the jump-flood shift candidates read from the full-grid NNF, then the
random-search deltas relative to the best so far, each kept only if
strictly better.  With no shifts and no deltas and ``e=None`` it is the
one-candidate set that gives the current match's error (``be0``, :397-399,
and the final error, :553-559).

For CUDA tensors ``patch_eval`` launches ``fresco_torch/csrc/patch_eval.cu``
(which reads source patches straight from the image, replacing the probe
``scripts/bench_fused_eval.py:_strip_kernel``); for CPU tensors it runs
``patch_eval_plain``, the JAX formulation: the pre-stacked patch table
(``build_table``, :258-285), one ``index_select`` per candidate and the
same ``consider`` loop.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from fresco_torch import kernels

TILE = 4  # the kernel's target tile edge (csrc/patch_eval.cu kTile)


def offsets(patch: int):
    r = patch // 2
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


def target_patches(img: torch.Tensor, patch: int) -> torch.Tensor:
    """[H,W,C] -> [H,W,n_off,C] edge-clamped neighbourhoods."""
    h, w, _ = img.shape
    pad = patch
    p = F.pad(img.permute(2, 0, 1)[None].float(), (pad, pad, pad, pad), mode="replicate")
    p = p[0].permute(1, 2, 0).to(img.dtype)
    return torch.stack([p[pad + dy: pad + dy + h, pad + dx: pad + dx + w] for dy, dx in offsets(patch)], 2)


@dataclasses.dataclass
class ActiveSet:
    """Pixels a call evaluates: a [th, tw] bool mask, and the int32 flat
    indices of the TILE x TILE tiles that hold an active pixel (the kernel's
    grid), or None to sweep every tile and idle the inactive pixels (the
    plain version then evaluates every pixel and keeps the active ones).
    Built once per search-vote iteration by ``active_set``."""

    mask: torch.Tensor
    tiles: torch.Tensor | None


def active_set(mask: torch.Tensor, compact: bool = True) -> ActiveSet:
    """``compact``: list the tiles that hold an active pixel (the kernel
    skips the rest; the plain version evaluates only the active pixels)."""
    if not compact:
        return ActiveSet(mask.contiguous(), None)
    th, tw = mask.shape
    ny, nx = -(-th // TILE), -(-tw // TILE)
    m = F.pad(mask, (0, nx * TILE - tw, 0, ny * TILE - th))
    tiles = m.reshape(ny, TILE, nx, TILE).any(dim=3).any(dim=1).reshape(-1)
    return ActiveSet(mask.contiguous(), torch.nonzero(tiles).reshape(-1).to(torch.int32))


def patch_eval_plain(src, tgt, weights, omega, nnf, e=None, shifts=(), deltas=None, active=None, patch=5):
    """The JAX formulation on any device; arguments as ``patch_eval``."""
    sh, sw, c = src.shape
    th, tw = tgt.shape[:2]
    r = patch // 2
    table = target_patches(src, patch).reshape(sh * sw, -1)
    w_all = weights.float().repeat(patch * patch)
    om = None if omega is None else omega.reshape(-1).float()
    nnf_flat = nnf.reshape(-1, 2)
    if active is None or active.tiles is None:
        idx = torch.arange(th * tw, device=src.device)
    else:
        idx = torch.nonzero(active.mask.reshape(-1)).reshape(-1)
    tgt_p = target_patches(tgt, patch).reshape(th * tw, -1)[idx]
    ys, xs = idx // tw, idx % tw

    def ev(cy, cx):
        cy = cy.clamp(r, sh - 1 - r)
        cx = cx.clamp(r, sw - 1 - r)
        s = torch.index_select(table, 0, cy * sw + cx)
        d = s.float() - tgt_p.float()  # float32, as XLA computes the JAX bf16 difference
        err = (d * d) @ w_all
        if om is not None:
            err = err + om[cy * sw + cx]
        return cy, cx, err

    def consider(by, bx, be, cy, cx):
        ny, nx, ce = ev(cy, cx)
        better = ce < be
        return torch.where(better, ny, by), torch.where(better, nx, bx), torch.where(better, ce, be)

    cur = nnf_flat[idx].long()
    if e is None:
        by, bx, be = ev(cur[:, 0], cur[:, 1])
    else:
        by, bx, be = cur[:, 0], cur[:, 1], e.reshape(-1)[idx]
    for d in shifts:
        for dy, dx in ((d, 0), (-d, 0), (0, d), (0, -d)):
            q = (ys + dy).clamp(0, th - 1) * tw + (xs + dx).clamp(0, tw - 1)
            n = nnf_flat[q].long()
            by, bx, be = consider(by, bx, be, n[:, 0] - dy, n[:, 1] - dx)
    if deltas is not None:
        dl = deltas.reshape(deltas.shape[0], th * tw, 2)[:, idx].long()
        for j in range(dl.shape[0]):
            by, bx, be = consider(by, bx, be, by + dl[j, :, 0], bx + dl[j, :, 1])
    if active is not None and active.tiles is None:  # full sweep: keep the active pixels
        keep = active.mask.reshape(-1)
        idx, by, bx, be = idx[keep], by[keep], bx[keep], be[keep]
    nnf_out = nnf.clone().reshape(-1, 2)
    nnf_out[idx] = torch.stack([by, bx], 1).to(nnf.dtype)
    e_out = (torch.full((th * tw,), float("inf"), device=src.device) if e is None
             else e.reshape(-1).clone())
    e_out[idx] = be
    return nnf_out.reshape(th, tw, 2), e_out.reshape(th, tw)


def near_tie_matches(src, tgt, weights, omega, nnf, e, shifts, deltas, y: int, x: int,
                     patch: int = 5, rel: float = 1e-5) -> set:
    """The matches pixel (y, x) can end one ``patch_eval`` call on when
    every comparison within ``rel`` of a tie may go either way (errors in
    float64).  Two evaluations that sum in other orders may split at such a
    tie, and the random-search candidates after a split (relative to the
    best so far) then differ, so a kernel's match is right when it lies in
    this set.  Arguments as ``patch_eval``; a handful of pixels only."""
    sh, sw, _ = src.shape
    th, tw = tgt.shape[:2]
    r = patch // 2
    w64 = weights.double().cpu()
    ty = [min(max(y + d, 0), th - 1) for d in range(-r, r + 1)]
    tx = [min(max(x + d, 0), tw - 1) for d in range(-r, r + 1)]
    t_patch = tgt.double().cpu()[ty][:, tx]

    def ev(cy: int, cx: int):
        cy, cx = min(max(cy, r), sh - 1 - r), min(max(cx, r), sw - 1 - r)
        d = src[cy - r: cy + r + 1, cx - r: cx + r + 1].double().cpu() - t_patch
        err = float((d * d * w64).sum()) + (0.0 if omega is None else float(omega[cy, cx]))
        return cy, cx, err

    nnf_h = nnf.cpu()
    cur = [int(v) for v in nnf_h[y, x]]
    states = {ev(*cur)} if e is None else {(cur[0], cur[1], float(e[y, x]))}

    def step(cand):
        nonlocal states
        nxt = set()
        for by, bx, be in states:
            c = ev(*cand(by, bx))
            if abs(c[2] - be) <= rel * abs(be):
                nxt |= {(by, bx, be), c}
            else:
                nxt.add(c if c[2] < be else (by, bx, be))
        states = nxt

    for d in shifts:
        for dy, dx in ((d, 0), (-d, 0), (0, d), (0, -d)):
            n = nnf_h[min(max(y + dy, 0), th - 1), min(max(x + dx, 0), tw - 1)]
            step(lambda by, bx, n=n, dy=dy, dx=dx: (int(n[0]) - dy, int(n[1]) - dx))
    if deltas is not None:
        for dl in deltas[:, y, x].cpu().tolist():
            step(lambda by, bx, dl=dl: (by + dl[0], bx + dl[1]))
    return {(by, bx) for by, bx, _ in states}


def _pad_channels(x: torch.Tensor, cp: int) -> torch.Tensor:
    c = x.shape[-1]
    return x.contiguous() if c == cp else F.pad(x, (0, cp - c)).contiguous()


def _kernel_args(src, tgt, weights, omega, nnf, e, shifts, deltas, active, patch):
    """Check a CUDA call's arguments and lay them out for the C entry point
    ``fresco_patch_eval``: (the card; its arguments but the stream, or
    None when no tile is listed; nnf_out; e_out; the candidate count; the
    tensors the arguments point into, which must outlive the launch)."""
    dev = kernels.launch_card("patch_eval", src=src, tgt=tgt, weights=weights, omega=omega, nnf=nnf, e=e,
                              deltas=deltas, mask=None if active is None else active.mask,
                              tiles=None if active is None else active.tiles)
    sh, sw, c = src.shape
    th, tw = tgt.shape[:2]
    if src.dtype != torch.bfloat16 or tgt.dtype != torch.bfloat16 or tgt.shape[2] != c:
        raise TypeError(f"patch_eval: src/tgt must be bf16 with equal channels, got {src.dtype} "
                        f"{tuple(src.shape)}, {tgt.dtype} {tuple(tgt.shape)}")
    if c > 32:
        raise ValueError(f"patch_eval: at most 32 channels, got {c}")
    if len(shifts) > 8:
        raise ValueError("patch_eval: at most 8 shift distances")
    cp = 16 if c <= 16 else 32
    if nnf.dtype != torch.int32 or nnf.shape != (th, tw, 2):
        raise TypeError(f"patch_eval: nnf must be int32 [{th}, {tw}, 2]")
    if deltas is not None and (deltas.dtype != torch.int32 or deltas.shape[1:] != (th, tw, 2)):
        raise TypeError(f"patch_eval: deltas must be int32 [n, {th}, {tw}, 2]")
    if omega is not None and (omega.dtype != torch.bfloat16 or omega.shape != (sh, sw)):
        raise TypeError(f"patch_eval: omega must be bf16 [{sh}, {sw}]")
    if e is not None and (e.dtype != torch.float32 or e.shape != (th, tw)):
        raise TypeError(f"patch_eval: e must be float32 [{th}, {tw}]")
    if min(sh, sw) < patch:
        raise ValueError(f"patch_eval: source {sh}x{sw} smaller than the patch")
    src_p, tgt_p = _pad_channels(src, cp), _pad_channels(tgt, cp)
    w_p = _pad_channels(weights.float(), cp)
    nnf_in = nnf.contiguous()
    e_in = None if e is None else e.contiguous()
    omega_c = None if omega is None else omega.contiguous()
    deltas_c = None if deltas is None else deltas.contiguous()
    if active is None:  # the kernel writes every pixel
        nnf_out, e_out = torch.empty_like(nnf_in), torch.empty((th, tw), device=dev)
    else:  # pixels outside the active set keep their inputs
        nnf_out = nnf_in.clone()
        e_out = torch.full((th, tw), float("inf"), device=dev) if e_in is None else e_in.clone()
    n_cand = 4 * len(shifts) + (0 if deltas_c is None else deltas_c.shape[0])
    tiles = None if active is None else active.tiles
    if tiles is not None and tiles.numel() == 0:
        return dev, None, nnf_out, e_out, n_cand or 1, ()
    shift_vals = (ctypes.c_int * max(len(shifts), 1))(*shifts)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    keep = (src_p, tgt_p, w_p, omega_c, nnf_in, e_in, deltas_c, shift_vals)
    c_args = (src_p.data_ptr(), tgt_p.data_ptr(), w_p.data_ptr(), ptr(omega_c), nnf_in.data_ptr(), ptr(e_in),
              nnf_out.data_ptr(), e_out.data_ptr(), ptr(deltas_c),
              ptr(tiles), None if active is None else active.mask.data_ptr(),
              sh, sw, th, tw, cp, patch, len(shifts), shift_vals,
              0 if deltas_c is None else deltas_c.shape[0],
              0 if tiles is None else tiles.shape[0])
    return dev, c_args, nnf_out, e_out, n_cand or 1, keep


def patch_eval(src, tgt, weights, omega, nnf, e=None, shifts=(), deltas=None, active=None, patch=5):
    """One PatchMatch iteration of candidate evaluation.

    src [sh,sw,C] and tgt [th,tw,C] bf16 (source style+guides; voted
    target style + guides, same channel order); weights [C] float32;
    omega [sh,sw] bf16, the scaled uniformity term, or None; nnf
    [th,tw,2] int32 (y, x), the current matches that the shifts read;
    e [th,tw] float32, their errors, or None to evaluate the current
    match first; shifts, a tuple of jump-flood distances; deltas
    [n_rand,th,tw,2] int32 or None; active, an ``ActiveSet`` or None
    (every pixel).  Returns (nnf', e'); pixels outside ``active`` keep
    their inputs (e' = inf there when e is None).  Each launch counts in
    ``patch_eval.launches`` and, by (th, tw, candidates), in
    ``patch_eval.launches_by_shape``; candidates = 4·len(shifts) +
    n_rand, or 1 for the one-candidate set."""
    if patch not in (3, 5):
        raise ValueError(f"patch_eval: patch {patch} (3 or 5)")
    if src.device.type == "cpu":
        return patch_eval_plain(src, tgt, weights, omega, nnf, e, shifts, deltas, active, patch)
    card, c_args, nnf_out, e_out, n_cand, _keep = _kernel_args(src, tgt, weights, omega, nnf, e, shifts, deltas,
                                                               active, patch)
    if c_args is not None:
        kernels.call(patch_eval, "patch_eval", card, *c_args, shape=(tgt.shape[0], tgt.shape[1], n_cand))
    return nnf_out, e_out


patch_eval.launches = 0
patch_eval.launches_by_shape = {}
patch_eval.launches_by_card = {}
