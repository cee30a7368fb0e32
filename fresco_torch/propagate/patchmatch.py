"""Guided patch-based synthesis (ebsynth/StyLit equivalent) in PyTorch.

Counterpart of ``fresco_tpu/propagate/patchmatch.py``: coarse-to-fine
PatchMatch by jump-flooding.  Each PatchMatch iteration evaluates, for
every active pixel in parallel, a static candidate set — neighbour
matches at power-of-two offsets (shift-adjusted) and random-search
samples with exponentially decaying radii — and keeps the strict argmin;
the vote is a 25-offset gather-mean; the uniformity (omega) term is a
scatter-add usage histogram recomputed per search-vote iteration.

What differs from the JAX package, with the math held fixed:

- Candidate evaluation reads source patches straight from the image in
  one kernel per PatchMatch iteration (``patch_eval``); the vote's
  style-patch gather is a row-gather kernel (``gather_rows``).  On the CPU
  both run their plain versions, the JAX formulation.
- ``lax.while_loop`` / ``lax.cond`` become host control flow: each
  search-vote iteration reads the active-pixel count on the host.
- Randomness enters as input (``TorchDraws``, or any object with the same
  two methods): the coarsest level's initial NNF and, per PatchMatch
  iteration, the random deltas drawn on the full grid, so that the
  compacted and the full path see the same draws.
- ``backend="native"`` runs the JAX package's C++ serpentine backend from
  the port's own copy (``propagate/native``), built with g++ at first use.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from fresco_torch.ops.resize import resize_bilinear
from fresco_torch.propagate.gather import gather_rows
from fresco_torch.propagate.patch_eval import active_set, offsets as _offsets, patch_eval
from fresco_torch.propagate.patch_eval import target_patches as _target_patches


@dataclasses.dataclass(frozen=True)
class PatchMatchConfig:
    patch_size: int = 5           # ebsynth.cpp default
    uniformity: float = 3500.0    # ebsynth.cpp default
    pm_iters: int = 6             # video_blend.py:101 -patchmatchiters
    sv_iters: int = 12            # video_blend.py:101 -searchvoteiters
    style_weight: float = 1.0
    num_pyramid_levels: int = -1  # -1 => auto
    rand_candidates: int = 4
    extra_pass_3x3: bool = False
    # -stopthreshold (ebsynth.cpp:342, default 5): a pixel whose voted
    # style moved < this (max abs channel difference) since the previous
    # search-vote iteration is frozen (mask dilated by the patch); when
    # every pixel froze, the remaining search-vote iterations are skipped.
    # 0 disables.
    stop_threshold: float = 5.0
    # Candidate-set trim at upsample-seeded pyramid levels: 0/False = full
    # set at every level; 1/True = drop shift 8 and the widest random
    # scale; 2 = also drop shift 4 and one more random scale.
    trim_seeded_levels: bool | int = True
    # Only "bfloat16": the uint8 table of the JAX package is not ported.
    table_dtype: str = "bfloat16"
    # Freeze compaction.  The JAX package picks, per search-vote
    # iteration, the smallest of these tiers (N/2, N/4, N/16 positions)
    # that the active count fits.  The port needs no caps: any non-empty
    # value makes the candidate kernel run only the 4x4 tiles that hold
    # an active pixel (exact: frozen pixels keep their match either way,
    # and the random draws are on the full grid); () sweeps every tile.
    # The tier values themselves are not read.
    compact_tiers: tuple = (2, 4, 16)


# The command lines' backend spellings (the JAX package's ``tpu`` / ``cuda``
# and ``cpu`` / ``native``) -> ``synthesize``'s backend names.
BACKEND_NAMES = {"jumpflood": "jumpflood", "tpu": "jumpflood", "cuda": "jumpflood",
                 "native": "native", "cpu": "native"}


class TorchDraws:
    """The default random source: a ``torch.Generator`` seeded with
    ``seed``.  Draws are made on ``draw_device`` (default ``device``) and
    returned on ``device``; drawing on the CPU gives the same numbers on
    every device, at the cost of a copy.  ``level`` counts the pyramid
    levels from the coarsest (the 3x3 extra pass is the level after the
    finest)."""

    def __init__(self, seed: int = 0, device: torch.device | str = "cpu",
                 draw_device: torch.device | str | None = None):
        self.device = torch.device(device)
        self.draw_device = self.device if draw_device is None else torch.device(draw_device)
        self.gen = torch.Generator(device=self.draw_device).manual_seed(seed)

    def _randint(self, lo: int, hi: int, shape) -> torch.Tensor:
        return torch.randint(lo, hi, shape, generator=self.gen, device=self.draw_device,
                             dtype=torch.int32).to(self.device)

    def init_nnf(self, level: int, th: int, tw: int, sh: int, sw: int, r: int) -> torch.Tensor:
        """[th, tw, 2] int32, y in [r, sh-r), x in [r, sw-r)."""
        return torch.stack([self._randint(r, sh - r, (th, tw)), self._randint(r, sw - r, (th, tw))], -1)

    def deltas(self, level: int, it: int, it2: int, radii: list[int], th: int, tw: int) -> torch.Tensor:
        """[len(radii), th, tw, 2] int32, scale j uniform in [-radii[j], radii[j]]."""
        return torch.stack([self._randint(-rad, rad + 1, (th, tw, 2)) for rad in radii])


def _pyramid_sizes(h: int, w: int, t_h: int, t_w: int, patch: int, max_levels: int):
    """Coarse-to-fine level sizes; coarsest min-dim >= 2·patch+1."""
    sizes = []
    level = 0
    while True:
        f = 2 ** level
        sh, sw = max(h // f, 1), max(w // f, 1)
        th, tw = max(t_h // f, 1), max(t_w // f, 1)
        if min(sh, sw, th, tw) < 2 * patch + 1 and level > 0:
            break
        sizes.append(((sh, sw), (th, tw)))
        if min(sh, sw, th, tw) == 1:
            break
        level += 1
        if 0 < max_levels <= len(sizes):
            break
    return sizes[::-1]  # coarse -> fine


def _flat_patches(img: torch.Tensor, patch: int, dtype=torch.bfloat16) -> torch.Tensor:
    """[H,W,C] -> [H*W, n_off*C] pre-stacked neighbourhoods."""
    if dtype != torch.bfloat16:
        raise NotImplementedError("only the bfloat16 patch table is ported (ROADMAP: Not ported)")
    h, w, _ = img.shape
    return _target_patches(img, patch).reshape(h * w, -1).to(dtype)


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[clamp(y+dy), clamp(x+dx)] (edge-clamped shift)."""
    h, w = img.shape[:2]
    iy = (torch.arange(h, device=img.device) + dy).clamp(0, h - 1)
    ix = (torch.arange(w, device=img.device) + dx).clamp(0, w - 1)
    return img.index_select(0, iy).index_select(1, ix)


def _omega(nnf_y, nnf_x, sh, sw, patch):
    """Source usage histogram over patch footprints (scatter-add, then a
    separable zero-padded box filter; integer counts, so exact)."""
    idx = (nnf_y.clamp(0, sh - 1) * sw + nnf_x.clamp(0, sw - 1)).reshape(-1).long()
    counts = torch.zeros(sh * sw, dtype=torch.float32, device=nnf_y.device)
    counts.index_add_(0, idx, torch.ones(idx.shape[0], dtype=torch.float32, device=idx.device))
    pad = patch // 2
    c = F.pad(counts.reshape(sh, sw), (pad, pad, pad, pad))
    rows = sum(c[i: i + sh] for i in range(patch))
    return sum(rows[:, i: i + sw] for i in range(patch))


def level_candidates(sh: int, sw: int, seeded: int, rand_candidates: int = PatchMatchConfig.rand_candidates):
    """The candidate set of a pyramid level with an sh x sw source:
    (jump-flood shift distances, random-search radii).  ``seeded`` is 0 at
    an unseeded level (the coarsest), else the trim of upsample-seeded
    levels (``PatchMatchConfig.trim_seeded_levels``); the default config
    gives 20 candidates unseeded and 15 seeded."""
    shifts = {0: (1, 2, 4, 8), 1: (1, 2, 4)}.get(int(seeded), (1, 2))
    n_rand = max(rand_candidates - seeded, 1) if seeded else rand_candidates
    base = 2 if seeded else 1
    return shifts, [max(max(sh, sw) >> (j + base), 1) for j in range(n_rand)]


def _synthesize_level(
    src_all,        # [sh, sw, C] style+guides (source)
    tgt_guides,     # [th, tw, Cg] target guides
    style_src,      # [sh, sw, Cs]
    weights_g,      # [Cg]
    weights_s,      # [Cs]
    nnf,            # [th, tw, 2] int32 (y, x) init
    draws,          # TorchDraws-like random source
    level: int,
    *,
    patch: int,
    pm_iters: int,
    sv_iters: int,
    uniformity: float,
    rand_candidates: int,
    stop_threshold: float = 0.0,
    seeded: int = 0,
    compact: bool = False,
    debug_counts: bool = False,
):
    """One pyramid level (``fresco_tpu`` patchmatch.py:215-562).  Returns
    (nnf, out, err), with ``debug_counts`` also the per-iteration active
    counts (-1 = skipped by the early exit)."""
    sh, sw = src_all.shape[:2]
    th, tw = tgt_guides.shape[:2]
    cs = style_src.shape[-1]
    n_off = patch * patch

    src_bf = src_all.to(torch.bfloat16).contiguous()
    tgt_g = tgt_guides.to(torch.bfloat16)
    w_all = torch.cat([weights_s, weights_g]).float()
    omega_best = (th * tw) / (sh * sw) * (patch * patch)
    style_patches = _target_patches(style_src.float(), patch).reshape(sh * sw, n_off * cs).contiguous()

    def vote(nnf_):
        # out(p) = mean_i style[nnf(p+o_i) - o_i]: one row gather of the
        # style neighbourhoods + 25 static shifts (offsets are centro-
        # symmetric: mirror(-o_i) = n_off-1-i)
        flat = nnf_[..., 0].clamp(0, sh - 1) * sw + nnf_[..., 1].clamp(0, sw - 1)
        g = gather_rows(style_patches, flat.reshape(-1).to(torch.int32).contiguous())
        g = g.reshape(th, tw, n_off, cs)
        out = torch.zeros((th, tw, cs), dtype=torch.float32, device=g.device)
        for i, (dy, dx) in enumerate(_offsets(patch)):
            out = out + _shifted(g[:, :, n_off - 1 - i, :], dy, dx)
        return out / n_off

    def omega_term(nnf_):
        if uniformity <= 0:
            return None
        om = (uniformity / omega_best) * _omega(nnf_[..., 0], nnf_[..., 1], sh, sw, patch)
        return om.to(torch.bfloat16)

    def target(style_):
        return torch.cat([style_.to(torch.bfloat16), tgt_g], -1).contiguous()

    shifts, radii = level_candidates(sh, sw, seeded, rand_candidates)
    n_rand = len(radii)

    nnf = nnf.to(torch.int32).contiguous()
    counts = [-1] * sv_iters
    prev_style = None
    for it in range(sv_iters):
        tgt_style = vote(nnf)
        if stop_threshold > 0 and prev_style is not None:
            changed = ((tgt_style - prev_style).abs().amax(-1) >= stop_threshold).float()
            active = F.max_pool2d(changed[None, None], patch, 1, patch // 2)[0, 0] > 0
        else:
            active = torch.ones((th, tw), dtype=torch.bool, device=nnf.device)
        prev_style = tgt_style
        n_active = int(active.sum())
        counts[it] = n_active
        if n_active == 0:
            break  # every pixel froze: the remaining iterations are no-ops
        act = None if n_active == th * tw else active_set(active, compact)
        tgt_all = target(tgt_style)
        omega = omega_term(nnf)
        # the current match's error is fixed within a search-vote
        # iteration: evaluate it once and carry it through the pm loop
        nnf, be = patch_eval(src_bf, tgt_all, w_all, omega, nnf, None, (), None, act, patch)
        for it2 in range(pm_iters):
            deltas = draws.deltas(level, it, it2, radii, th, tw) if n_rand else None
            nnf, be = patch_eval(src_bf, tgt_all, w_all, omega, nnf, be, shifts, deltas, act, patch)

    out = vote(nnf)
    # final error at the converged NNF
    _, err = patch_eval(src_bf, target(out), w_all, omega_term(nnf), nnf, None, (), None, None, patch)
    if debug_counts:
        return nnf, out, err, counts
    return nnf, out, err


def synthesize(
    style: torch.Tensor,
    source_guides: torch.Tensor,
    target_guides: torch.Tensor,
    guide_channel_weights: torch.Tensor,
    cfg: PatchMatchConfig = PatchMatchConfig(),
    draws=None,
    backend: str = "jumpflood",
    debug_counts: bool = False,
):
    """Synthesize the target-frame style by guided patch matching, on the
    device of ``style``.

    style: [Hs,Ws,Cs] (the stylized keyframe, float 0..255);
    source_guides/target_guides: [H,W,Cg] aligned channel stacks;
    guide_channel_weights: [Cg] per-channel weights (already divided by the
    guide's channel count).  ``draws``: the random source (default
    ``TorchDraws(0)`` on style's device).  ``backend``: ``"jumpflood"``
    (the device path) or ``"native"`` (the C++ serpentine backend on the
    host, ``_synthesize_native``; it takes no draws).

    Returns (output [Ht,Wt,Cs], error [Ht,Wt], nnf [Ht,Wt,2]); with
    ``debug_counts`` a 4th element, the per-level active counts."""
    if backend == "native":
        return _synthesize_native(style, source_guides, target_guides, guide_channel_weights, cfg)
    if backend != "jumpflood":
        raise ValueError(f"synthesize: unknown backend {backend!r}")
    if cfg.table_dtype != "bfloat16":
        raise NotImplementedError(
            f"table_dtype={cfg.table_dtype!r} is not ported (ROADMAP: Not ported)")
    if draws is None:
        draws = TorchDraws(0, style.device)
    sh, sw = style.shape[:2]
    th, tw = target_guides.shape[:2]
    cs = style.shape[-1]
    weights_s = torch.full((cs,), cfg.style_weight / cs, dtype=torch.float32, device=style.device)
    weights_g = guide_channel_weights.float()
    compact = bool(cfg.compact_tiers)

    sizes = _pyramid_sizes(sh, sw, th, tw, cfg.patch_size, cfg.num_pyramid_levels)
    nnf = None
    all_counts = []
    for li, ((lsh, lsw), (lth, ltw)) in enumerate(sizes):
        s_style = resize_bilinear(style[None].float(), (lsh, lsw))[0]
        s_guides = resize_bilinear(source_guides[None].float(), (lsh, lsw))[0]
        t_guides = resize_bilinear(target_guides[None].float(), (lth, ltw))[0]
        src_all = torch.cat([s_style, s_guides], -1)
        if nnf is None:
            nnf = draws.init_nnf(li, lth, ltw, lsh, lsw, cfg.patch_size // 2)
        else:
            up = resize_bilinear(nnf.float()[None], (lth, ltw))[0]
            nnf = (up * 2.0).to(torch.int32)  # truncation toward zero, as astype
        nnf, out, err, *dbg = _synthesize_level(
            src_all, t_guides, s_style, weights_g, weights_s, nnf, draws, li,
            patch=cfg.patch_size, pm_iters=cfg.pm_iters, sv_iters=cfg.sv_iters,
            uniformity=cfg.uniformity, rand_candidates=cfg.rand_candidates,
            stop_threshold=cfg.stop_threshold,
            seeded=int(cfg.trim_seeded_levels) if li > 0 else 0,
            compact=compact, debug_counts=debug_counts,
        )
        all_counts.extend(dbg)
    if cfg.extra_pass_3x3:
        # finest level rerun with 3x3 patches and uniformity off, seeded
        # from the converged NNF (ebsynth_cpu.cpp:983-989)
        nnf, out, err = _synthesize_level(
            src_all, t_guides, s_style, weights_g, weights_s, nnf, draws, len(sizes),
            patch=3, pm_iters=cfg.pm_iters, sv_iters=cfg.sv_iters, uniformity=0.0,
            rand_candidates=cfg.rand_candidates, stop_threshold=cfg.stop_threshold,
            seeded=int(cfg.trim_seeded_levels), compact=compact,
        )
    if debug_counts:
        return out, err, nnf, all_counts
    return out, err, nnf


def _synthesize_native(style, source_guides, target_guides, guide_weights, cfg):
    """The coarse-to-fine loop over the C++ serpentine backend
    (``fresco_tpu/propagate/patchmatch.py:663-711``): numpy's
    ``default_rng(0)`` initial NNF, this module's ``resize_bilinear``
    between levels, seed ``li`` at level ``li``, then the 3x3 extra pass.
    Runs on the host; returns tensors on the style's device."""
    import numpy as np

    from fresco_torch.propagate.native import synthesize_level_native

    def host(x):
        return x.detach().to("cpu", torch.float32)

    def np_resize(x, hw):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
        return resize_bilinear(x[None], hw)[0].numpy()

    dev = style.device
    style, source_guides, target_guides = host(style), host(source_guides), host(target_guides)
    gw = host(guide_weights).numpy()
    sh, sw, cs = style.shape
    th, tw = target_guides.shape[:2]
    sizes = _pyramid_sizes(sh, sw, th, tw, cfg.patch_size, cfg.num_pyramid_levels)
    sw_arr = np.full((cs,), cfg.style_weight / cs, np.float32)
    rng = np.random.default_rng(0)
    r = cfg.patch_size // 2
    nnf = None
    for li, ((lsh, lsw), (lth, ltw)) in enumerate(sizes):
        s_style = np_resize(style, (lsh, lsw))
        s_guides = np_resize(source_guides, (lsh, lsw))
        t_guides = np_resize(target_guides, (lth, ltw))
        if nnf is None:
            nnf = np.stack([rng.integers(r, lsh - r, (lth, ltw)),
                            rng.integers(r, lsw - r, (lth, ltw))], axis=-1).astype(np.int32)
        else:
            up = np_resize(nnf.astype(np.float32), (lth, ltw))
            nnf = np.clip((up * 2.0).astype(np.int32), [r, r], [lsh - 1 - r, lsw - 1 - r]).astype(np.int32)
        out, err, nnf = synthesize_level_native(
            s_style, s_guides, t_guides, sw_arr, gw, np.ascontiguousarray(nnf),
            patch=cfg.patch_size, pm_iters=cfg.pm_iters, sv_iters=cfg.sv_iters,
            uniformity=cfg.uniformity, seed=li)
    if cfg.extra_pass_3x3:  # ebsynth_cpu.cpp:983-989
        out, err, nnf = synthesize_level_native(
            s_style, s_guides, t_guides, sw_arr, gw, np.ascontiguousarray(nnf),
            patch=3, pm_iters=cfg.pm_iters, sv_iters=cfg.sv_iters, uniformity=0.0, seed=len(sizes))
    return tuple(torch.from_numpy(a).to(dev) for a in (out, err, nnf))
